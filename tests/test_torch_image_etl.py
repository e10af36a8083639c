"""The port's image pipeline and parallel ETL against the JAX package's.

``NativeImageLoader`` (``asMatrix``, ``asBytes``), the label generator, the
image transforms, ``ImageRecordReader`` and ``ParallelImageDataSetIterator``
are numpy, PIL and the native library on the host in both packages, so
every comparison is bit for bit: the same PNG tree (written from a numpy
seed) and the same ``(seed, epoch)`` give equal arrays, whichever
transport the port's iterator takes (serial, queue, shared memory) and
whichever package. Each iterator in a test runs 2 workers with a short
``stallTimeout`` and is closed by the ``closing`` fixture; one test holds
that no shared-memory segment of the port is left in /dev/shm.
"""

import glob
import os

import numpy as np
import pytest

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu_torch.datasets as pds
from deeplearning4j_tpu.datasets import image as jimage
from deeplearning4j_tpu_torch.datasets import image as pimage
from deeplearning4j_tpu_torch.datasets.parallel_etl import SHM_PREFIX

PKGS = {"jax": jds, "torch": pds}
IMAGE = {"jax": jimage, "torch": pimage}
STALL = 30.0


def _write_tree(root, classes=3, per_class=6, size=(8, 8), mode="RGB",
                seed=0):
    """PNG files root/c<k>/<i>.png of random pixels, ``size`` = (w, h)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    shape = (size[1], size[0]) + ((3,) if mode == "RGB" else ())
    for k in range(classes):
        d = root / f"c{k}"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 256, shape, np.uint8),
                            mode).save(d / f"{i}.png")


@pytest.fixture
def closing():
    """Registers iterators and pools; closes each after the test."""
    made = []

    def keep(obj):
        made.append(obj)
        return obj

    yield keep
    for obj in reversed(made):
        (obj.shutdown if hasattr(obj, "shutdown") else obj.close)()


def _collect(it):
    out = []
    while it.hasNext():
        ds = it.next()
        out.append((np.asarray(ds.getFeatures()),
                    np.asarray(ds.getLabels())))
    return out


def _same(got, want):
    assert len(got) == len(want) > 0
    for (gf, gl), (wf, wl) in zip(got, want):
        assert gf.dtype == wf.dtype and gf.shape == wf.shape
        assert gf.tobytes() == wf.tobytes()
        assert gl.tobytes() == wl.tobytes()


def _pit(pkg, root, closing, **kw):
    kw.setdefault("batchSize", 4)
    kw.setdefault("numWorkers", 2)
    kw.setdefault("stallTimeout", STALL)
    return closing(pkg.ParallelImageDataSetIterator(
        pkg.FileSplit(str(root)), 8, 8, 3, **kw))


# -- the loader ----------------------------------------------------------------

@pytest.mark.parametrize("size,mode,channels", [
    ((8, 8), "RGB", 3), ((12, 10), "RGB", 3), ((8, 8), "L", 1),
    ((8, 8), "L", 3), ((9, 7), "RGB", 1)])
def test_loader_equal_across_packages(tmp_path, size, mode, channels):
    _write_tree(tmp_path, classes=1, per_class=2, size=size, mode=mode)
    files = pds.FileSplit(str(tmp_path)).locations()
    for path in files:
        got, want = (IMAGE[k].NativeImageLoader(8, 8, channels)
                     for k in ("torch", "jax"))
        a, b = got.asMatrix(path), want.asMatrix(path)
        assert a.dtype == np.float32 and a.shape == (channels, 8, 8)
        assert a.tobytes() == b.tobytes()
        ua, ub = got.asBytes(path), want.asBytes(path)
        if ub is None:
            assert ua is None
        else:
            assert ua.dtype == np.uint8 and ua.tobytes() == ub.tobytes()
            assert ua.astype(np.float32).tobytes() == a.tobytes()


def test_loader_takes_arrays_and_refuses_floats():
    img = np.random.default_rng(1).integers(0, 256, (12, 12, 3), np.uint8)
    for k in ("torch", "jax"):
        assert IMAGE[k].NativeImageLoader(6, 6, 1).asMatrix(img).shape == \
            (1, 6, 6)
    a = pimage.NativeImageLoader(6, 6, 3).asMatrix(img[:, :, 0])
    b = jimage.NativeImageLoader(6, 6, 3).asMatrix(img[:, :, 0])
    assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="uint8"):
        pimage.NativeImageLoader(6, 6, 3).asMatrix(img.astype(np.float32))


def test_parent_path_label_generator_equal(tmp_path):
    _write_tree(tmp_path, classes=2, per_class=1)
    for path in pds.FileSplit(str(tmp_path)).locations():
        assert pimage.ParentPathLabelGenerator().getLabelForPath(path) == \
            jimage.ParentPathLabelGenerator().getLabelForPath(path)


# -- transforms ----------------------------------------------------------------

def _transforms(mod):
    return {
        "flip_v": mod.FlipImageTransform(0),
        "flip_h": mod.FlipImageTransform(1),
        "flip_both": mod.FlipImageTransform(-1),
        "flip_random": mod.FlipImageTransform(None),
        "crop": mod.CropImageTransform(2),
        "crop_sides": mod.CropImageTransform(1, 2, 0, 3),
        "resize": mod.ResizeImageTransform(5, 11),
        "scale": mod.ScaleImageTransform(0.3),
        "pipeline": mod.PipelineImageTransform(
            [(mod.FlipImageTransform(None), 0.5),
             (mod.CropImageTransform(1), 0.7),
             mod.ScaleImageTransform(0.2)], seed=3),
    }


@pytest.mark.parametrize("name", list(_transforms(pimage)))
def test_transforms_equal_across_packages(name):
    arr = np.random.default_rng(2).uniform(0, 255, (3, 12, 10)).astype(
        np.float32)
    got = _transforms(pimage)[name]
    want = _transforms(jimage)[name]
    for seed in range(4):
        a = got.transform(arr, np.random.default_rng(seed))
        b = want.transform(arr, np.random.default_rng(seed))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# -- the record reader --------------------------------------------------------

@pytest.mark.parametrize("with_transform", [False, True])
def test_image_record_reader_equal_across_packages(tmp_path, with_transform):
    _write_tree(tmp_path, classes=3, per_class=4, size=(10, 9))
    out = {}
    for k, pkg in PKGS.items():
        tf = IMAGE[k].FlipImageTransform(None) if with_transform else None
        rr = pkg.ImageRecordReader(8, 8, 3, pkg.ParentPathLabelGenerator(),
                                   imageTransform=tf, seed=7)
        rr.initialize(pkg.FileSplit(str(tmp_path)))
        assert rr.getLabels() == ["c0", "c1", "c2"]
        out[k] = _collect(pkg.RecordReaderDataSetIterator(
            rr, batchSize=5, labelIndex=1, numPossibleLabels=3))
    _same(out["torch"], out["jax"])


# -- the parallel iterator -----------------------------------------------------

@pytest.mark.parametrize("transport", ["serial", "queue", "shm"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_parallel_batches_equal_the_reference(tmp_path, closing, transport,
                                              shuffle):
    """The port's iterator on each transport against the JAX package's
    serial path (its own tests hold its transports equal), two epochs."""
    _write_tree(tmp_path, classes=3, per_class=6)
    got = _pit(pds, tmp_path, closing, transport=transport, shuffle=shuffle,
               seed=5)
    want = _pit(jds, tmp_path, closing, transport="serial", shuffle=shuffle,
                seed=5)
    for _ in range(2):
        _same(_collect(got), _collect(want))
        got.reset()
        want.reset()


@pytest.mark.parametrize("transport", ["serial", "queue", "shm"])
def test_parallel_augmented_batches_equal_the_reference(tmp_path, closing,
                                                        transport):
    """The float path: each batch's augmentation drawn from
    ``default_rng((seed, epoch, seq))`` in both packages."""
    _write_tree(tmp_path, classes=2, per_class=8)
    out = {}
    for k, pkg in PKGS.items():
        tf = IMAGE[k].PipelineImageTransform(
            [(IMAGE[k].FlipImageTransform(None), 0.7)])
        out[k] = _collect(_pit(pkg, tmp_path, closing, imageTransform=tf,
                               shuffle=True, seed=9,
                               transport=transport if k == "torch"
                               else "serial"))
    _same(out["torch"], out["jax"])


@pytest.mark.parametrize("transport", ["serial", "shm"])
def test_uint8_output_equal_the_reference_and_the_float_path(
        tmp_path, closing, transport):
    _write_tree(tmp_path, classes=2, per_class=6)
    u8 = _collect(_pit(pds, tmp_path, closing, floatOutput=False,
                       transport=transport, shuffle=True))
    want = _collect(_pit(jds, tmp_path, closing, floatOutput=False,
                         transport="serial", shuffle=True))
    f32 = _collect(_pit(pds, tmp_path, closing, transport=transport,
                        shuffle=True))
    _same(u8, want)
    assert u8[0][0].dtype == np.uint8
    for (a, la), (b, lb) in zip(u8, f32):
        assert a.astype(np.float32).tobytes() == b.tobytes()
        assert la.tobytes() == lb.tobytes()


def test_epochs_tail_and_resume_equal_the_reference(tmp_path, closing):
    _write_tree(tmp_path, classes=2, per_class=10)
    out = {}
    for k, pkg in PKGS.items():
        it = _pit(pkg, tmp_path, closing, shuffle=True,
                  transport="shm" if k == "torch" else "serial")
        e0 = _collect(it)
        it.reset()
        e1 = _collect(it)
        res = _pit(pkg, tmp_path, closing, shuffle=True, startEpoch=1,
                   transport="shm" if k == "torch" else "serial")
        r1 = _collect(res)
        res.set_epoch(0)
        tail = [(np.asarray(d.getFeatures()), np.asarray(d.getLabels()))
                for d in res[2:]]
        assert len(res) == 5 and len(tail) == 3
        _same(r1, e1)
        _same(tail, e0[2:])
        out[k] = e0 + e1
    _same(out["torch"], out["jax"])


def test_labels_and_ragged_tail_equal(tmp_path, closing):
    _write_tree(tmp_path, classes=3, per_class=5)   # 15 images, batch 4
    got = _pit(pds, tmp_path, closing, transport="shm")
    want = _pit(jds, tmp_path, closing, transport="serial")
    assert got.getLabels() == want.getLabels() == ["c0", "c1", "c2"]
    assert got.totalOutcomes() == 3 and len(got) == len(want) == 4
    batches = _collect(got)
    _same(batches, _collect(want))
    assert [b[0].shape[0] for b in batches] == [4, 4, 4, 3]


def test_shared_pool_serves_two_iterators(tmp_path, closing):
    _write_tree(tmp_path, classes=2, per_class=6)
    pool = closing(pds.EtlWorkerPool(2))
    a = _pit(pds, tmp_path, closing, pool=pool, transport="queue")
    b = _pit(pds, tmp_path, closing, pool=pool, transport="shm",
             shuffle=True)
    want_a = _collect(_pit(jds, tmp_path, closing, transport="serial"))
    want_b = _collect(_pit(jds, tmp_path, closing, transport="serial",
                           shuffle=True))
    _same(_collect(a), want_a)
    _same(_collect(b), want_b)
    procs = list(pool._procs)
    assert len(procs) == 2 and all(p.is_alive() for p in procs)
    a.close()
    b.close()
    assert all(p.is_alive() for p in procs)   # the pool outlives them
    pool.shutdown()
    assert not any(p.is_alive() for p in procs)


class _Boom:
    """A transform that fails in the worker (module level, so a worker
    can unpickle it)."""

    def transform(self, arr, rng=None):
        raise ValueError("injected decode failure")


@pytest.mark.parametrize("transport", ["serial", "queue"])
def test_worker_error_is_surfaced(tmp_path, closing, transport):
    _write_tree(tmp_path, classes=2, per_class=3)
    it = _pit(pds, tmp_path, closing, imageTransform=_Boom(),
              transport=transport)
    with pytest.raises((RuntimeError, ValueError),
                       match="injected decode failure"):
        it.next()


def test_no_shared_memory_segment_is_left_behind(tmp_path, closing):
    """While an epoch runs on the shm transport the ring's segment is in
    /dev/shm under the port's name; once the iterator is closed, none of
    this process's is."""
    _write_tree(tmp_path, classes=2, per_class=8)
    mine = f"/dev/shm/{SHM_PREFIX}{os.getpid()}_*"
    it = _pit(pds, tmp_path, closing, transport="shm", shuffle=True)
    it.next()
    assert len(glob.glob(mine)) == 1
    it.reset()
    it.next()
    it.close()
    other = _pit(pds, tmp_path, closing, transport="shm")
    _collect(other)
    other.close()
    assert glob.glob(mine) == []
