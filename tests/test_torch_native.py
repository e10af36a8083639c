"""The port's native ETL library (``deeplearning4j_tpu_torch/native``)
against the JAX package's and against the numpy twins.

Both packages compile the same ``etl.cpp`` with the same g++ flags, so
each entry is held bit for bit against the JAX package's native entry on
the same inputs (made from a numpy seed). Against the numpy twins:
``sg_pairs``, ``csv_parse`` and ``hwc_to_chw`` bit for bit (no float
arithmetic differs); the fused bilinear resize within 1e-3 on 0-255
values, the JAX package's own bound for its twin (the twin computes the
sample positions in float64, the C loop in float32). The library is
built into ``deeplearning4j_tpu_torch/_build/`` under a name keyed by the
source's hash, never beside a source, and ``load()`` raises with the
build's error where the build fails.
"""

import io
from pathlib import Path

import numpy as np
import pytest

import deeplearning4j_tpu_torch
from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.datasets.image import (
    _bilinear_resize_chw as jax_twin)
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets.image import (
    NativeImageLoader, _bilinear_resize_chw)

PKG = Path(deeplearning4j_tpu_torch.__file__).resolve().parent
RESIZE_ATOL = 1e-3


def _sg_loop(encoded, bs):
    """The skip-gram pairs by the Python loop (the numpy twin)."""
    centers, contexts, off = [], [], 0
    for idxs in encoded:
        n = len(idxs)
        for pos in range(n):
            b = bs[off + pos]
            for j in range(max(0, pos - b), min(n, pos + b + 1)):
                if j != pos:
                    centers.append(idxs[pos])
                    contexts.append(idxs[j])
        off += n
    return np.asarray(centers, np.int32), np.asarray(contexts, np.int32)


def test_builds_into_the_build_directory_keyed_by_the_source():
    assert native.available()
    path = native.library_path()
    assert path.exists()
    assert path.parent.parent == PKG / "_build"
    assert path.parent.name.startswith("etl-")
    assert native.load()._name == str(path)
    assert not list((PKG / "native").glob("*.so"))
    assert native.SRC.read_bytes() != b""


def test_a_failed_build_raises_from_load(tmp_path, monkeypatch):
    bad = tmp_path / "etl.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_state",
                        {"lib": None, "tried": False, "error": None})
    assert not native.available()
    assert native.csv_parse(b"1,2\n") is None   # callers take the twin
    with pytest.raises(RuntimeError, match="did not build or load"):
        native.load()
    assert not list((tmp_path / "_build").rglob("*.so"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sg_pairs_equal_to_the_reference_and_the_loop(seed):
    rng = np.random.default_rng(seed)
    encoded = [rng.integers(0, 50, n).astype(np.int32)
               for n in rng.integers(1, 30, 6)]
    bs = rng.integers(1, 6, sum(len(s) for s in encoded)).astype(np.int32)
    got = native.sg_pairs(encoded, bs)
    want = jnative.sg_pairs(encoded, bs)
    loop = _sg_loop(encoded, bs)
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in encoded])])
    flat = native.sg_pairs_flat(np.concatenate(encoded), offsets, bs)
    for a, b, c, d in zip(got, want, loop, flat):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, d)
    assert [len(v) for v in native.sg_pairs([], np.zeros(0, np.int32))] \
        == [0, 0]


CSV_BLOBS = [b"1,2.5,3\n4,5,6\n", b"1,2\r\n\r\n3,4\r\n", b"-1.5e2,2e-3\n",
             b"1,2\n3\n", b"a,b\n", b"0.1;0.2\n0.3;0.4\n"]


@pytest.mark.parametrize("blob", CSV_BLOBS)
def test_csv_parse_equal_to_the_reference_and_numpy(blob):
    delim = ";" if b";" in blob else ","
    got = native.csv_parse(blob, delim)
    want = jnative.csv_parse(blob, delim)
    if want is None:
        assert got is None
        return
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    twin = np.loadtxt(io.BytesIO(blob), dtype=np.float32, delimiter=delim,
                      ndmin=2, comments=None)
    assert got.tobytes() == twin.tobytes()


def test_csv_parse_random_table_bitwise():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 9)) * 10.0 ** rng.integers(-3, 4,
                                                          (200, 9))
    blob = "\n".join(",".join(repr(float(v)) for v in row)
                     for row in x).encode()
    got = native.csv_parse(blob)
    assert got.tobytes() == jnative.csv_parse(blob).tobytes()
    # strtof rounds each decimal to float32 once: within half an ulp
    np.testing.assert_allclose(got, x, rtol=2.0 ** -24, atol=0)


@pytest.mark.parametrize("flip,scale,shift", [(False, 1.0, 0.0),
                                              (True, 1 / 255.0, -0.5),
                                              (True, 2.0, 1.0)])
def test_hwc_to_chw_equal_to_the_reference_and_numpy(flip, scale, shift):
    img = np.random.default_rng(4).integers(0, 256, (13, 17, 3), np.uint8)
    got = native.hwc_to_chw(img, flip_h=flip, scale=scale, shift=shift)
    want = jnative.hwc_to_chw(img, flip_h=flip, scale=scale, shift=shift)
    assert got.tobytes() == want.tobytes()
    src = img[:, ::-1, :] if flip else img
    twin = src.transpose(2, 0, 1).astype(np.float32) * np.float32(scale) \
        + np.float32(shift)
    assert got.tobytes() == twin.tobytes()
    gray = native.hwc_to_chw(img[:, :, 0])
    assert gray.tobytes() == img[None, :, :, 0].astype(np.float32).tobytes()


@pytest.mark.parametrize("shape,out", [((16, 24, 3), (8, 12)),
                                       ((20, 20, 3), (31, 7)),
                                       ((9, 5, 1), (9, 5)),
                                       ((64, 48, 3), (224, 224))])
def test_resize_equal_to_the_reference_and_near_the_twin(shape, out):
    img = np.random.default_rng(5).integers(0, 256, shape, np.uint8)
    got = native.resize_hwc_to_chw(img, *out)
    want = jnative.resize_hwc_to_chw(img, *out)
    assert got.shape == (shape[2], *out)
    assert got.tobytes() == want.tobytes()
    twin = _bilinear_resize_chw(img, *out)
    assert twin.tobytes() == jax_twin(img, *out).tobytes()
    np.testing.assert_allclose(got, twin, rtol=0, atol=RESIZE_ATOL)
    flipped = native.resize_hwc_to_chw(img, *out, flip_h=True, scale=0.5,
                                       shift=-1.0)
    assert flipped.tobytes() == jnative.resize_hwc_to_chw(
        img, *out, flip_h=True, scale=0.5, shift=-1.0).tobytes()


def test_loader_takes_the_native_resize():
    img = np.random.default_rng(6).integers(0, 256, (20, 20, 3), np.uint8)
    got = NativeImageLoader(10, 10, 3).asMatrix(img)
    assert got.tobytes() == native.resize_hwc_to_chw(img, 10, 10).tobytes()
