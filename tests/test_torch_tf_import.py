"""The port's TF GraphDef import against the JAX package's, test by test.

Every test of ``tests/test_tf_import.py`` (59, two of them slow-marked
there and here) runs as it is written, with each import going through
both importers fed the same GraphDef bytes: the reference test's
``TFGraphMapper`` is replaced, for its run, by a twin whose
``importGraph`` returns a pair (the reference's graph, the port's on the
CPU). Every call the test makes on the pair runs in both packages:

- ``output``, ``eval`` and ``getArr`` answers to 1e-5 of the reference's
  largest element, ``calculateGradients`` to 1e-4 of it (or of 1e-2: a
  gradient that is 0 in exact arithmetic is rounding noise in both),
  ``fit`` loss curves to 1e-4 relative; names, variable lists and op
  kinds equal;
- ``save`` writes each package's zip and ``SameDiff.load`` restores the
  port's zip in the reference and the reference's in the port (the test's
  own assertions then hold the reference restoring the port's zip against
  the graph it was written from, and the pair compares the two restored
  graphs);
- an import that the reference refuses the port refuses too, with the
  reference's error class and message (the op-level detail of a rejected
  configuration aside);
- the reference test's own assertions run on the reference's answers,
  which the twin returns once the port's agree.

Then: the smoke's copy of the BERT GraphDef builder writes byte for byte
what ``tests/tf_bert_builder.py`` writes, the small-dims BERT imported from
it agrees to 1e-5 relative (loss, logits, gradients, fit), the port's
protobuf decodes what the reference's encodes (and back), an imported
graph lives on "cuda" unless the caller names a device, and, marked
``cuda``, the small-dims BERT on the card against the CPU.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import test_tf_import as ref_tests
from deeplearning4j_tpu.autodiff.samediff import (
    History as JaxHistory, SameDiff as JaxSameDiff, SDVariable as JaxVar,
    TrainingConfig as JaxTrainingConfig)
from deeplearning4j_tpu.modelimport import protobuf as jax_pb
from deeplearning4j_tpu.modelimport.tensorflow import (
    TFGraphMapper as JaxMapper, TFImportError as JaxImportError)
from deeplearning4j_tpu.ndarray import INDArray as JaxArray
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.modelimport import (
    TFGraphMapper, TFImportError, protobuf)
from deeplearning4j_tpu_torch.ndarray.ndarray import torch_dtype
from deeplearning4j_tpu_torch.optimize.updaters import Adam

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
FIT_RTOL = 1e-4
BERT_TOL = 1e-5     # the small-dims BERT, relative

cuda = pytest.mark.cuda
needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA GPU")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the other test workers' wall-clock checks share
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what, floor=1e-30):
    """got to tol of want's largest finite element (or of floor, if
    larger); NaN and infinities where want has them."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)], err_msg=what)
    scale = float(np.abs(want[fin]).max()) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=tol * max(scale, floor), err_msg=what)


# -- the twin ------------------------------------------------------------------------

class Twin:
    """A reference object and the port's counterpart, used where the
    reference test uses the reference's alone."""

    def __init__(self, ref, port):
        self._ref = ref
        self._port = port

    def __getattr__(self, name):
        r, p = getattr(self._ref, name), getattr(self._port, name)
        if callable(r) and not isinstance(r, type):
            return _TwinCall(r, p, name)
        return _pair(r, p, name)

    def save(self, path, saveUpdaterState=False):
        # each package writes its own zip; load() crosses them
        self._ref.save(str(path), saveUpdaterState)
        self._port.save(_port_zip(path), saveUpdaterState)


def _port_zip(path):
    return str(path) + ".port.zip"


def _side(v, port):
    """An argument as the reference's side or the port's side takes it."""
    if isinstance(v, Twin):
        return v._port if port else v._ref
    if isinstance(v, (list, tuple)):
        return type(v)(_side(a, port) for a in v)
    if isinstance(v, dict):
        return {k: _side(a, port) for k, a in v.items()}
    if port and isinstance(v, type) and hasattr(v, "dtype"):
        return torch_dtype(np.dtype(v.dtype))       # jnp.float32, ...
    if port and isinstance(v, JaxTrainingConfig):
        return TrainingConfig.from_json(v.to_json())
    return v


def _tol(method):
    return GRAD_TOL if method == "calculateGradients" else FWD_TOL


# a gradient that is 0 in exact arithmetic (the sum of a softmax) is
# rounding noise in both packages: gradients also pass within 1e-4 of
# this floor
GRAD_FLOOR = 1e-2


def _pair(r, p, what, method=""):
    """Compare the two sides' answers; the reference's to the test (a
    Twin where the answer is a graph or a variable)."""
    if isinstance(r, JaxArray):
        _close(p.toNumpy(), np.asarray(r.numpy()), _tol(method), what,
               GRAD_FLOOR if method == "calculateGradients" else 1e-30)
        return r
    if isinstance(r, dict):
        assert set(r) == set(p), (what, set(r), set(p))
        for k in r:
            _pair(r[k], p[k], f"{what}[{k!r}]", method)
        return r
    if isinstance(r, (JaxVar, JaxSameDiff)):
        return Twin(r, p)
    if isinstance(r, (tuple, list)) and r and all(
            isinstance(a, JaxVar) for a in r):
        return type(r)(Twin(a, b) for a, b in zip(r, p))
    if isinstance(r, JaxHistory):
        for attr in ("lossCurve", "iterLosses"):
            a, b = getattr(r, attr), getattr(p, attr)
            assert len(a) == len(b), (what, attr)
            np.testing.assert_allclose(b, a, rtol=FIT_RTOL,
                                       err_msg=f"{what}.{attr}")
        return r
    if isinstance(r, (tuple, list)) and r and hasattr(r[0], "fn_name"):
        assert [o.fn_name for o in r] == [o.fn_name for o in p], what
        return r
    if isinstance(r, (str, int, float, bool, tuple, list, set)) or \
            r is None:
        assert r == p, (what, r, p)
        return r
    if type(r).__module__.startswith("deeplearning4j_tpu."):
        return Twin(r, p)          # a namespace (sd.loss, sd.math, ...)
    return r


class _TwinCall:
    def __init__(self, r, p, name):
        self.r, self.p, self.name = r, p, name

    def __call__(self, *args, **kw):
        try:
            res_r = self.r(*_side(args, False), **_side(kw, False))
        except Exception as e:
            with pytest.raises(Exception) as got:
                self.p(*_side(args, True), **_side(kw, True))
            assert isinstance(got.value, ValueError) == isinstance(
                e, ValueError), (self.name, e, got.value)
            raise
        res_p = self.p(*_side(args, True), **_side(kw, True))
        return _pair(res_r, res_p, self.name, self.name)


def _bytes_of(graph):
    if isinstance(graph, (jax_pb.GraphDef, protobuf.GraphDef)):
        return graph.encode()
    return Path(graph).read_bytes()


def _norm(msg):
    """A refusal's text without what the two packages may word apart: the
    op-level detail after "rejected the configuration"."""
    return re.sub(r"rejected the configuration: .*", "rejected the "
                  "configuration", str(msg), flags=re.S)


class TwinMapper:
    """The reference test's TFGraphMapper: both importers, the same
    bytes."""

    @staticmethod
    def importGraph(graph, placeholder_shapes=None, trainable=False,
                    strict=False):
        kw = dict(placeholder_shapes=placeholder_shapes,
                  trainable=trainable, strict=strict)
        data = _bytes_of(graph)
        try:
            r = JaxMapper.importGraph(graph, **kw)
        except Exception as e:
            with pytest.raises(Exception) as got:
                TFGraphMapper.importGraph(data, device="cpu", **kw)
            p_err = got.value
            assert isinstance(p_err, TFImportError) == isinstance(
                e, JaxImportError), (e, p_err)
            assert isinstance(p_err, ValueError) == isinstance(
                e, ValueError), (e, p_err)
            assert _norm(p_err) == _norm(e).replace(
                "jax.image.resize equivalent", "imageResize equivalent"), \
                (str(p_err), str(e))
            raise
        p = TFGraphMapper.importGraph(data, device="cpu", **kw)
        return Twin(r, p)

    @staticmethod
    def makeTrainable(sd, names=None):
        a = JaxMapper.makeTrainable(sd._ref, names)
        b = TFGraphMapper.makeTrainable(sd._port, names)
        assert a == b, (a, b)
        return a


def _twin_load(path, loadUpdaterState=False):
    """The reference's zip restored in the port, the port's in the
    reference."""
    return Twin(_JAX_LOAD(_port_zip(path), loadUpdaterState),
                SameDiff.load(str(path), loadUpdaterState, device="cpu"))


_JAX_LOAD = JaxSameDiff.load


def _reference_tests():
    out = []
    for cname, cls in inspect.getmembers(ref_tests, inspect.isclass):
        if not cname.startswith("Test") or cls.__module__ != \
                ref_tests.__name__:
            continue
        for mname, fn in inspect.getmembers(cls, inspect.isfunction):
            if not mname.startswith("test_"):
                continue
            slow = any(m.name == "slow"
                       for m in getattr(fn, "pytestmark", []))
            out.append(pytest.param(cname, mname, id=f"{cname}::{mname}",
                                    marks=[pytest.mark.slow] if slow
                                    else []))
    return out


REFERENCE_TESTS = _reference_tests()


def test_every_reference_test_is_run():
    assert len(REFERENCE_TESTS) == 59
    src = Path(ref_tests.__file__).read_text()
    assert len(re.findall(r"^    def test_", src, re.M)) == 59


@pytest.mark.parametrize("cls_name,method", REFERENCE_TESTS)
def test_reference_test_on_both_importers(cls_name, method, monkeypatch,
                                          tmp_path):
    monkeypatch.setattr(ref_tests, "TFGraphMapper", TwinMapper)
    monkeypatch.setattr(JaxSameDiff, "load", staticmethod(_twin_load))
    obj = getattr(ref_tests, cls_name)()
    if hasattr(obj, "setup_method"):
        obj.setup_method(None)
    fn = getattr(obj, method)
    kw = {"tmp_path": tmp_path} if "tmp_path" in inspect.signature(
        fn).parameters else {}
    fn(**kw)


# -- the BERT GraphDef builder of chip_smoke.py -------------------------------------

def _smoke():
    import chip_smoke

    return chip_smoke


SMALL_BERT = dict(vocab=100, hidden=16, layers=2, heads=2, ffn=32,
                  max_len=32, batch=2, seq=8)


def test_smoke_bert_builder_writes_the_reference_builder_s_bytes():
    from tf_bert_builder import BertGraphBuilder as RefBuilder

    for dims in (SMALL_BERT, dict(SMALL_BERT, layers=1, seq=5, batch=3)):
        want = RefBuilder(**dims, seed=0).build().encode()
        got = _smoke().BertGraphBuilder(**dims, seed=0).build().encode()
        assert got == want


def _bert_feeds(vocab, batch, seq):
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(0, vocab, (batch, seq)).astype(
        np.int32), "labels": rng.integers(0, vocab, (batch, seq)).astype(
        np.int32)}


def test_small_bert_agrees_to_1e5_relative(tmp_path):
    data = _smoke().BertGraphBuilder(**SMALL_BERT, seed=0).build().encode()
    ref = JaxMapper.importGraph(jax_pb.GraphDef.parse(data))
    port = TFGraphMapper.importGraph(data, device="cpu")
    feeds = _bert_feeds(100, 2, 8)
    names = ("loss", "mlm/logits")
    want, got = ref.output(feeds, *names), port.output(feeds, *names)
    for k in names:
        _close(got[k].toNumpy(), np.asarray(want[k].numpy()), BERT_TOL, k)
    conv = TFGraphMapper.makeTrainable(port)
    assert conv == JaxMapper.makeTrainable(ref)
    for sd in (ref, port):
        sd.setLossVariables("loss")
    gw = ref.calculateGradients(feeds, *conv)
    gg = port.calculateGradients(feeds, *conv)
    # to 1e-4 of the largest gradient element of all (a gradient that is
    # 0 in exact arithmetic, the key bias's, is rounding noise in both)
    top = max(float(np.abs(np.asarray(gw[k].numpy())).max()) for k in conv)
    for k in conv:
        _close(gg[k].toNumpy(), np.asarray(gw[k].numpy()), BERT_TOL * 10, k,
               floor=top)
    from deeplearning4j_tpu.optimize.updaters import Adam as JaxAdam

    ref.setTrainingConfig(JaxTrainingConfig(
        updater=JaxAdam(1e-3), dataSetFeatureMapping=["input_ids"],
        dataSetLabelMapping=["labels"]))
    port.setTrainingConfig(TrainingConfig(
        updater=Adam(1e-3), dataSetFeatureMapping=["input_ids"],
        dataSetLabelMapping=["labels"]))
    batch = [(feeds["input_ids"], feeds["labels"])]
    hw = ref.fit(batch, epochs=3).lossCurve
    hg = port.fit(batch, epochs=3).lossCurve
    np.testing.assert_allclose(hg, hw, rtol=BERT_TOL)
    assert hg[-1] < hg[0]
    # the fine-tuned graph's zip restores in the reference
    port.save(str(tmp_path / "bert.zip"), saveUpdaterState=True)
    back = JaxSameDiff.load(str(tmp_path / "bert.zip"))
    _close(np.asarray(back.output(feeds, "loss")["loss"].numpy()),
           port.output(feeds, "loss")["loss"].toNumpy(), BERT_TOL, "zip")


def test_protobuf_reads_and_writes_the_reference_s_bytes():
    data = _smoke().BertGraphBuilder(**SMALL_BERT, seed=0).build().encode()
    gd = protobuf.GraphDef.parse(data)
    assert gd.encode() == data
    assert jax_pb.GraphDef.parse(data).encode() == data
    assert [n.name for n in gd.nodes] == [
        n.name for n in jax_pb.GraphDef.parse(data).nodes]
    # a function library survives both ways (the While graph of the tests)
    gdf, _ = ref_tests.TestFunctionalControlFlow._while_rnn_graph(3, 2, 2, 3)
    data = gdf.encode()
    assert protobuf.GraphDef.parse(data).encode() == data


def test_an_imported_graph_lives_on_cuda_unless_told(monkeypatch):
    data = _smoke().BertGraphBuilder(**SMALL_BERT, seed=0).build().encode()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="(?i)cuda|gpu"):
        TFGraphMapper.importGraph(data)
    sd = TFGraphMapper.importGraph(data, device="cpu")
    assert sd.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in sd._values.values())


def test_meta_shapes_hold_for_every_emitted_op_of_bert():
    """The import's shapes (from meta tensors) are the shapes the graph
    then computes."""
    data = _smoke().BertGraphBuilder(**SMALL_BERT, seed=0).build().encode()
    from deeplearning4j_tpu_torch.modelimport.tensorflow import _Importer

    im = _Importer(protobuf.GraphDef.parse(data), device="cpu")
    sd = im.run()
    outs = sd.output(_bert_feeds(100, 2, 8), *[
        k.rsplit(":", 1)[0] for k, v in im.vars.items()
        if k.endswith(":0") and v.name() == k[:-2]])
    for name, arr in outs.items():
        assert tuple(arr.shape()) == im.shapes[f"{name}:0"], name


# -- on the card -------------------------------------------------------------------

@cuda
@needs_cuda
def test_cuda_small_bert_matches_the_cpu():
    data = _smoke().BertGraphBuilder(**SMALL_BERT, seed=0).build().encode()
    gpu = TFGraphMapper.importGraph(data)
    cpu = TFGraphMapper.importGraph(data, device="cpu")
    assert gpu.device.type == "cuda"
    assert all(v.device.type == "cuda" for v in gpu._values.values())
    feeds = _bert_feeds(100, 2, 8)
    for k in ("loss", "mlm/logits"):
        _close(gpu.output(feeds, k)[k].toNumpy(),
               cpu.output(feeds, k)[k].toNumpy(), 1e-4, k)
    conv = TFGraphMapper.makeTrainable(gpu)
    assert conv == TFGraphMapper.makeTrainable(cpu)
    for sd in (gpu, cpu):
        sd.setLossVariables("loss")
    gg = gpu.calculateGradients(feeds, *conv)
    gc = cpu.calculateGradients(feeds, *conv)
    top = max(float(np.abs(gc[k].toNumpy()).max()) for k in conv)
    for k in conv:
        _close(gg[k].toNumpy(), gc[k].toNumpy(), 1e-4, k, floor=top)
    for sd in (gpu, cpu):
        sd.setTrainingConfig(TrainingConfig(
            updater=Adam(1e-3), dataSetFeatureMapping=["input_ids"],
            dataSetLabelMapping=["labels"]))
    batch = [(feeds["input_ids"], feeds["labels"])]
    np.testing.assert_allclose(gpu.fit(batch, epochs=3).lossCurve,
                               cpu.fit(batch, epochs=3).lossCurve,
                               rtol=1e-5)


def _port_while_rnn_graph(T, B, I, H, seed=0):
    """``TestFunctionalControlFlow._while_rnn_graph`` of the reference's
    tests, written with the port's protobuf (a StatelessWhile over a
    FunctionDef library: an Elman RNN over T steps)."""
    pb = protobuf
    rng = np.random.default_rng(seed)
    wx = rng.normal(size=(I, H)).astype(np.float32) * 0.5
    wh = rng.normal(size=(H, H)).astype(np.float32) * 0.5
    b = rng.normal(size=(H,)).astype(np.float32) * 0.1
    x = rng.normal(size=(T, B, I)).astype(np.float32)
    f32 = pb.attr_type(np.float32)

    def const(name, arr):
        arr = np.asarray(arr)
        return pb.NodeDef(name, "Const", [], {
            "dtype": pb.attr_type(arr.dtype), "value": pb.attr_tensor(arr)})

    args = [pb.ArgDef("i", pb.DT_INT32), pb.ArgDef("h", pb.DT_FLOAT),
            pb.ArgDef("x", pb.DT_FLOAT), pb.ArgDef("wx", pb.DT_FLOAT),
            pb.ArgDef("wh", pb.DT_FLOAT), pb.ArgDef("b", pb.DT_FLOAT)]
    cond_f = pb.FunctionDef(
        pb.OpDefSignature("rnn_cond", args, [pb.ArgDef("lt", pb.DT_BOOL)]),
        [const("steps", np.int32(T)),
         pb.NodeDef("less", "Less", ["i", "steps"],
                    {"T": pb.attr_type(np.int32)})],
        {"lt": "less:z:0"})
    body_f = pb.FunctionDef(
        pb.OpDefSignature("rnn_body", args,
                          [pb.ArgDef(f"o{k}", a.type)
                           for k, a in enumerate(args)]),
        [const("one", np.int32(1)),
         pb.NodeDef("inext", "AddV2", ["i", "one"],
                    {"T": pb.attr_type(np.int32)}),
         const("axis0", np.int32(0)),
         pb.NodeDef("xt", "GatherV2", ["x", "i", "axis0"], {"T": f32}),
         pb.NodeDef("mmx", "MatMul", ["xt", "wx"], {"T": f32}),
         pb.NodeDef("mmh", "MatMul", ["h", "wh"], {"T": f32}),
         pb.NodeDef("s1", "AddV2", ["mmx", "mmh"], {"T": f32}),
         pb.NodeDef("s2", "AddV2", ["s1", "b"], {"T": f32}),
         pb.NodeDef("hn", "Tanh", ["s2"], {"T": f32})],
        {"o0": "inext:z:0", "o1": "hn:y:0", "o2": "x",
         "o3": "wx", "o4": "wh", "o5": "b"})
    gd = pb.GraphDef([
        const("i0", np.int32(0)),
        const("h0", np.zeros((B, H), np.float32)),
        pb.NodeDef("x_in", "Placeholder", [], {
            "dtype": f32, "shape": pb.attr_shape([T, B, I])}),
        const("wx_c", wx), const("wh_c", wh), const("b_c", b),
        pb.NodeDef("loop", "StatelessWhile",
                   ["i0", "h0", "x_in", "wx_c", "wh_c", "b_c"],
                   {"cond": pb.attr_func("rnn_cond"),
                    "body": pb.attr_func("rnn_body")}),
        pb.NodeDef("h_final", "Identity", ["loop:1"], {"T": f32}),
    ], functions=[cond_f, body_f])
    return gd, x


def test_the_port_s_while_graph_is_the_reference_test_s():
    want, _ = ref_tests.TestFunctionalControlFlow._while_rnn_graph(5, 3, 4, 6)
    got, _ = _port_while_rnn_graph(5, 3, 4, 6)
    assert got.encode() == want.encode()


@cuda
@needs_cuda
def test_cuda_while_graph_matches_the_cpu():
    gd, x = _port_while_rnn_graph(5, 3, 4, 6)
    data = gd.encode()
    gpu = TFGraphMapper.importGraph(data)
    cpu = TFGraphMapper.importGraph(data, device="cpu")
    got = gpu.output({"x_in": x}, "h_final")["h_final"]
    assert got.torch().device.type == "cuda"
    _close(got.toNumpy(), cpu.output({"x_in": x}, "h_final")[
        "h_final"].toNumpy(), 1e-5, "h_final")
