"""The rest of the port's op registry against the JAX package's, op by op.

Every name that the reference registers past ``autodiff/ops.py:1150`` (88
names: linear algebra, segment reductions, sorting and top-k, image and
colorspace ops, special functions, ``ctcLoss``, non-max suppression,
scatters, losses and noise layers) is called in both packages on the same
seeded numpy inputs and attributes, the inputs those of
``tests/test_op_validation.py``:

- forward: each output to 1e-5 of the reference's largest finite element
  (float32 on the CPU, where both packages call LAPACK for the linear
  algebra, so signs agree element by element), NaN and infinities where
  the reference has them, the same dtype;
- for each differentiable op, the gradient of a weighted sum of its
  float outputs w.r.t. its float inputs (``jax.grad`` against
  ``torch.autograd.grad``) to 1e-4 of the largest element (skipped where
  jax has none: the product scatters ``segmentProd`` and ``scatterMul``;
  ``betainc`` refuses a and b as the reference does);
- the random ops (``randomShuffle`` and the noise layers) by their
  moments and their identity at inference, since they never agree by seed;
- the registry, its random and training-aware flags, the namespaces and a
  graph of the new ops through SameDiff (gradients, the zip both ways).

The ``cuda``-marked cases run every case on the card against the port on
the CPU (the linear algebra by reconstruction and singular values: the
card's cuSOLVER may choose other signs).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.autodiff import ops as jax_ops
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JaxSameDiff
from deeplearning4j_tpu_torch.autodiff import ops
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from samediff_op_cases import (
    BY_RECONSTRUCTION, CASES, F32, FWD_TOL, GRAD_TOL, I32, IDS, LINALG,
    build as _build, close as _close, reconstructs as _reconstructs,
    to_numpy as _np)

DRAWS = 200000

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


def _registrations():
    """(line, name) of each registration in the reference's op registry,
    read from its source (the file, not the module, so that this module
    also collects where the JAX package is stubbed)."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parent.parent / "deeplearning4j_tpu" /
           "autodiff" / "ops.py").read_text().splitlines()
    return [(i, m.group(1) or m.group(2))
            for i, line in enumerate(src, 1)
            for m in re.finditer(r'OPS\["(\w+)"\]\s*=|@op\("(\w+)"', line)]


EARLY = {n for i, n in _registrations() if 61 <= i <= 1150}
LATER_NAMES = sorted({n for i, n in _registrations() if i > 1150} - EARLY)
LATER_RANDOM = ("randomShuffle", "alphaDropout", "gaussianDropout",
                "gaussianNoise")


def _conv(v, to):
    if isinstance(v, tuple):
        return tuple(_conv(a, to) for a in v)
    return to(v) if isinstance(v, (np.ndarray, np.generic)) else v


def _jnp(v):
    return _conv(v, jnp.asarray)


def _torch(v, device="cpu"):
    return _conv(v, lambda a: torch.from_numpy(np.array(a)).to(device))


def _tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


def test_registry_is_the_reference_s():
    assert len(LATER_NAMES) == 88
    assert set(LATER_NAMES) == set(jax_ops.OPS) - EARLY
    assert set(ops.OPS) == set(jax_ops.OPS) and len(ops.OPS) == 260
    assert not hasattr(ops, "PENDING_OPS")
    assert ops.RANDOM_OPS == jax_ops.RANDOM_OPS
    assert ops.TRAINING_AWARE_OPS == jax_ops.TRAINING_AWARE_OPS == {
        "dropout", "alphaDropout", "gaussianDropout", "gaussianNoise"}
    # ops with no tensor input are told the graph's device
    assert ops.DEVICE_OPS == {"linspace", "range", "eye_op", "eye", "fill"}


def test_cases_cover_every_later_name():
    covered = {n for n, *_ in CASES} | set(LATER_RANDOM)
    assert covered == set(LATER_NAMES)
    # the four random ones have forward cases of their own below
    assert set(LATER_RANDOM) <= set(LATER_NAMES)


@pytest.mark.parametrize("name,variant,build,grad", CASES, ids=IDS)
def test_op_forward_matches_jax(name, variant, build, grad):
    inputs, attrs = _build(name, variant, build)
    want = _tuple(jax_ops.OPS[name](*map(_jnp, inputs), **attrs))
    got = _tuple(ops.OPS[name](*map(_torch, inputs), **attrs))
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert _np(g).dtype == _np(w).dtype, (k, _np(g).dtype,
                                              _np(w).dtype)
        assert g.shape == w.shape
        if (name, variant) not in BY_RECONSTRUCTION:
            _close(g, w, FWD_TOL, f"{name} output {k}")
    if (name, variant) in BY_RECONSTRUCTION:
        _close(got[0], want[0], FWD_TOL, f"{name} singular values")
        _reconstructs(name, got, _torch(inputs[0]), FWD_TOL * 10)


GRAD_CASES = [(n, v, b, g) for n, v, b, g in CASES if g != ()]


def _float_positions(inputs, grad):
    if grad is not None:
        return list(grad)
    return [i for i, v in enumerate(inputs)
            if not isinstance(v, tuple) and np.asarray(v).dtype == F32]


@pytest.mark.parametrize("name,variant,build,grad", GRAD_CASES,
                         ids=[f"{n}-{v}" if v else n
                              for n, v, _, _ in GRAD_CASES])
def test_op_gradient_matches_jax(name, variant, build, grad):
    inputs, attrs = _build(name, variant, build)
    pos = _float_positions(inputs, grad)
    outs = _tuple(jax_ops.OPS[name](*map(_jnp, inputs), **attrs))
    rng = np.random.default_rng(7)
    weights = [rng.uniform(0.5, 1.5, size=np.shape(o)).astype(F32)
               for o in outs]
    floats = [k for k, o in enumerate(outs)
              if jnp.issubdtype(o.dtype, jnp.floating)]

    def jax_loss(*diff):
        args = list(map(_jnp, inputs))
        for i, d in zip(pos, diff):
            args[i] = d
        res = _tuple(jax_ops.OPS[name](*args, **attrs))
        return sum(jnp.sum(res[k] * weights[k]) for k in floats)

    want = jax.grad(jax_loss, argnums=tuple(range(len(pos))))(
        *[jnp.asarray(inputs[i]) for i in pos])
    args = list(map(_torch, inputs))
    leaves = [args[i].clone().requires_grad_(True) for i in pos]
    for i, leaf in zip(pos, leaves):
        args[i] = leaf
    res = _tuple(ops.OPS[name](*args, **attrs))
    loss = sum(torch.sum(res[k] * torch.from_numpy(weights[k]))
               for k in floats)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    for i, leaf, g, w in zip(pos, leaves, got, want):
        g = torch.zeros_like(leaf) if g is None else g
        _close(g, w, GRAD_TOL, f"{name} d/d input {i}")


def test_betainc_refuses_a_gradient_in_a_and_b_as_the_reference():
    a, b, x = (np.float32(v) for v in (1.5, 2.0, 0.3))
    with pytest.raises(ValueError, match="with respect to a and b"):
        jax.grad(lambda a: jax_ops.OPS["betainc"](a, b, x))(a)
    at = torch.tensor(1.5, requires_grad=True)
    with pytest.raises(ValueError, match="with respect to a and b"):
        ops.OPS["betainc"](at, torch.tensor(2.0), torch.tensor(0.3)
                           ).backward()


def test_segment_ops_need_num_segments_when_the_ids_are_unknown():
    data = torch.zeros(3, device="meta")
    ids = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="numSegments"):
        ops.OPS["segmentSum"](data, ids)
    assert ops.OPS["segmentSum"](data, ids, numSegments=4).shape == (4,)
    with pytest.raises(ValueError, match="maxLength"):
        ops.OPS["bincount"](ids)
    assert ops.OPS["bincount"](ids, maxLength=5).shape == (5,)


# -- random ops: moments, and the identity at inference ---------------------------

def _moments(x):
    x = np.asarray(x, np.float64).ravel()
    return x.mean(), x.std()


@pytest.mark.parametrize("name,attrs", [
    ("alphaDropout", {"p": 0.3}), ("gaussianDropout", {"p": 0.2}),
    ("gaussianNoise", {"stddev": 0.5})])
def test_noise_layer_moments_match_the_reference_s(name, attrs):
    xs = np.random.default_rng(0).normal(size=(DRAWS,)).astype(F32)
    want = np.asarray(jax_ops.OPS[name](jnp.asarray(xs), key=jax.random.key(0),
                                        training=True, **attrs))
    gen = torch.Generator().manual_seed(0)
    got = ops.OPS[name](torch.from_numpy(xs), generator=gen, training=True,
                        **attrs).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    (gm, gs), (wm, ws) = _moments(got), _moments(want)
    assert abs(gm - wm) < 6 * ws / np.sqrt(DRAWS) * np.sqrt(2), (gm, wm)
    assert abs(gs - ws) < 0.01 * ws, (gs, ws)
    # a generator seeded alike draws alike; no generator is no noise
    again = ops.OPS[name](torch.from_numpy(xs),
                          generator=torch.Generator().manual_seed(0),
                          training=True, **attrs).numpy()
    assert np.array_equal(got, again)
    out = ops.OPS[name](torch.from_numpy(xs), generator=None, training=True,
                        **attrs).numpy()
    assert np.array_equal(out, xs)


def test_random_shuffle_permutes_the_rows():
    x = np.arange(24, dtype=F32).reshape(8, 3)
    want = np.asarray(jax_ops.OPS["randomShuffle"](jnp.asarray(x),
                                                   key=jax.random.key(0)))
    got = ops.OPS["randomShuffle"](
        torch.from_numpy(x), generator=torch.Generator().manual_seed(0)
    ).numpy()
    for out in (want, got):
        assert out.shape == x.shape and out.dtype == x.dtype
        # whole rows move, every row once
        assert sorted(map(tuple, out.tolist())) == sorted(
            map(tuple, x.tolist()))
    # over many draws each row lands everywhere about equally often
    hits = np.zeros((8, 8))
    gen = torch.Generator().manual_seed(1)
    for _ in range(800):
        perm = ops.OPS["randomShuffle"](torch.arange(8), generator=gen)
        hits[perm.numpy(), np.arange(8)] += 1
    assert hits.min() > 50 and hits.max() < 150


# -- through SameDiff --------------------------------------------------------------

def _namespace_graph(sd, f32):
    a = sd.constant("a", np.array([[4.0, 1.0], [1.0, 3.0]], F32))
    x = sd.placeHolder("x", f32, 2, 4, 4, 4)
    y = sd.placeHolder("y", f32, 3)
    z = sd.placeHolder("z", f32, 3)
    lab = sd.constant("lab", np.array([[1, 2]], I32))
    logits = sd.placeHolder("logits", f32, 1, 4, 3)
    return [sd.math.atan2(y, z, name="at"), sd.linalg.cholesky(a, name="ch"),
            sd.image.spaceToDepth(x, blockSize=2, name="s2d"),
            sd.loss.ctcLoss(lab, logits, name="ctc")]


def test_namespaces_build_the_later_ops_in_both_packages():
    r = np.random.default_rng(0)
    feeds = {"x": r.normal(size=(2, 4, 4, 4)).astype(F32),
             "y": r.normal(size=3).astype(F32),
             "z": r.normal(size=3).astype(F32),
             "logits": r.normal(size=(1, 4, 3)).astype(F32)}
    sd = SameDiff(device="cpu")
    jsd = JaxSameDiff()
    outs = [v.name() for v in _namespace_graph(sd, torch.float32)]
    assert outs == [v.name() for v in _namespace_graph(jsd, jnp.float32)]
    got = sd.output(feeds, *outs)
    want = jsd.output(feeds, *outs)
    for k in outs:
        _close(got[k].toNumpy(), np.asarray(want[k].numpy()), FWD_TOL, k)
    # the loss namespace marks its output as a loss, as the reference
    assert sd.getLossVariables() == jsd.getLossVariables() == ["ctc"]
    # an unknown name is still refused when the graph is built
    with pytest.raises(ValueError, match="unknown op"):
        sd._op("noSuchOp", [sd.getVariable("x")])
    assert len(sd._ops) == len(jsd._ops)


def _segment_graph(sd):
    data = sd.var("d", np.asarray([1.0, 2.0, 3.0, 0.5], F32))
    ids = sd.constant("i", np.asarray([0, 1, 0, 2], I32))
    w = sd.var("w", np.asarray([[1.0, 0.5], [0.2, 2.0]], F32))
    s = sd.math.segmentMax(data, ids, numSegments=3, name="smax")
    tk, _ = sd.math.topK(s, k=2, name="tk")
    inv = sd.linalg.matrixInverse(w, name="inv")
    loss = sd.math.sum(sd.math.square(tk), name="l1")
    loss2 = sd.math.sum(sd._op("lgamma", [sd.math.abs(inv)]), name="l2")
    tot = sd._op("add", [loss, loss2], name="loss")
    sd.setLossVariables(tot)
    return ["smax", "tk", "tk:1", "inv", "loss"]


def test_a_graph_of_later_ops_differentiates_and_zips_both_ways(tmp_path):
    sd = SameDiff(device="cpu")
    jsd = JaxSameDiff()
    outs = _segment_graph(sd)
    assert outs == _segment_graph(jsd)
    got, want = sd.output({}, *outs), jsd.output({}, *outs)
    for k in outs:
        _close(got[k].toNumpy(), np.asarray(want[k].numpy()), FWD_TOL, k)
    gg = sd.calculateGradients({}, "d", "w")
    gw = jsd.calculateGradients({}, "d", "w")
    for k in ("d", "w"):
        _close(gg[k].toNumpy(), np.asarray(gw[k].numpy()), GRAD_TOL, k)
    # the reference's zip loads in the port and the port's in the
    # reference, each answering as the graph it was written from
    jsd.save(str(tmp_path / "jax.zip"))
    sd.save(str(tmp_path / "torch.zip"))
    back = SameDiff.load(str(tmp_path / "jax.zip"), device="cpu")
    jback = JaxSameDiff.load(str(tmp_path / "torch.zip"))
    for k in outs:
        _close(back.output({}, k)[k].toNumpy(),
               np.asarray(want[k].numpy()), FWD_TOL, k)
        _close(np.asarray(jback.output({}, k)[k].numpy()),
               got[k].toNumpy(), FWD_TOL, k)


def test_random_later_ops_run_in_a_graph_only_when_training():
    sd = SameDiff(device="cpu")
    x = sd.placeHolder("x", torch.float32, 64, 8)
    y = sd._op("gaussianNoise", [x], {"stddev": 0.5}, name="noisy")
    sh = sd._op("randomShuffle", [x], name="shuf")
    xs = np.random.default_rng(0).normal(size=(64, 8)).astype(F32)
    # output() runs at inference: the noise layer is the identity there
    np.testing.assert_array_equal(sd.output({"x": xs}, "noisy")[
        "noisy"].toNumpy(), xs)
    got = sd.output({"x": xs}, "shuf")["shuf"].toNumpy()
    assert sorted(map(tuple, got.tolist())) == sorted(map(tuple,
                                                          xs.tolist()))
    assert y.name() == "noisy" and sh.name() == "shuf"


# -- on the card ----------------------------------------------------------------------

@cuda
@needs_cuda
@pytest.mark.parametrize("name,variant,build,grad", CASES, ids=IDS)
def test_cuda_op_matches_the_cpu(name, variant, build, grad):
    inputs, attrs = _build(name, variant, build)
    kw = {"device": "cuda"} if name in ops.DEVICE_OPS else {}
    got = _tuple(ops.OPS[name](*[_torch(v, "cuda") for v in inputs],
                               **attrs, **kw))
    want = _tuple(ops.OPS[name](*map(_torch, inputs), **attrs))
    for g in got:
        assert g.device.type == "cuda"
    if name in ("svd", "qr", "lu"):
        _reconstructs(name, got, _torch(inputs[0]), 1e-4)
        return
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype
        _close(g, w, 1e-4 if name in LINALG else FWD_TOL,
               f"{name} output {k}")
