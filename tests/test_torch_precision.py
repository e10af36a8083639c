"""The precision package of the port against the JAX package's.

Mirrors the classes of ``tests/test_precision.py`` that apply to what is
ported, each case run on the port and, where the reference answers the
same question, on the JAX package beside it from the same numpy weights:

- ``TestPolicy``: every named policy and a custom one, their JSON equal
  to the reference's, the configurations' JSON with a policy equal, the
  builder's eager check, ``cast_floating``.
- ``TestPolicySteps``: each named policy and a custom one trains a small
  MultiLayerNetwork (Dense, BatchNormalization, softmax output) and a
  small ComputationGraph of the same layers, 3 Sgd(0.1) steps, each from
  the same state in both packages. Exact: the scaler's state, the dtypes
  of params, running statistics and updater state. Float32 policies: the
  loss to 1e-5 relative, each step's update and the running statistics
  to 1e-4 of the largest element. bfloat16 and float16 compute: the
  port's error against a float32 step from the same state may be at most
  ``FACTOR`` times the JAX package's own, never held tighter than
  ``FACTOR`` unit roundoffs (2^-8 for bfloat16, 2^-11 for float16) of the
  largest element: the two packages round at different points (XLA's CPU
  backend may keep an elementwise chain in float32 and round once,
  PyTorch rounds after each op), each within a few unit roundoffs.
- ``TestMixedTraining``, ``TestOverflowSkip``, the graph case of
  ``TestTrainerIntegration``, ``TestScalerUnit``: the scaler's state after
  the same fits equal to the reference's; a non-finite step leaves params,
  Adam moments and running statistics bitwise as they were; the
  ``dl4j_precision_*`` snapshot and the ``precision`` flight events
  equal to the reference's for the same calls.
- ``TestAccuracyParity``: an MNIST-scale classifier under ``bf16_mixed``
  within 1% accuracy of float32.
- ``TestCheckpoints``: ``bf16`` and ``bf16_mixed`` zips (params, running
  statistics, Adam state, ``lossScale``) from each package restored in
  the other, bit-equal; a restored mixed run resumes at its warmed scale.
- ``TestQuantization``: the int8 payload and scales bit-equal to the
  reference's, served answers against the reference's
  ``QuantizedServable`` (5e-3 of the largest element; bfloat16
  activations), the 0.05 calibration bar, a snapshot that does not pin
  the net, embedding tables skipped, graphs refused; LeNet quantized with
  float32 compute against the reference's, and with bfloat16 compute
  (which the reference's conv refuses) within the 0.05 bar of the net.
- ``TestServableDtypeInference``: the boundary dtype from the policy,
  float32 for a bfloat16 output.
- ``TestUpdaterMixedGuard``.

All on the CPU at small sizes.
"""

import gc
import io
import json
import zipfile
import weakref
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jax_nn
from deeplearning4j_tpu import precision as jax_precision
from deeplearning4j_tpu import telemetry as jax_telemetry
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf.configuration import (
    MultiLayerConfiguration as JaxMLConf)
from deeplearning4j_tpu.nn.conf.graph_conf import (
    ComputationGraphConfiguration as JaxGraphConf)
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu.precision.quantize import (
    quantized_bytes as jax_quantized_bytes)
from deeplearning4j_tpu.telemetry import flight as jax_flight
from deeplearning4j_tpu.utils.serializer import (
    ModelSerializer as JaxSerializer)
from deeplearning4j_tpu_torch import nn as port_nn
from deeplearning4j_tpu_torch import precision, telemetry
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.optimize import updaters as port_updaters
from deeplearning4j_tpu_torch.precision import (
    DynamicLossScaler, Policy, named_policy, quantize, resolve_policy)
from deeplearning4j_tpu_torch.serving import (
    BucketLadder, InferenceSession, as_servable)
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry, flight
from deeplearning4j_tpu_torch.tree_util import tree_items, tree_leaves
from deeplearning4j_tpu_torch.utils import ModelSerializer
from deeplearning4j_tpu_torch.utils.convert import (
    params_from_numpy, states_from_numpy)

FN_RTOL = 1e-5
TRAIN_RTOL = 1e-4
FACTOR = 4
UNIT = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
SERVE_TOL = 5e-3     # quantized answers, port vs reference, of the largest
PTQ_TOL = 0.05       # the reference's calibration bar
LR = 0.1

JAX = SimpleNamespace(nn=jax_nn, U=jax_updaters, P=jax_precision,
                      net=jax_nn.MultiLayerNetwork,
                      graph=jax_nn.ComputationGraph)
PORT = SimpleNamespace(nn=port_nn, U=port_updaters, P=precision,
                       net=lambda c: MultiLayerNetwork(c, device="cpu"),
                       graph=lambda c: ComputationGraph(c, device="cpu"))

POLICIES = ["float32", "fp32", "bfloat16", "bf16", "bf16_mixed",
            "fp16_mixed", "custom"]


def _policy(ns, name):
    """A policy as each package takes it: a name, or the custom Policy
    (bfloat16 compute and output, fixed scale 128, growth interval 7)."""
    if name != "custom":
        return name
    return ns.P.Policy(name="custom", compute_dtype="bfloat16",
                       output_dtype="bfloat16", loss_scaling=128.0,
                       growth_interval=7)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    was = telemetry.enabled(), jax_telemetry.enabled()
    flight.get_recorder().clear()
    jax_flight.get_recorder().clear()
    yield
    (telemetry.enable if was[0] else telemetry.disable)()
    (jax_telemetry.enable if was[1] else jax_telemetry.disable)()


@pytest.fixture
def registries():
    """A fresh registry in each package, telemetry on."""
    regs = MetricsRegistry(), jax_telemetry.MetricsRegistry()
    prev = telemetry.set_registry(regs[0]), \
        jax_telemetry.set_registry(regs[1])
    telemetry.enable()
    jax_telemetry.enable()
    yield regs
    telemetry.set_registry(prev[0])
    jax_telemetry.set_registry(prev[1])


# ---------------------------------------------------------------------------
# building both packages from the same numpy weights
# ---------------------------------------------------------------------------

def _np(t):
    """A numpy float32/int copy of a tensor or JAX array (bfloat16 as the
    float32 that holds it)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype in (torch.bfloat16, torch.float16)
                else t).cpu().numpy().copy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.kind in "fV" and \
        a.dtype != np.float64 else a.copy()


def _tree_np(tree):
    return {"/".join(map(str, k)): _np(v) for k, v in tree_items(tree)}


def _jax_tree(port_tree):
    """A port tree (list or dict of dicts of tensors) as JAX arrays of the
    same dtypes."""
    def one(t):
        dt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
              torch.float32: jnp.float32,
              torch.int32: jnp.int32}[t.dtype]
        return jnp.asarray(_np(t)).astype(dt)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return one(x)

    return walk(port_tree)


def _conf(ns, kind, policy, updater=None, seed=3, n_in=8, hidden=16,
          n_out=3, bn=True):
    """The small network (``kind`` "mln") or graph ("graph") of the step
    tests in package ``ns``: Dense(relu), BatchNormalization, softmax
    output (MCXENT)."""
    nn = ns.nn
    b = nn.NeuralNetConfiguration.Builder().seed(seed).updater(
        updater(ns) if updater else ns.U.Sgd(LR))
    if policy is not None:
        b = b.precision(policy(ns) if callable(policy)
                        else _policy(ns, policy))
    dense = nn.DenseLayer.Builder().nIn(n_in).nOut(hidden).activation(
        "relu").build()
    out = nn.OutputLayer.Builder().nIn(hidden).nOut(n_out).activation(
        "softmax").lossFunction(nn.LossFunction.MCXENT).build()
    if kind == "mln":
        lb = b.list().layer(dense)
        if bn:
            lb = lb.layer(nn.BatchNormalization.Builder().nIn(hidden)
                          .build())
        return lb.layer(out).build()
    g = b.graphBuilder().addInputs("in").addLayer("d", dense, "in")
    last = "d"
    if bn:
        g = g.addLayer("bn", nn.BatchNormalization.Builder().nIn(hidden)
                       .build(), "d")
        last = "bn"
    return g.addLayer("out", out, last).setOutputs("out").build()


def _pair(kind, policy, arrays=None, updater=None, **kw):
    """(port on the CPU, JAX) of ``_conf``, the port's own builder's JSON
    asserted equal to the reference's; the port's weights (``arrays``: a
    numpy param tree to start from, else drawn) in both."""
    jconf = _conf(JAX, kind, policy, updater, **kw)
    text = jconf.to_json()
    assert _conf(PORT, kind, policy, updater, **kw).to_json() == text
    if kind == "mln":
        conf = MultiLayerConfiguration.from_json(text)
        port, jnet = PORT.net(conf), JAX.net(JaxMLConf.from_json(text))
    else:
        conf = ComputationGraphConfiguration.from_json(text)
        port, jnet = PORT.graph(conf), \
            JAX.graph(JaxGraphConf.from_json(text))
    assert conf.to_json() == text
    port.init(None if arrays is None else
              params_from_numpy(conf, arrays, "cpu"))
    _skip_draws(jnet)
    _sync(port, jnet)
    return port, jnet


def _skip_draws(jnet):
    """The JAX network's ``init()`` with each layer's ``init_params``
    giving zeros (nothing drawn: ``_sync`` sets the port's weights)."""
    conf = jnet.conf
    nodes = (list(conf.layers) if hasattr(conf, "layers") else
             [n for n, _ in conf.nodes.values()
              if hasattr(n, "init_params")])
    for lr in nodes:
        shapes = lr.param_shapes() if hasattr(lr, "param_shapes") else {}
        lr.init_params = (lambda key, dtype=jnp.float32, s=shapes:
                          {k: jnp.zeros(v, dtype) for k, v in s.items()})
    try:
        jnet.init()
    finally:
        for lr in nodes:
            lr.__dict__.pop("init_params", None)


def _sync(port, jnet):
    """The JAX network's params, layer states, updater state and scaler
    state set to the port's."""
    jnet._params = _jax_tree(port._params)
    jnet._states = _jax_tree(port._states)
    jnet._opt_states = _jax_tree(port._opt_states)
    jnet._prec_state = _jax_tree(port._prec_state)


def _data(n=32, n_in=8, n_out=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)]
    return x, y


def _scaler(net):
    """The scaler state as Python numbers (exact)."""
    return {k: float(_np(v)) for k, v in net._prec_state.items()}


def _net(policy=None, seed=1, n_in=8, hidden=16, n_out=3, updater=None):
    """tests/test_precision.py's ``_net``: Dense(relu) and a softmax
    output, Adam(1e-3), in both packages from the port's weights."""
    return _pair("mln", policy, seed=seed, n_in=n_in, hidden=hidden,
                 n_out=n_out, bn=False,
                 updater=updater or (lambda ns: ns.U.Adam(1e-3)))


# ---------------------------------------------------------------------------
# TestPolicy
# ---------------------------------------------------------------------------

class TestPolicy:
    def test_named_policies(self):
        p = named_policy("bf16_mixed")
        assert p.param_dtype == "float32"
        assert p.compute_dtype == "bfloat16"
        assert p.output_dtype == "float32"
        assert p.loss_scaling == "dynamic" and p.is_mixed
        assert (p.param_torch, p.compute_torch, p.output_torch) == (
            torch.float32, torch.bfloat16, torch.float32)
        assert not named_policy("bfloat16").is_mixed
        with pytest.raises(ValueError, match="unknown precision policy"):
            named_policy("int4_wishful")
        assert sorted(precision.NAMED_POLICIES) == sorted(
            jax_precision.NAMED_POLICIES)

    @pytest.mark.parametrize("name", POLICIES)
    def test_json_equal_to_the_reference(self, name):
        port = resolve_policy(_policy(PORT, name), "float32")
        ref = jax_precision.resolve_policy(_policy(JAX, name), "float32")
        assert json.dumps(port.to_json()) == json.dumps(ref.to_json())
        back = Policy.from_json(json.loads(json.dumps(ref.to_json())))
        assert back == port
        assert {k: getattr(port, k) for k in Policy.__dataclass_fields__} \
            == {k: getattr(ref, k) for k in Policy.__dataclass_fields__}
        assert (port.is_mixed, port.scaling_enabled) == (
            ref.is_mixed, ref.scaling_enabled)

    @pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
    def test_resolve_defaults_to_datatype(self, dt):
        p = resolve_policy(None, dt)
        ref = jax_precision.resolve_policy(None, dt)
        assert p.param_dtype == p.compute_dtype == dt
        assert not p.scaling_enabled
        assert {k: getattr(p, k) for k in Policy.__dataclass_fields__} == \
            {k: getattr(ref, k) for k in Policy.__dataclass_fields__}
        assert json.dumps(p.to_json()) == json.dumps(ref.to_json())

    def test_json_round_trip(self):
        assert Policy.from_json("bf16_mixed") == named_policy("bf16_mixed")
        custom = Policy(name="custom", compute_dtype="bfloat16",
                        loss_scaling=128.0, growth_interval=7)
        back = Policy.from_json(json.loads(json.dumps(custom.to_json())))
        assert back.loss_scaling == 128.0 and back.growth_interval == 7

    @pytest.mark.parametrize("kind", ["mln", "graph"])
    @pytest.mark.parametrize("name", ["bf16_mixed", "custom"])
    def test_conf_round_trip(self, kind, name):
        port, jnet = _pair(kind, name)
        cls = (MultiLayerConfiguration if kind == "mln"
               else ComputationGraphConfiguration)
        c2 = cls.from_json(port.conf.to_json())
        assert c2.to_json() == jnet.conf.to_json() == port.conf.to_json()
        assert c2.precision_policy == resolve_policy(_policy(PORT, name),
                                                     "float32")
        if name == "bf16_mixed":
            assert c2.precision == "bf16_mixed"

    def test_builder_rejects_typo_eagerly(self):
        with pytest.raises(ValueError, match="unknown precision policy"):
            port_nn.NeuralNetConfiguration.Builder().precision("bf61_mixed")
        with pytest.raises(ValueError, match="unknown precision policy"):
            jax_nn.NeuralNetConfiguration.Builder().precision("bf61_mixed")

    def test_cast_floating_leaves_ints_and_f64(self):
        tree = {"w": torch.ones((2,), dtype=torch.float32),
                "ids": torch.ones((2,), dtype=torch.int32),
                "d": torch.ones((2,), dtype=torch.float64),
                "g": {"b": torch.ones((2,), dtype=torch.bfloat16)}}
        out = precision.cast_floating(tree, "bfloat16")
        assert out["w"].dtype == torch.bfloat16
        assert out["ids"].dtype == torch.int32
        assert out["d"].dtype == torch.float64
        assert out["g"]["b"] is tree["g"]["b"]   # nothing to cast


# ---------------------------------------------------------------------------
# every policy, step by step against the JAX package
# ---------------------------------------------------------------------------

_BASE = {}


def _base(kind):
    """The step tests' shared start: weights drawn once a kind and rounded
    to bfloat16 (float32 holds them exactly, so every policy starts from
    the same values), 3 batches, and a float32 JAX network for the
    yardstick."""
    if kind not in _BASE:
        port, _ = _pair(kind, None)
        arrays = tree_map_np(port._params, lambda a: np.asarray(
            torch.tensor(a).to(torch.bfloat16).float()))
        _, j32 = _pair(kind, None, arrays)
        _BASE[kind] = arrays, [_data(16, seed=s) for s in (1, 2, 3)], j32
    return _BASE[kind]


def tree_map_np(tree, fn):
    if isinstance(tree, dict):
        return {k: tree_map_np(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_np(v, fn) for v in tree]
    return fn(_np(tree))


def _as_f32(jtree):
    """A JAX tree upcast to float32 (the yardstick's state)."""
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        # copies: each network's fit donates its buffers
        return jnp.array(x, dtype=jnp.float32, copy=True) \
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) \
            else jnp.array(x, copy=True)

    return walk(jtree)


def _derived_close(got, ref, f32, unit, what):
    """The port's error against the float32 yardstick within FACTOR times
    the reference's own, never tighter than FACTOR unit roundoffs of the
    yardstick's largest element."""
    got, ref, f32 = (np.asarray(a, np.float64) for a in (got, ref, f32))
    e_port = float(np.abs(got - f32).max())
    e_ref = float(np.abs(ref - f32).max())
    bound = FACTOR * max(e_ref, unit * float(np.abs(f32).max()))
    assert e_port <= bound, (what, e_port, e_ref, bound)


@pytest.mark.parametrize("kind", ["mln", "graph"])
@pytest.mark.parametrize("name", POLICIES)
def test_policy_steps_against_the_reference(kind, name):
    arrays, batches, j32 = _base(kind)
    port, jnet = _pair(kind, name, arrays)
    pol = port.conf.precision_policy
    unit = UNIT.get(pol.compute_dtype)
    pdt = pol.param_torch
    for step, (x, y) in enumerate(batches):
        _sync(port, jnet)
        j32._params, j32._states = (_as_f32(jnet._params),
                                    _as_f32(jnet._states))
        j32._opt_states = _as_f32(jnet._opt_states)
        before = _tree_np(port._params)
        s_before = _tree_np(port._states)
        port.fit([(x, y)])
        jnet.fit([(x, y)])
        j32.fit([(x, y)])
        # exact: dtypes and the scaler
        assert {v.dtype for v in tree_leaves(port._params)} == {pdt}
        assert {v.dtype for v in tree_leaves(port._states)} == {pdt}
        assert {str(v.dtype) for v in tree_leaves(jnet._params)} == {
            pol.param_dtype}
        assert _scaler(port) == _scaler(jnet), (name, step)
        got, ref, f32 = (_tree_np(n._params) for n in (port, jnet, j32))
        st = [_tree_np(n._states) for n in (port, jnet, j32)]
        if unit is None:
            assert abs(port.score() - jnet.score()) <= \
                FN_RTOL * abs(jnet.score())
            for k in ref:
                np.testing.assert_allclose(
                    got[k] - before[k], ref[k] - before[k], rtol=0,
                    atol=TRAIN_RTOL * np.abs(ref[k] - before[k]).max(),
                    err_msg=f"{name} step {step} {k}")
            for k in st[1]:
                np.testing.assert_allclose(
                    st[0][k], st[1][k], rtol=0,
                    atol=TRAIN_RTOL * np.abs(st[1][k]).max())
            continue
        _derived_close(port.score(), jnet.score(), j32.score(), unit,
                       f"{name} step {step} loss")
        for k in ref:
            _derived_close(got[k] - before[k], ref[k] - before[k],
                           f32[k] - before[k], unit,
                           f"{name} step {step} update {k}")
        for k in st[1]:
            _derived_close(st[0][k] - s_before[k], st[1][k] - s_before[k],
                           st[2][k] - s_before[k], unit,
                           f"{name} step {step} state {k}")
    # inference returns the output dtype, computed in the compute dtype
    x = batches[0][0]
    y_port = (port.output(x) if kind == "mln" else port.outputSingle(x))
    y_ref = (jnet.output(x) if kind == "mln" else jnet.outputSingle(x))
    assert y_port.dataType() == pol.output_torch
    assert str(np.asarray(y_ref.numpy()).dtype) == pol.output_dtype
    if unit is not None:
        y32 = (j32.output(x) if kind == "mln" else j32.outputSingle(x))
        _derived_close(y_port.toNumpy(), _np(y_ref.numpy()),
                       _np(y32.numpy()), unit, f"{name} output")


# ---------------------------------------------------------------------------
# TestMixedTraining
# ---------------------------------------------------------------------------

class TestMixedTraining:
    def test_master_weights_and_moments_stay_fp32(self):
        port, jnet = _net("bf16_mixed")
        x, y = _data()
        for net in (port, jnet):
            net.fit([(x, y)], 3)
        assert port._params[0]["W"].dtype == torch.float32
        assert port._opt_states[0]["m"]["W"].dtype == torch.float32
        assert np.isfinite(port.score((x, y)))
        assert _scaler(port) == _scaler(jnet) == {
            "scale": 2.0 ** 15, "good_steps": 3.0, "overflows": 0.0}

    def test_pure_bf16_unchanged(self):
        port, jnet = _net("bf16")
        x, y = _data()
        port.fit([(x, y)], 2)
        jnet.fit([(x, y)], 2)
        assert port._params[0]["W"].dtype == torch.bfloat16
        assert port._opt_states[0]["m"]["W"].dtype == torch.bfloat16
        assert port._prec_state == {} == jnet._prec_state

    def test_compute_dtype_actually_bf16(self):
        """A bf16_mixed net's loss differs from the float32 net's beyond
        float32 roundoff and agrees to bf16 tolerance (same weights, same
        data), in both packages."""
        x, y = _data(seed=3)
        p32, j32 = _net(None, seed=9)
        arrays = tree_map_np(p32._params, lambda a: a)
        pmx, jmx = _pair("mln", "bf16_mixed", arrays, bn=False,
                         updater=lambda ns: ns.U.Adam(1e-3))
        l32, lmx = p32.score((x, y)), pmx.score((x, y))
        assert lmx != l32
        assert abs(lmx - l32) / abs(l32) < 0.02
        _derived_close(lmx, jmx.score((x, y)), j32.score((x, y)),
                       UNIT["bfloat16"], "score")

    def test_growth_after_interval(self):
        def pol(ns):
            return ns.P.Policy(name="grow", param_dtype="float32",
                               compute_dtype="bfloat16",
                               output_dtype="float32",
                               loss_scaling="dynamic", init_scale=2.0 ** 10,
                               growth_interval=3)

        nets = _net(pol)
        x, y = _data()
        for net in nets:
            net.fit([(x, y)], 3)
        assert _scaler(nets[0]) == _scaler(nets[1])
        assert _scaler(nets[0])["scale"] == 2.0 ** 11
        assert _scaler(nets[0])["good_steps"] == 0

    def test_fixed_scaling(self):
        def pol(ns):
            return ns.P.Policy(name="fixed", param_dtype="float32",
                               compute_dtype="bfloat16",
                               output_dtype="float32", loss_scaling=256.0)

        port, jnet = _net(pol)
        x, y = _data()
        xbad = x.copy()
        xbad[0, 0] = np.inf
        for net in (port, jnet):
            net.fit([(x, y)], 4)
            net.fit([(xbad, y)], 1)
        # a fixed scale never backs off, but the gate still skips
        assert _scaler(port) == _scaler(jnet)
        assert _scaler(port)["scale"] == 256.0
        assert _scaler(port)["overflows"] == 1
        assert np.isfinite(port.getParam(0, "W").toNumpy()).all()


# ---------------------------------------------------------------------------
# TestOverflowSkip
# ---------------------------------------------------------------------------

class TestOverflowSkip:
    def test_skip_halve_recover_with_one_step_per_batch(self, registries):
        port, jnet = _net("bf16_mixed", seed=7)
        x, y = _data()
        for net in (port, jnet):
            net.fit([(x, y)], 1)
        before = port.getParam(0, "W").toNumpy().copy()
        xbad = x.copy()
        xbad[0, 0] = np.inf
        inner = port._step
        calls = []

        def counting(*a, **kw):
            calls.append(1)
            return inner(*a, **kw)

        port._step = counting
        port.fit([(xbad, y), (x, y), (x, y)], 1)
        assert len(calls) == 3                    # one step a batch
        del port._step
        jnet.fit([(xbad, y), (x, y), (x, y)], 1)
        assert _scaler(port) == _scaler(jnet)
        assert _scaler(port)["overflows"] == 1
        assert _scaler(port)["scale"] == 2.0 ** 14    # halved once
        w = port.getParam(0, "W").toNumpy()
        assert np.isfinite(w).all()
        assert not np.array_equal(before, w)      # good steps applied

    @pytest.mark.parametrize("kind", ["mln", "graph"])
    def test_bad_step_state_bitwise_unchanged(self, kind):
        """Params, Adam moments and BatchNormalization's running
        statistics are bitwise as they were after a non-finite step."""
        port, jnet = _pair(kind, "bf16_mixed",
                           updater=lambda ns: ns.U.Adam(1e-3))
        x, y = _data()
        port.fit([(x, y)], 2)
        before = [_np(v) for v in tree_leaves(
            [port._params, port._opt_states, port._states])]
        xbad = x.copy()
        xbad[3, 1] = np.nan
        port.fit([(xbad, y)], 1)
        after = [_np(v) for v in tree_leaves(
            [port._params, port._opt_states, port._states])]
        assert len(before) == len(after) > 6
        assert all(np.array_equal(a, b) for a, b in zip(before, after))
        assert _scaler(port)["overflows"] == 1

    def test_precision_metrics_and_flight_event(self, registries):
        port, jnet = _net("bf16_mixed", seed=9)
        x, y = _data()
        xbad = x.copy()
        xbad[0, 0] = np.inf
        for net in (port, jnet):
            net.fit([(x, y), (xbad, y), (x, y)], 1)
        snap, jsnap = (r.snapshot() for r in registries)
        assert snap == {k: v for k, v in jsnap.items()
                        if k.startswith("dl4j_precision")}
        assert snap['dl4j_precision_skipped_steps_total{loop="fit"}'] == 1.0
        assert snap['dl4j_precision_overflow_total{loop="fit"}'] == 1.0
        assert snap['dl4j_precision_loss_scale{loop="fit"}'] == 2.0 ** 14
        events = flight.get_recorder().events("precision")
        jevents = jax_flight.get_recorder().events("precision")
        drop = ("seq", "ts", "mono")
        assert [{k: v for k, v in e.items() if k not in drop}
                for e in events] == [{k: v for k, v in e.items()
                                      if k not in drop} for e in jevents]
        assert events[-1]["event"] == "overflow"
        assert events[-1]["step"] == 1
        assert events[-1]["loss_scale"] == 2.0 ** 14

    def test_zero_registry_calls_when_telemetry_disabled(self):
        class CountingStub:
            calls = 0

            def __getattr__(self, name):
                CountingStub.calls += 1
                raise AssertionError(
                    f"registry.{name} touched while disabled")

        port, _ = _net("bf16_mixed", seed=11)
        x, y = _data()
        prev = telemetry.set_registry(CountingStub())
        was = telemetry.enabled()
        telemetry.disable()
        try:
            xbad = x.copy()
            xbad[0, 0] = np.inf
            port.fit([(x, y), (xbad, y), (x, y)], 1)
            assert CountingStub.calls == 0
        finally:
            telemetry.set_registry(prev)
            (telemetry.enable if was else telemetry.disable)()
        assert _scaler(port)["overflows"] == 1
        assert np.isfinite(port.getParam(0, "W").toNumpy()).all()


# ---------------------------------------------------------------------------
# TestTrainerIntegration (the graph case)
# ---------------------------------------------------------------------------

class TestTrainerIntegration:
    def test_graph_mixed_training(self, registries):
        port, jg = _pair("graph", "bf16_mixed", bn=False,
                         updater=lambda ns: ns.U.Adam(1e-3))
        assert port.conf.precision_policy.is_mixed
        x, y = _data()
        xbad = x.copy()
        xbad[0, 0] = np.inf
        for g in (port, jg):
            g.fit([(x, y)], 2)
        assert port._params["d"]["W"].dtype == torch.float32
        assert _scaler(port) == _scaler(jg)
        assert _scaler(port)["good_steps"] == 2
        for g in (port, jg):
            g.fit([(xbad, y)], 1)
        assert _scaler(port) == _scaler(jg)
        assert _scaler(port)["overflows"] == 1
        key = 'dl4j_precision_skipped_steps_total{loop="graph"}'
        assert registries[0].snapshot()[key] == \
            registries[1].snapshot()[key] == 1.0


# ---------------------------------------------------------------------------
# TestAccuracyParity
# ---------------------------------------------------------------------------

class TestAccuracyParity:
    def test_mnist_scale_bf16_within_1pct_of_fp32(self):
        rng = np.random.default_rng(42)
        n, d, k = 1024, 64, 10
        centers = rng.normal(scale=2.0, size=(k, d)).astype(np.float32)
        labels = rng.integers(0, k, n)
        x = (centers[labels]
             + rng.normal(scale=1.0, size=(n, d))).astype(np.float32)
        y = np.eye(k, dtype=np.float32)[labels]
        batches = [(x[i:i + 128], y[i:i + 128]) for i in range(0, n, 128)]

        def run(policy):
            b = port_nn.NeuralNetConfiguration.Builder().seed(21).updater(
                port_updaters.Adam(1e-3))
            if policy:
                b = b.precision(policy)
            conf = (b.list()
                    .layer(port_nn.DenseLayer.Builder().nIn(d).nOut(128)
                           .activation("relu").build())
                    .layer(port_nn.OutputLayer.Builder().nOut(k)
                           .activation("softmax").lossFunction("mcxent")
                           .build()).build())
            net = MultiLayerNetwork(conf, device="cpu").init()
            net.fit(batches, 12)
            return net.evaluate([(x, y)], numClasses=k).accuracy()

        acc32, accmx = run(None), run("bf16_mixed")
        assert acc32 > 0.8
        assert abs(acc32 - accmx) <= 0.01


# ---------------------------------------------------------------------------
# TestCheckpoints: zips in each direction
# ---------------------------------------------------------------------------

def _trained_pair(kind, policy):
    port, jnet = _pair(kind, policy, updater=lambda ns: ns.U.Adam(1e-3))
    x, y = _data()
    xbad = x.copy()
    xbad[0, 0] = np.inf
    # a scaling policy skips the bad batch (2 overflows over 2 epochs);
    # without scaling a non-finite step would write NaN into the params
    port.fit([(x, y), (xbad if port._prec_state else x, y), (x, y)], 2)
    _sync(port, jnet)
    jnet._iteration, jnet._epoch = port._iteration, port._epoch
    return port, jnet, (x, y)


def _bits(t):
    """A leaf's bits (bfloat16 as uint16), for bit-equality."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


class TestCheckpoints:
    @pytest.mark.parametrize("kind", ["mln", "graph"])
    @pytest.mark.parametrize("policy", ["bf16", "bf16_mixed"])
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_zip_restores_bit_equal_in_the_other(self, tmp_path, kind,
                                                 policy, writer):
        port, jnet, (x, y) = _trained_pair(kind, policy)
        path = str(tmp_path / "model.zip")
        mtype = "MultiLayerNetwork" if kind == "mln" else "ComputationGraph"
        if writer == "port":
            ModelSerializer.writeModel(port, path)
            back = getattr(JaxSerializer, f"restore{mtype}")(path)
            src = port
        else:
            JaxSerializer.writeModel(jnet, path)
            back = getattr(ModelSerializer, f"restore{mtype}")(
                path, device="cpu")
            src = jnet
        for tree in ("_params", "_states", "_opt_states"):
            a = [_bits(v) for v in _leaves(getattr(src, tree))]
            b = [_bits(v) for v in _leaves(getattr(back, tree))]
            assert len(a) == len(b) > 0
            for u, v in zip(a, b):
                assert u.dtype == v.dtype and np.array_equal(u, v), tree
        assert _scaler(back) == _scaler(src)
        assert back._iteration == src._iteration == 6
        if policy == "bf16_mixed":
            assert _scaler(back) == {"scale": 2.0 ** 13, "good_steps": 1.0,
                                     "overflows": 2.0}
            # a resumed run continues from the warmed scale
            back.fit([(x, y)], 1)
            assert _scaler(back) == {"scale": 2.0 ** 13, "good_steps": 2.0,
                                     "overflows": 2.0}

    def test_pure_bf16_codec_names_the_leaves(self, tmp_path):
        port, _, _ = _trained_pair("mln", "bf16")
        path = str(tmp_path / "b.zip")
        ModelSerializer.writeModel(port, path)
        with zipfile.ZipFile(path) as zf:
            dtypes = json.loads(zf.read("paramDtypes.json"))
            udtypes = json.loads(zf.read("updaterDtypes.json"))
            npz = np.load(io.BytesIO(zf.read("params.npz")))
            assert set(dtypes.values()) == set(udtypes.values()) == {
                "bfloat16"}
            assert set(dtypes) == set(npz.files)
            assert all(npz[k].dtype == np.uint16 for k in npz.files)


def _leaves(tree):
    """Leaves in the port's order of a port or JAX tree."""
    return [v for _, v in tree_items(tree)]


# ---------------------------------------------------------------------------
# TestQuantization
# ---------------------------------------------------------------------------

def _trained(seed=20):
    port, jnet = _net(None, seed=seed, n_in=16, hidden=32, n_out=4)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]
    port.fit([(x, y)], 8)
    _sync(port, jnet)
    return port, jnet, x


class TestQuantization:
    def test_quantize_array_round_trip(self):
        rng = np.random.default_rng(0)
        w = rng.normal(size=(32, 16)).astype(np.float32)
        q, scale = precision.quantize_array(w)
        jq, jscale = jax_precision.quantize_array(w)
        assert q.dtype == np.int8 and scale.shape == (16,)
        assert np.array_equal(q, jq) and np.array_equal(scale, jscale)
        back = q.astype(np.float32) * scale
        assert np.abs(back - w).max() <= scale.max() / 2 + 1e-7
        tq, tscale = precision.quantize_array(torch.tensor(w))
        assert np.array_equal(tq, q) and np.array_equal(tscale, scale)

    def test_ptq_within_atol_and_the_reference(self):
        port, jnet, x = _trained()
        calib = [x[i * 16:(i + 1) * 16] for i in range(4)]
        qsv = quantize(port, calib, example_shape=(16,), device="cpu")
        jq = jax_precision.quantize(jnet, calib, example_shape=(16,))
        assert qsv.calibration_max_err is not None
        assert qsv.calibration_max_err <= PTQ_TOL
        ref = port.output(x).toNumpy()
        got = np.asarray(qsv.infer(x), np.float32)
        assert np.abs(ref - got).max() <= PTQ_TOL
        want = np.asarray(jq.infer(x), np.float32)
        assert np.abs(got - want).max() <= SERVE_TOL * np.abs(want).max()
        assert abs(qsv.calibration_max_err - jq.calibration_max_err) <= \
            SERVE_TOL
        assert len(qsv.activation_absmax) == len(port.layers)
        for a, b in zip(qsv.activation_absmax, jq.activation_absmax):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    def test_ptq_payload_equals_the_reference(self):
        port, jnet, x = _trained(seed=22)
        qsv = quantize(port, [x[:8]], example_shape=(16,), device="cpu")
        jq = jax_precision.quantize(jnet, [x[:8]], example_shape=(16,))
        for i in range(len(port.layers)):
            q, scale = qsv._qparams[i]["W"]
            jq_w, js = jq._qparams[i]["W"]
            assert q.dtype == torch.int8 and scale.dtype == torch.float32
            assert np.array_equal(q.numpy(), np.asarray(jq_w))
            assert np.array_equal(scale.numpy(), np.asarray(js))
            b = qsv._qparams[i]["b"]
            assert b.dtype == torch.float32   # biases stay float
        extra = qsv.describe_extra()
        assert extra["bytes"] == jax_quantized_bytes(jq._qparams)
        assert extra["quantization"] == jq.describe_extra()["quantization"]

    def test_ptq_snapshot_frozen_after_training(self):
        port, _, x = _trained(seed=23)
        qsv = quantize(port, [x[:8]], example_shape=(16,), device="cpu")
        before = np.asarray(qsv.infer(x[:8]), np.float32)
        y = np.eye(4, dtype=np.float32)[np.zeros(64, np.int64)]
        port.fit([(x, y)], 3)                    # train the source on
        after = np.asarray(qsv.infer(x[:8]), np.float32)
        assert np.array_equal(before, after)     # a snapshot

    def test_ptq_served_through_inference_session(self):
        port, jnet, x = _trained(seed=24)
        qsv = quantize(port, [x[:16]], example_shape=(16,), device="cpu")
        jq = jax_precision.quantize(jnet, [x[:16]], example_shape=(16,))
        with InferenceSession(max_latency=0.001, device="cpu") as session:
            entry = session.register("m_int8", qsv,
                                     ladder=BucketLadder((1, 8, 16)),
                                     warmup=True)
            preds = np.concatenate([session.predict("m_int8", x[i:i + n])
                                    for i, n in ((0, 8), (8, 3), (11, 1))])
        want = np.asarray(jq.infer(x[:12]), np.float32)
        assert np.abs(preds - want).max() <= SERVE_TOL * np.abs(want).max()
        assert np.abs(preds - port.output(x[:12]).toNumpy()).max() <= \
            PTQ_TOL
        row = entry.describe()
        assert row["quantization"] == "int8_per_channel_absmax"
        assert row["bytes"]["int8"] == 16 * 32 + 32 * 4
        assert row["warmed_shapes"] == [[1, 16], [8, 16], [16, 16]]

    def test_embedding_tables_auto_skipped(self):
        nets = []
        for ns in (PORT, JAX):
            conf = (ns.nn.NeuralNetConfiguration.Builder().seed(25).list()
                    .layer(ns.nn.EmbeddingLayer.Builder().nIn(50).nOut(8)
                           .build())
                    .layer(ns.nn.OutputLayer.Builder().nIn(8).nOut(4)
                           .activation("softmax")
                           .lossFunction(ns.nn.LossFunction.MCXENT).build())
                    .build())
            nets.append(ns.net(conf))
        port = nets[0].init()
        jnet = nets[1]
        _skip_draws(jnet)
        _sync(port, jnet)
        ids = np.arange(8, dtype=np.int32)[:, None]
        qsv = quantize(port, [], example_shape=(1,), dtype=np.int32,
                       device="cpu")
        jq = jax_precision.quantize(jnet, [], example_shape=(1,),
                                    dtype=np.int32)
        w_emb = qsv._qparams[0]["W"]
        assert isinstance(w_emb, torch.Tensor) and w_emb.is_floating_point()
        assert isinstance(qsv._qparams[1]["W"], tuple)
        ref = port.output(ids).toNumpy()
        got = np.asarray(qsv.infer(ids), np.float32)
        assert np.abs(ref - got).max() <= PTQ_TOL
        want = np.asarray(jq.infer(ids), np.float32)
        assert np.abs(got - want).max() <= SERVE_TOL * np.abs(want).max()

    def test_servable_does_not_pin_source_net(self):
        port, jnet, x = _trained(seed=26)
        del jnet
        qsv = quantize(port, [x[:8]], example_shape=(16,), device="cpu")
        ref = weakref.ref(port)
        del port
        gc.collect()
        assert ref() is None
        y = np.asarray(qsv.infer(x[:8]))
        assert np.isfinite(y).all()

    def test_quantize_rejects_graphs(self):
        port, jg = _pair("graph", None, bn=False)
        with pytest.raises(TypeError, match="MultiLayerNetwork"):
            quantize(port, [], example_shape=(8,), device="cpu")
        with pytest.raises(TypeError, match="MultiLayerNetwork"):
            jax_precision.quantize(jg, [], example_shape=(8,))

    @pytest.mark.parametrize("compute", ["float32", "bfloat16"])
    def test_lenet_quantized(self, compute):
        """LeNet (BASELINE config 0) at its widths, quantized after two
        Adam steps: float32 compute against the reference's servable;
        bfloat16 compute, where the reference's conv refuses a bfloat16
        input beside the float32 kernel, within the 0.05 bar (the port
        runs such a conv in float32, JAX's promotion)."""
        from deeplearning4j_tpu_torch.datasets.mnist import synthesize_mnist

        text = jax_zoo.LeNet().conf().to_json()
        conf = MultiLayerConfiguration.from_json(text)
        assert zoo.LeNet().conf().to_json() == text
        port = MultiLayerNetwork(conf, device="cpu").init()
        x, labels = synthesize_mnist(64, seed=5)
        y = np.eye(10, dtype=np.float32)[labels]
        port.fit([(x[:32], y[:32]), (x[32:], y[32:])])
        calib = [x[:32], x[32:]]
        qsv = quantize(port, calib, example_shape=(784,),
                       compute_dtype=compute, device="cpu")
        assert qsv.calibration_max_err <= PTQ_TOL
        assert [k for k, v in qsv._qparams[4].items()
                if isinstance(v, tuple)] == ["W"]
        assert qsv._qparams[4]["W"][0].dtype == torch.int8
        assert not isinstance(qsv._qparams[0]["W"], tuple)   # conv kernel
        if compute == "float32":
            jnet = jax_nn.MultiLayerNetwork(JaxMLConf.from_json(text))
            _skip_draws(jnet)
            _sync(port, jnet)
            jq = jax_precision.quantize(jnet, calib, example_shape=(784,),
                                        compute_dtype="float32")
            for i in (4, 5):
                assert np.array_equal(qsv._qparams[i]["W"][0].numpy(),
                                      np.asarray(jq._qparams[i]["W"][0]))
            got = np.asarray(qsv.infer(x), np.float32)
            want = np.asarray(jq.infer(x), np.float32)
            assert np.abs(got - want).max() <= 1e-5
        else:
            jnet = jax_nn.MultiLayerNetwork(JaxMLConf.from_json(text))
            _skip_draws(jnet)
            _sync(port, jnet)
            with pytest.raises(TypeError, match="same dtypes"):
                jax_precision.quantize(jnet, calib, example_shape=(784,))


# ---------------------------------------------------------------------------
# TestServableDtypeInference
# ---------------------------------------------------------------------------

class TestServableDtypeInference:
    def test_fp32_default(self):
        port, _ = _net(None, seed=30)
        assert as_servable(port, example_shape=(8,)).dtype == np.float32

    def test_bf16_net_serves_float32_holding_bf16(self):
        """The reference's boundary is bfloat16 (ml_dtypes); the port's
        float32 holding bfloat16 values, the same numbers."""
        port, jnet = _net("bf16", seed=31)
        sv = as_servable(port, example_shape=(8,))
        assert sv.dtype == np.float32
        x = _data(4)[0]
        y = sv.infer(x)
        assert y.dtype == np.float32
        assert np.array_equal(
            y, torch.tensor(y).to(torch.bfloat16).float().numpy())
        assert np.array_equal(y, port.output(x).toNumpy())
        want = _np(jnet.output(x).numpy())
        np.testing.assert_allclose(y, want, rtol=0,
                                   atol=FACTOR * UNIT["bfloat16"])

    def test_mixed_net_infers_fp32_boundary(self):
        port, _ = _net("bf16_mixed", seed=32)
        sv = as_servable(port, example_shape=(8,))
        assert sv.dtype == np.float32
        y = sv.infer(np.zeros((2, 8), np.float32))
        assert np.asarray(y).dtype == np.float32

    def test_explicit_dtype_still_wins(self):
        port, _ = _net("bf16", seed=33)
        sv = as_servable(port, example_shape=(8,), dtype=np.float16)
        assert sv.dtype == np.float16


# ---------------------------------------------------------------------------
# TestScalerUnit and TestUpdaterMixedGuard
# ---------------------------------------------------------------------------

class TestScalerUnit:
    def test_unscale_exact_powers_of_two(self):
        sc = DynamicLossScaler(init_scale=2.0 ** 12)
        st = sc.init_state()
        scaled = torch.tensor([1.5 * 2 ** 12, -2.25 * 2 ** 12])
        out = sc.unscale({"w": scaled}, st)
        assert torch.equal(out["w"], torch.tensor([1.5, -2.25]))
        bf = sc.unscale({"w": scaled.to(torch.bfloat16)}, st)["w"]
        assert bf.dtype == torch.bfloat16
        assert torch.equal(bf.float(), torch.tensor([1.5, -2.25]))

    def test_all_finite(self):
        sc = DynamicLossScaler()
        assert bool(sc.all_finite({"a": torch.ones(3)}))
        assert not bool(sc.all_finite(
            {"a": torch.ones(3), "b": torch.tensor([np.inf])}))
        assert not bool(sc.all_finite(
            {"a": torch.ones(3, dtype=torch.bfloat16),
             "b": {"c": torch.tensor([np.nan])}}))
        assert not bool(sc.all_finite({"a": torch.tensor([-np.inf])}))
        assert bool(sc.all_finite({"ids": torch.ones(2, dtype=torch.int32),
                                   "e": torch.ones(0)}))

    def test_backoff_floor_and_growth_cap(self):
        from deeplearning4j_tpu_torch.precision import scaler as scaler_mod

        sc = DynamicLossScaler(init_scale=1.0, growth_interval=1)
        st = sc.next_state(sc.init_state(), torch.tensor(False))
        assert float(st["scale"]) == scaler_mod.MIN_SCALE
        sc2 = DynamicLossScaler(init_scale=scaler_mod.MAX_SCALE,
                                growth_interval=1)
        st2 = sc2.next_state(sc2.init_state(), torch.tensor(True))
        assert float(st2["scale"]) == scaler_mod.MAX_SCALE

    @pytest.mark.parametrize("fixed", [False, True])
    def test_next_state_sequence_equals_the_reference(self, fixed):
        flags = [True, True, False, True, True, True, False, False, True]
        if fixed:
            sc = precision.FixedLossScaler(64.0)
            jsc = jax_precision.FixedLossScaler(64.0)
        else:
            sc = DynamicLossScaler(init_scale=2.0 ** 4, growth_interval=2)
            jsc = jax_precision.DynamicLossScaler(init_scale=2.0 ** 4,
                                                  growth_interval=2)
        st, jst = sc.init_state(), jsc.init_state()
        for f in flags:
            st = sc.next_state(st, torch.tensor(f))
            jst = jsc.next_state(jst, jnp.bool_(f))
            assert {k: float(v) for k, v in st.items()} == {
                k: float(np.asarray(v)) for k, v in jst.items()}
            assert (st["scale"].dtype, st["good_steps"].dtype,
                    st["overflows"].dtype) == (torch.float32, torch.int32,
                                               torch.int32)


class TestUpdaterMixedGuard:
    def test_apply_mixed_casts_grad_to_param_dtype(self):
        u = port_updaters.Adam(1e-3)
        params = {"W": torch.ones((2, 2))}
        state = u.init_state(params)
        upd, new_state = u.apply_mixed(
            {"W": torch.ones((2, 2), dtype=torch.bfloat16)}, state,
            params, 0)
        assert upd["W"].dtype == torch.float32
        assert new_state["m"]["W"].dtype == torch.float32


def test_states_from_numpy_reads_reference_bf16_arrays():
    """The reference's bfloat16 arrays (ml_dtypes, kind 'V') go into the
    port by their bits."""
    port, jnet = _pair("mln", "bf16")
    conf = port.conf
    arrays = [{k: np.asarray(v) for k, v in p.items()}
              for p in jnet._params]
    assert arrays[0]["W"].dtype.kind == "V"
    got = params_from_numpy(conf, arrays, "cpu")
    for p, q in zip(tree_leaves(got), tree_leaves(port._params)):
        assert p.dtype == torch.bfloat16 and torch.equal(p, q)
    states = states_from_numpy(conf, [{k: np.asarray(v) for k, v in s.items()}
                                      for s in jnet._states], "cpu")
    assert states[1]["var"].dtype == torch.bfloat16
