"""The port's admission control and the session's decoder and priority
calls, against the JAX package's.

- The reference's ``TestAdmissionControl`` (``tests/test_serving_scale.py``)
  runs on both packages as cases of one parametrised test: the shedding
  order of the priority classes, tickets recycled by the session's
  futures, the shed counted and an unknown class refused.
- A scripted sequence of admits and releases gives the same decisions and
  the same standing loads in both controllers.
- ``TestSessionIntegration::test_session_decode_and_priority_predict`` on
  both packages (a small MLP served with ``priority=``, a transformer
  decoder through ``register_decoder``/``decode``), and the session's
  decode path: a decode shed like a predict, its ticket released when the
  stream ends, ``timing`` filled, ``unregister_decoder`` closing the
  engine and its memory claims, a decode model on another device refused,
  the flight records the reference writes.

Instruments are a stub with the reference's interface (``shed``,
``request``) on both packages: the port's serving instruments come with
the telemetry slice. Everything runs on the CPU (``device="cpu"``).
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import pytest

from deeplearning4j_tpu import serving as jax_serving
from deeplearning4j_tpu.nn import (
    DenseLayer, LossFunction, MultiLayerNetwork as JaxNet,
    NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu.serving.registry import ModelNotFound as JaxMNF
from deeplearning4j_tpu_torch import serving as port_serving
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving.registry import ModelNotFound
from deeplearning4j_tpu_torch.telemetry import flight, memledger
from deeplearning4j_tpu_torch.utils.convert import params_from_numpy

PKGS = ["jax", "torch"]


class _Inst:
    """The reference's ServingInstruments interface, counting in dicts."""

    def __init__(self):
        self.sheds = collections.Counter()
        self.requests = collections.Counter()

    def shed(self, priority):
        self.sheds[priority] += 1

    def request(self, outcome):
        self.requests[outcome] += 1


def _serving(pkg):
    return jax_serving if pkg == "jax" else port_serving


def _session(pkg, **kw):
    if pkg == "torch":
        kw["device"] = "cpu"
    return _serving(pkg).InferenceSession(**kw)


def _mlp(pkg, seed=1, n_in=6, n_out=3):
    conf = (NeuralNetConfiguration.Builder().seed(seed).list()
            .layer(DenseLayer.Builder().nIn(n_in).nOut(16)
                   .activation("tanh").build())
            .layer(OutputLayer.Builder().nOut(n_out).activation("softmax")
                   .lossFunction(LossFunction.MCXENT).build())
            .build())
    net = JaxNet(conf).init()
    if pkg == "jax":
        return net
    pconf = MultiLayerConfiguration.from_json(net.conf.to_json())
    arrays = [{k: np.asarray(v).copy() for k, v in p.items()}
              for p in net._params]
    return MultiLayerNetwork(pconf, device="cpu").init(
        params_from_numpy(pconf, arrays, "cpu"))


def _double_servable(pkg):
    """y = 2x, host-side: the reference's StubServable without replicas."""
    S = _serving(pkg)
    if pkg == "jax":
        class Stub(S.Servable):
            def __init__(self):
                super().__init__((2,))

            def warmup(self, ladder):
                return []

            def infer(self, x):
                return np.asarray(x) * 2.0
        return Stub()

    class PortStub(S.Servable):
        def __init__(self):
            super().__init__((2,), "cpu")

        def _infer_fn(self):
            return lambda x: x * 2.0

        def _call_args(self):
            return ()
    return PortStub()


def _xf(pkg, **kw):
    d = dict(vocab=16, hidden=16, n_layers=1, n_heads=2, max_len=32,
             max_slots=2, page=4, seed=2)
    d.update(kw)
    if pkg == "torch":
        d["device"] = "cpu"
    return _serving(pkg).TransformerDecodeModel.init(**d)


# ---------------------------------------------------------------------------
# the reference's TestAdmissionControl, on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_priority_budget_shedding_order(pkg):
    """batch is capped at 50% of the budget, normal at 85%, high rides to
    the top, so overload sheds best-effort first."""
    S = _serving(pkg)
    adm = S.AdmissionController(default_budget=10)
    tickets = []
    for _ in range(5):
        tickets.append(adm.admit("m", "batch"))
    with pytest.raises(S.ShedError) as ei:
        adm.admit("m", "batch")           # 5 >= 10*0.5
    assert ei.value.retry_after > 0
    for _ in range(3):
        tickets.append(adm.admit("m", "normal"))
    with pytest.raises(S.ShedError):
        adm.admit("m", "normal")          # 8 >= 10*0.85
    for _ in range(2):
        tickets.append(adm.admit("m", "high"))
    with pytest.raises(S.ShedError):
        adm.admit("m", "high")            # full budget
    for t in tickets:
        t.release()
    adm.admit("m", "batch").release()     # drained: admits again


@pytest.mark.parametrize("pkg", PKGS)
def test_ticket_released_on_future_completion(pkg):
    S = _serving(pkg)
    sess = _session(pkg, max_latency=0.0, queue_size=8,
                    admission=S.AdmissionController(default_budget=2))
    sess.register("adm", _double_servable(pkg),
                  ladder=S.BucketLadder((1,)))
    x = np.zeros((1, 2), np.float32)
    for _ in range(6):   # budget 2 but tickets recycle per request
        y = sess.predict("adm", x, timeout=5.0)
        np.testing.assert_array_equal(np.asarray(y), x * 2.0)
    assert sess.admission.describe()["adm"]["standing"] == 0
    # the direct path takes and returns a ticket too
    sess.predict("adm", x, batched=False)
    assert sess.admission.describe()["adm"]["standing"] == 0
    sess.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_shed_metric_and_unknown_priority(pkg):
    S = _serving(pkg)
    adm = S.AdmissionController(default_budget=1)
    with pytest.raises(ValueError):
        adm.admit("m", "urgent")
    inst = _Inst()
    t = adm.admit("shedm", "high", inst=inst)
    with pytest.raises(S.ShedError) as ei:
        adm.admit("shedm", "batch", inst=inst)
    assert inst.sheds == {"batch": 1}
    assert inst.requests == {"shed": 1}
    assert ei.value.priority == "batch"
    t.release()


def test_shed_is_flight_recorded():
    flight.get_recorder().clear()
    adm = port_serving.AdmissionController(default_budget=1)
    t = adm.admit("fl", "high")
    with pytest.raises(port_serving.ShedError):
        adm.admit("fl", "train")
    evts = flight.get_recorder().events("shed")
    assert evts and evts[-1]["model"] == "fl"
    assert evts[-1]["priority"] == "train" and evts[-1]["standing"] == 1
    t.release()


@pytest.mark.parametrize("budget", [1, 4, 10, 64])
def test_scripted_decisions_match_jax(budget):
    """The same admits and releases, in the same order, give the same
    admit/shed decisions and standing loads in both controllers."""
    rng = np.random.default_rng(budget)
    ctrls = {pkg: _serving(pkg).AdmissionController(default_budget=budget)
             for pkg in PKGS}
    held = {pkg: [] for pkg in PKGS}
    log = {pkg: [] for pkg in PKGS}
    for _ in range(200):
        op = rng.integers(0, 3)
        prio = ("high", "normal", "batch", "train")[rng.integers(0, 4)]
        model = ("a", "b")[rng.integers(0, 2)]
        for pkg in PKGS:
            S = _serving(pkg)
            if op < 2:
                try:
                    held[pkg].append(ctrls[pkg].admit(model, prio))
                    log[pkg].append(("ok", model, prio))
                except S.ShedError as e:
                    log[pkg].append(("shed", model, prio, e.priority))
            elif held[pkg]:
                held[pkg].pop(0).release()
                log[pkg].append(("release",))
    assert log["jax"] == log["torch"]
    standing = {pkg: {m: d["standing"] for m, d in
                      ctrls[pkg].describe().items()} for pkg in PKGS}
    assert standing["jax"] == standing["torch"]


def test_class_fractions_and_set_budget_match_jax():
    from deeplearning4j_tpu.serving import admission as jax_adm
    from deeplearning4j_tpu_torch.serving import admission as port_adm

    assert port_adm.PRIORITIES == jax_adm.PRIORITIES
    assert port_adm.DEFAULT_CLASS_FRACTION == \
        jax_adm.DEFAULT_CLASS_FRACTION
    for mod in (jax_adm, port_adm):
        adm = mod.AdmissionController().set_budget(
            "m", 3, class_fractions={"high": 1.0, "normal": 0.34})
        with adm.admit("m", "normal"):
            with pytest.raises(mod.ShedError):
                adm.admit("m", "normal")
        assert adm.describe()["m"]["budget"] == 3


# ---------------------------------------------------------------------------
# the session: priority predicts and decoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_session_decode_and_priority_predict(pkg):
    S = _serving(pkg)
    net = _mlp(pkg, seed=13)
    sess = _session(pkg, admission=S.AdmissionController(default_budget=4))
    sess.register("pm", net, example_shape=(6,),
                  ladder=S.BucketLadder((1,)), warmup=True)
    x = np.zeros((6,), np.float32)
    sess.predict("pm", x, priority="high", timeout=10.0)
    sess.register_decoder("dm", _xf(pkg))
    toks = sess.decode("dm", [1, 2], 4, timeout=60.0)
    assert len(toks) == 4
    sess.close()


def test_session_decode_matches_jax():
    outs = {}
    for pkg in PKGS:
        sess = _session(pkg)
        jm = _xf("jax")
        model = jm if pkg == "jax" else port_serving.TransformerDecodeModel(
            _port_params(jm.params), n_heads=2, max_slots=2, page=4,
            device="cpu")
        sess.register_decoder("dm", model)
        outs[pkg] = [sess.decode("dm", p, 6, timeout=60.0)
                     for p in ([1, 2], [5, 9, 3, 3], [15])]
        sess.close()
    assert outs["jax"] == outs["torch"]


def _port_params(jax_params):
    import jax

    from deeplearning4j_tpu_torch.utils.convert import (
        bert_params_from_numpy)

    return bert_params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a).copy(), jax_params),
        "cpu")


@pytest.mark.parametrize("pkg", PKGS)
def test_decode_is_shed_and_its_ticket_released(pkg):
    S = _serving(pkg)
    sess = _session(pkg, admission=S.AdmissionController(default_budget=2))
    sess.register_decoder("dm", _xf(pkg))
    held = sess.admission.admit("dm", "high")
    with pytest.raises(S.ShedError):          # batch: 1 >= 2*0.5
        sess.decode("dm", [1, 2], 3, priority="batch", timeout=30.0)
    assert sess.admission.describe()["dm"]["standing"] == 1
    timing = {}
    toks = sess.decode("dm", [1, 2], 3, priority="high", timeout=30.0,
                       timing=timing)
    assert len(toks) == 3 and timing["ttft"] > 0
    held.release()
    deadline = 50
    while sess.admission.describe()["dm"]["standing"] and deadline:
        threading.Event().wait(0.02)   # the done-callback runs last
        deadline -= 1
    assert sess.admission.describe()["dm"]["standing"] == 0
    assert "admission" in sess.stats()
    sess.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_unregister_decoder_closes_engine(pkg):
    S = _serving(pkg)
    sess = _session(pkg)
    engine = sess.register_decoder("gone", _xf(pkg))
    assert sess.decoder("gone") is engine
    assert engine._warmed
    sess.unregister_decoder("gone")
    assert engine._closed
    mnf = JaxMNF if pkg == "jax" else ModelNotFound
    with pytest.raises(mnf):
        sess.decoder("gone")
    with pytest.raises(mnf):
        sess.unregister_decoder("gone")
    with pytest.raises(mnf):
        sess.decode("gone", [1], 2)
    sess.close()


@pytest.fixture
def telemetry_on():
    """Telemetry on (memledger claims and flight events need it),
    whatever an earlier test in the process left; restored after."""
    from deeplearning4j_tpu_torch import telemetry

    was = telemetry.enabled(), flight.enabled()
    telemetry.enable()
    flight.enable()
    yield
    (telemetry.enable if was[0] else telemetry.disable)()
    (flight.enable if was[1] else flight.disable)()


def test_unregister_releases_the_pool_claim_and_records_flight(
        telemetry_on):
    memledger.set_ledger(memledger.MemLedger())
    flight.get_recorder().clear()
    sess = _session("torch")
    sess.register_decoder("fl", _xf("torch"))
    led = memledger.get_memledger()
    assert [c.name for c in led.claims("kv_cache")] == ["fl:target"]
    assert led.claims("kv_cache")[0].device == "cpu:0"
    sess.unregister_decoder("fl")
    assert led.claims("kv_cache") == []
    kinds = [e["kind"] for e in flight.get_recorder().events()]
    assert "decoder_registered" in kinds
    assert "decoder_unregistered" in kinds
    sess.register("m", _mlp("torch"), example_shape=(6,), ladder=(1,))
    ev = flight.get_recorder().events("model_registered")
    assert ev and ev[-1]["model"] == "m" and ev[-1]["version"] == 1
    sess.close()


def test_register_decoder_refuses_another_device(monkeypatch):
    import torch

    sess = _session("torch")
    model = _xf("torch")
    monkeypatch.setattr(model, "device", torch.device("meta"))
    with pytest.raises(ValueError, match="lives on"):
        sess.register_decoder("dm", model)
    sess.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_register_decoder_passes_engine_kwargs_and_replaces(pkg):
    sess = _session(pkg)
    first = sess.register_decoder("dv", _xf(pkg), chunk=4,
                                  prefix_cache=True)
    assert first._block.chunk == 4 and first._pcache is not None
    assert len(sess.decode("dv", [1, 2, 3, 4, 5], 3, timeout=60.0)) == 3
    second = sess.register_decoder("dv", _xf(pkg))
    assert first._closed and sess.decoder("dv") is second
    sess.close()
    assert second._closed
