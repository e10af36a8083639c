"""The port's ReplicaSet against the JAX package's.

Modules: ``serving/replica.py`` (ReplicaDeath, Replica, ReplicaSet,
``replica_devices``), the batcher's executor mode and ``run_batch``'s
replica seams, ``Servable.for_device`` and its memory-ledger claim, the
session's ``register(replicas=)``, ``stats`` and ``health_details``, and
``QuantizedServable.for_device``.

- Every case of the reference's ``TestReplicaSet``
  (``tests/test_serving_scale.py``), ``TestTimeoutOutcomeSplit`` and
  ``test_register_with_replicas_serves_and_stats``, the replica cases of
  ``tests/test_tracing.py`` (``TestReplicaFlightIdentity``) and the
  replica claims' lifecycle of ``tests/test_memledger.py``. The scheduler
  cases run on both packages, as cases of one test parametrised by
  package, over a host-side stub servable (y = 2x, scripted deaths and
  delays). The reference places each replica on a device of its own; the
  port places every replica on the model's one device, so the stub tells
  replicas apart by name (``mem_label``, set by the set on both
  packages) where the reference's stub reads the device.
- Served results: a JAX network's weights, carried into the port by
  ``utils/convert.py``, serve through the port's replicas bitwise equal
  to the port's own ``net.output`` at the dispatch's shape (the ladder
  holds one bucket, so every dispatch has one shape) and within 1e-5
  abs/rel of the JAX network's ``output`` on the same rows.
- The reference's zero-recompile assertion becomes the port's rule for
  eager PyTorch: the steady state allocates no staging buffer (their
  ``data_ptr`` is the same before and after a burst).
- The memory ledger holds one ``replica_args`` claim per replica, of the
  staging bytes it owns (the shared weights are not counted again),
  released when the set closes.
- ``cuda``-marked cases run on the card and skip here: the replicas'
  streams differ, and a 4-replica burst is bitwise equal to one replica.

Every set, batcher and session is closed by the test that made it, so no
worker thread outlives its test.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import serving as jax_serving
from deeplearning4j_tpu import telemetry as jax_telemetry
from deeplearning4j_tpu.models.zoo import TextGenerationLSTM as JaxCharRnn
from deeplearning4j_tpu.nn import (
    DenseLayer, LossFunction, MultiLayerNetwork as JaxNet,
    NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu.serving import batcher as jax_batcher
from deeplearning4j_tpu.serving import replica as jax_replica
from deeplearning4j_tpu_torch import serving as port_serving
from deeplearning4j_tpu_torch import telemetry as port_telemetry
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import batcher as port_batcher
from deeplearning4j_tpu_torch.serving import replica as port_replica
from deeplearning4j_tpu_torch.serving.replica import replica_devices
from deeplearning4j_tpu_torch.telemetry import flight as port_flight
from deeplearning4j_tpu_torch.telemetry import memledger as port_memledger
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
from deeplearning4j_tpu_torch.utils.convert import params_from_numpy

PKGS = ["jax", "torch"]
RTOL = ATOL = 1e-5
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# one package's names
# ---------------------------------------------------------------------------

class Api:
    def __init__(self, pkg):
        self.pkg = pkg
        self.S = jax_serving if pkg == "jax" else port_serving
        self.B = jax_batcher if pkg == "jax" else port_batcher
        self.R = jax_replica if pkg == "jax" else port_replica
        self.T = jax_telemetry if pkg == "jax" else port_telemetry

    def devices(self, n):
        """n replica devices: the reference's first n devices, the
        port's one device n times."""
        if self.pkg == "jax":
            import jax

            return jax.devices()[:n]
        return replica_devices(n, "cpu")

    def stub(self, example_shape=(2,), delay=0.0):
        base = self.S.Servable
        kw = {} if self.pkg == "jax" else {"device": "cpu"}
        cls = type("StubServable", (_StubMixin, base), {})
        return cls(example_shape, delay, self.R.ReplicaDeath, **kw)

    def session(self, **kw):
        if self.pkg == "torch":
            kw.setdefault("device", "cpu")
        return self.S.InferenceSession(**kw)

    def counter(self, name, **labels):
        fam = self.T.get_registry().counter(
            name, labelnames=tuple(labels) if labels else ())
        return fam.labels(**labels) if labels else fam


class _StubMixin:
    """Host-side servable with per-clone controls shared through one
    mutable plan (copy.copy in for_device keeps the refs): y = 2x, an
    optional per-replica delay, and scripted ReplicaDeath injections:
    `die_next` N makes the next N infer calls die, wherever the scheduler
    happened to place them. Replicas are named by ``mem_label``."""

    def __init__(self, example_shape, delay, death, **kw):
        super().__init__(example_shape, **kw)
        self.delay = delay
        self.death = death
        self.plan = {"die_next": 0, "calls": [], "delays": {}}

    def warmup(self, ladder):
        return []

    def where(self):
        return str(self.mem_label)

    def infer(self, x):
        who = self.where()
        self.plan["calls"].append(who)
        if self.plan["die_next"] > 0:
            self.plan["die_next"] -= 1
            raise self.death(f"injected death on {who}")
        if who == self.plan.get("broken"):
            raise RuntimeError("device lost")
        d = self.plan["delays"].get(who, self.delay)
        if d:
            time.sleep(d)
        return np.asarray(x) * 2.0


def _entry(api, sv, ladder=(1, 4, 8)):
    reg = api.S.ModelRegistry()
    return reg.register("stub", sv, ladder=api.S.BucketLadder(ladder))


@pytest.fixture(params=PKGS)
def api(request):
    return Api(request.param)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def fresh_ledger():
    prev = port_memledger.set_ledger(port_memledger.MemLedger())
    yield port_memledger.get_memledger()
    port_memledger.set_ledger(prev)


def _mlp_pair(seed=1, n_in=6, n_out=3):
    """(JAX MLP, the port's MLP on the CPU with its weights)."""
    conf = (NeuralNetConfiguration.Builder().seed(seed).list()
            .layer(DenseLayer.Builder().nIn(n_in).nOut(16)
                   .activation("tanh").build())
            .layer(OutputLayer.Builder().nOut(n_out).activation("softmax")
                   .lossFunction(LossFunction.MCXENT).build())
            .build())
    jnet = JaxNet(conf).init()
    return jnet, _port_of(jnet)


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    arrays = [{k: np.asarray(v) for k, v in p.items()}
              for p in jnet._params]
    return MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, arrays, "cpu"))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the reference's TestReplicaSet, on both packages
# ---------------------------------------------------------------------------

class TestReplicaSet:
    def test_routes_least_loaded_and_completes(self, api):
        entry = _entry(api, api.stub(delay=0.03), ladder=(2,))
        rset = api.R.ReplicaSet(entry, n_replicas=3,
                                devices=api.devices(3), warmup=False)
        b = api.B.DynamicBatcher(entry, max_latency=0.0, executor=rset)
        try:
            x = np.ones((2, 2), np.float32)
            futs = [b.submit(x, timeout=10.0) for _ in range(12)]
            for f in futs:
                np.testing.assert_array_equal(f.result(timeout=10.0),
                                              x * 2)
            # the backlog spread over more than one replica
            assert len(set(entry.servable.plan["calls"])) >= 2
        finally:
            b.close()

    def test_replica_death_requeues_not_loses(self, api):
        sv = api.stub()
        entry = _entry(api, sv)
        sv.plan["die_next"] = 1
        rset = api.R.ReplicaSet(entry, devices=api.devices(3),
                                warmup=False)
        b = api.B.DynamicBatcher(entry, max_latency=0.0, executor=rset)
        try:
            x = np.ones((2, 2), np.float32)
            futs = [b.submit(x, timeout=10.0) for _ in range(8)]
            for f in futs:
                np.testing.assert_array_equal(f.result(timeout=10.0),
                                              x * 2)
            dead = [r for r in rset.replicas if r.dead]
            assert len(dead) == 1
            # the dead replica is the one that took the first call
            assert dead[0].name == sv.plan["calls"][0]
            np.testing.assert_array_equal(
                b.submit(x, timeout=10.0).result(timeout=10.0), x * 2)
        finally:
            b.close()

    def test_all_replicas_dead_fails_requests(self, api):
        sv = api.stub()
        entry = _entry(api, sv)
        sv.plan["die_next"] = 10 ** 6       # every call dies
        rset = api.R.ReplicaSet(entry, devices=api.devices(2),
                                warmup=False)
        b = api.B.DynamicBatcher(entry, max_latency=0.0, executor=rset)
        try:
            x = np.ones((1, 2), np.float32)
            with pytest.raises(api.R.ReplicaDeath):
                b.submit(x, timeout=5.0).result(timeout=5.0)
            assert all(r.dead for r in rset.replicas)
            with pytest.raises(api.R.ReplicaDeath):
                b.submit(x, timeout=5.0).result(timeout=5.0)
        finally:
            b.close()

    def test_error_breaker_kills_black_hole_replica(self, api):
        sv = api.stub()
        entry = _entry(api, sv, ladder=(2,))
        rset = api.R.ReplicaSet(entry, devices=api.devices(2),
                                warmup=False)
        b = api.B.DynamicBatcher(entry, max_latency=0.0, executor=rset)
        try:
            x = np.ones((2, 2), np.float32)
            b.submit(x, timeout=10.0).result(timeout=10.0)
            sv.plan["broken"] = sv.plan["calls"][0]
            deadline = time.perf_counter() + 20.0
            while not any(r.dead for r in rset.replicas):
                assert time.perf_counter() < deadline, \
                    "breaker never fired"
                f = b.submit(x, timeout=10.0)
                try:
                    f.result(timeout=10.0)
                except RuntimeError:
                    pass
            for _ in range(4):
                np.testing.assert_array_equal(
                    b.submit(x, timeout=10.0).result(timeout=10.0), x * 2)
            dead = [r for r in rset.replicas if r.dead]
            assert len(dead) == 1 and dead[0].name == sv.plan["broken"]
        finally:
            b.close()

    def test_steal_drains_wedged_replica(self, api):
        sv = api.stub()
        entry = _entry(api, sv, ladder=(2,))
        sv.plan["delays"] = {"r0": 0.25}
        inst = api.T.serving_instruments("stub")
        steals0 = api.counter("dl4j_serving_steals_total",
                              model="stub").value
        rset = api.R.ReplicaSet(entry, devices=api.devices(3),
                                warmup=False, instruments=inst)
        try:
            x = np.ones((2, 2), np.float32)
            reqs = [api.B._Request(x, deadline=time.perf_counter() + 10.0,
                                   model="stub") for _ in range(6)]
            with rset._lock:
                for r in reqs:
                    rset.replicas[0].queue.append(
                        api.R._BatchTask([r], inst))
                rset._work.notify_all()
            for r in reqs:
                np.testing.assert_array_equal(
                    r.future.result(timeout=10.0), x * 2)
            assert api.counter("dl4j_serving_steals_total",
                               model="stub").value > steals0
        finally:
            rset.close()

    def test_retire_drains_all_replicas(self, api):
        sv = api.stub(delay=0.03)
        entry = _entry(api, sv, ladder=(2,))
        rset = api.R.ReplicaSet(entry, devices=api.devices(2),
                                warmup=False)
        b = api.B.DynamicBatcher(entry, max_latency=0.0, executor=rset)
        x = np.ones((2, 2), np.float32)
        futs = [b.submit(x, timeout=30.0) for _ in range(10)]
        b.retire(timeout=20.0)
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=1.0), x * 2)
        assert all(not r.is_alive() for r in rset.replicas)

    def test_bounded_replica_queues_backpressure_to_429(self, api):
        sv = api.stub(delay=0.2)
        entry = _entry(api, sv, ladder=(1,))
        rset = api.R.ReplicaSet(entry, devices=api.devices(1),
                                warmup=False, max_queued=1)
        b = api.B.DynamicBatcher(entry, max_latency=0.0, queue_size=2,
                                 executor=rset)
        try:
            x = np.ones((1, 2), np.float32)
            futs = []
            with pytest.raises(api.B.QueueFullError):
                for _ in range(8):
                    futs.append(b.submit(x, timeout=30.0))
            for f in futs[:2]:
                np.testing.assert_array_equal(f.result(timeout=30.0),
                                              x * 2)
        finally:
            b.close()

    def test_replica_results_bit_identical_and_no_steady_allocation(self):
        """Real network: every port replica's answer equals the port's
        own output at the dispatch's shape bit for bit, and the JAX
        network's within 1e-5; the steady state allocates no staging
        buffer (the port's counterpart of zero recompiles)."""
        jnet, net = _mlp_pair(seed=9)
        reg = port_serving.ModelRegistry()
        entry = reg.register("net", net, example_shape=(6,),
                             ladder=port_serving.BucketLadder((1,)),
                             warmup=True)
        X = np.random.default_rng(3).normal(size=(4, 6)) \
            .astype(np.float32)
        y_port = np.concatenate([net.output(X[i:i + 1]).toNumpy()
                                 for i in range(4)])
        y_jax = jnet.output(X).toNumpy()
        rset = port_serving.ReplicaSet(entry, n_replicas=4)
        b = port_serving.DynamicBatcher(entry, max_latency=0.01,
                                        executor=rset)
        try:
            ptrs = {r.name: {s: t.data_ptr() for s, t in
                             r.servable._staging.items()}
                    for r in rset.replicas}
            assert all(ptrs.values())   # warmed: each staged its shape
            futs = [b.submit(X[i % 4:i % 4 + 1], timeout=10.0)
                    for i in range(24)]
            for i, f in enumerate(futs):
                y = f.result(timeout=10.0)
                np.testing.assert_array_equal(y, y_port[i % 4:i % 4 + 1])
                _close(y, y_jax[i % 4:i % 4 + 1])
            assert {r.name: {s: t.data_ptr() for s, t in
                             r.servable._staging.items()}
                    for r in rset.replicas} == ptrs
        finally:
            b.close()

    def test_replica_devices_helper(self):
        assert replica_devices(device="cpu") == [CPU]
        assert replica_devices(3, "cpu") == [CPU] * 3
        assert replica_devices(None, "cpu", devices=["cpu", "cpu"]) == \
            [CPU] * 2
        with pytest.raises(ValueError):
            replica_devices(0, "cpu")
        # the North star is one card: another device is refused
        with pytest.raises(ValueError, match="one card"):
            replica_devices(2, "cpu", devices=["cpu", "meta"])
        sv = port_serving.FnServable(lambda x: x, (2,), device="cpu")
        with pytest.raises(ValueError, match="one device"):
            sv.for_device("meta")


class TestTimeoutOutcomeSplit:
    def test_mid_execute_timeout_distinct_from_queued(self, api):
        sess = api.session(max_latency=0.0, queue_size=8)
        try:
            sess.register("texec", api.stub(delay=0.3),
                          ladder=api.S.BucketLadder((1,)))
            x = np.zeros((1, 2), np.float32)
            t0 = api.counter("dl4j_serving_requests_total", model="texec",
                             outcome="timeout_execute").value
            f = sess.predict_async("texec", x, timeout=0.1)
            with pytest.raises(api.S.ServingTimeout):
                f.result(timeout=5.0)
            assert api.counter("dl4j_serving_requests_total",
                               model="texec",
                               outcome="timeout_execute").value == t0 + 1
        finally:
            sess.close()


class TestSessionIntegration:
    def test_register_with_replicas_serves_and_stats(self):
        jnet, net = _mlp_pair(seed=12)
        X = np.random.default_rng(0).normal(size=(3, 6)) \
            .astype(np.float32)
        y_jax = jnet.output(X).toNumpy()
        y_port = np.concatenate([net.output(X[i:i + 1]).toNumpy()
                                 for i in range(3)])
        sess = port_serving.InferenceSession(max_latency=0.01,
                                             device="cpu")
        try:
            sess.register("rep", net, example_shape=(6,),
                          ladder=port_serving.BucketLadder((1, 4)),
                          warmup=True, replicas=2)
            outs = [sess.predict("rep", X[i], timeout=10.0)
                    for i in range(3)]
            for i, y in enumerate(outs):
                np.testing.assert_array_equal(y, y_port[i])
                _close(y, y_jax[i])
            stats = sess.stats()["rep:v1"]
            assert set(stats["replicas"]) == {"r0", "r1"}
            assert all(row["device"] == "cpu"
                       for row in stats["replicas"].values())
        finally:
            sess.close()

    def test_replicas_refuse_another_device(self):
        _, net = _mlp_pair(seed=13)
        with port_serving.InferenceSession(device="cpu") as sess:
            with pytest.raises(ValueError, match="one card"):
                sess.register("rep", net, example_shape=(6,),
                              ladder=(1,), warmup=True,
                              devices=["cpu", "meta"])

    def test_char_rnn_replicas_match_jax(self):
        """The char-RNN (LSTM layers on the plain version here) through 3
        replicas: sequence padding and coalescing as without replicas,
        every answer within 1e-5 of the JAX net's."""
        jnet = JaxCharRnn(vocabSize=9, hidden=16, seqLength=12).init()
        net = _port_of(jnet)
        rng = np.random.default_rng(5)
        xs = [np.eye(9, dtype=np.float32)[
            rng.integers(0, 9, size=(n, t))].transpose(0, 2, 1).copy()
            for n, t in ((1, 12), (3, 12), (2, 7), (4, 12), (1, 5))]
        with port_serving.InferenceSession(device="cpu",
                                           max_latency=0.01) as sess:
            sess.register("c", net, example_shape=(9, 12),
                          ladder=port_serving.BucketLadder(
                              (1, 2, 4), seq_lengths=(8, 12)),
                          warmup=True, replicas=3)
            futs = [sess.predict_async("c", x) for x in xs]
            for x, f in zip(xs, futs):
                y = f.result(timeout=30)
                assert y.shape == x.shape
                _close(y, jnet.output(x).toNumpy())

    def test_int8_quantized_servable_through_two_replicas(self):
        """An int8 QuantizedServable rides the replica path: its clones
        share the quantized payload and answer as the servable itself
        does, bit for bit."""
        from deeplearning4j_tpu_torch.precision import quantize

        _, net = _mlp_pair(seed=14)
        X = np.random.default_rng(7).normal(size=(5, 6)) \
            .astype(np.float32)
        q = quantize(net, [X], example_shape=(6,), device="cpu")
        want = np.concatenate([q.infer(X[i:i + 1]) for i in range(5)])
        clone = q.for_device("cpu")
        assert clone._qparams is q._qparams      # the payload is shared
        with port_serving.InferenceSession(device="cpu") as sess:
            sess.register("q8", q, ladder=(1,), warmup=True, replicas=2)
            got = [sess.predict("q8", X[i], timeout=10.0)
                   for i in range(5)]
            np.testing.assert_array_equal(np.stack(got), want)
            assert set(sess.stats()["q8:v1"]["replicas"]) == {"r0", "r1"}


# ---------------------------------------------------------------------------
# replica incidents carry identity (the reference's tests/test_tracing.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def traced():
    """A fresh tracer and registry on the port, sampling every trace."""
    from deeplearning4j_tpu_torch.telemetry import tracing

    reg = MetricsRegistry()
    prev_reg = port_telemetry.set_registry(reg)
    tr = tracing.Tracer()
    prev_tr = tracing.set_tracer(tr)
    was = port_telemetry.enabled()
    port_telemetry.enable()
    tracing.configure(enabled=True, sample_rate=1.0)
    yield tr, reg
    tracing.set_tracer(prev_tr)
    port_telemetry.set_registry(prev_reg)
    (port_telemetry.enable if was else port_telemetry.disable)()
    tracing.configure(enabled=True, sample_rate=0.01)


class TestReplicaFlightIdentity:
    def test_steal_event_names_thief_victim_and_trace(self, traced):
        from deeplearning4j_tpu_torch.telemetry import tracing

        rec = port_flight.get_recorder()
        rec.clear()
        _, net = _mlp_pair(seed=7, n_in=16, n_out=4)
        registry = port_serving.ModelRegistry()
        entry = registry.register("m", net, example_shape=(16,),
                                  ladder=port_serving.BucketLadder((1, 4)),
                                  warmup=True)
        rset = port_serving.ReplicaSet(entry, n_replicas=2, warmup=False)
        try:
            with tracing.start_trace("client") as root:
                req = port_batcher._Request(
                    np.zeros((1, 16), np.float32), None, model="m",
                    trace=tracing.current())
            rset._run_task(rset.replicas[0],
                           port_replica._BatchTask([req], None),
                           stolen="r1")
            assert req.future.result(timeout=5) is not None
            steals = rec.events("steal")
            assert steals, "a stolen batch must record a steal event"
            ev = steals[-1]
            assert (ev["model"], ev["replica"], ev["victim"]) == \
                ("m", "r0", "r1")
            assert ev["trace_id"] == root.trace_id
        finally:
            rset.close()

    def test_dead_replica_degrades_health_details(self, traced):
        _, net = _mlp_pair(seed=7, n_in=16, n_out=4)
        session = port_serving.InferenceSession(device="cpu")
        try:
            session.register("m", net, example_shape=(16,),
                             ladder=port_serving.BucketLadder((1, 4)),
                             warmup=True, replicas=2)
            session.predict("m", np.zeros((1, 16), np.float32))
            row = session.health_details()["replica_sets"]["m:v1"]
            assert not row["degraded"] and row["live"] == 2
            assert row["streams"] == {"r0": None, "r1": None}
            assert all(v > 0 for v in row["staging_bytes"].values())
            b = session._batchers[("m", 1)]
            b.executor.replicas[0].dead = True
            row = session.health_details()["replica_sets"]["m:v1"]
            assert row["degraded"]
            assert row["dead"] == ["r0"] and row["live"] == 1
        finally:
            session.close()


# ---------------------------------------------------------------------------
# the memory ledger's replica claims (the reference's tests/test_memledger.py)
# ---------------------------------------------------------------------------

def test_replica_args_claims_lifecycle(fresh_ledger):
    """One claim per replica, of the staging bytes it owns (every ladder
    shape's input, float32): the shared weights are not counted again.
    Closing the session releases them."""
    _, net = _mlp_pair(seed=6, n_in=4, n_out=2)
    session = port_serving.InferenceSession(device="cpu")
    session.register("memrep", net, example_shape=(4,), ladder=[1, 2],
                     replicas=2, warmup=True)
    y = session.predict("memrep", np.zeros((1, 4), np.float32))
    assert y.shape == (1, 2)
    claims = fresh_ledger.claims("replica_args")
    assert sorted(c.name for c in claims) == [
        "memrep:v1@cpu:0:r0", "memrep:v1@cpu:0:r1"]
    assert all(c.bytes == (1 + 2) * 4 * 4 for c in claims)
    assert all(c.meta["shares_params"] for c in claims)
    session.close()
    assert fresh_ledger.claims("replica_args") == []


def test_warmup_records_flight_and_plans_capacity(fresh_ledger):
    """The registry's entry hooks: a finished warmup is a flight
    ``model_warmup`` record, and under a known capacity the ladder's
    estimate (by "meta" tensors) is judged before the first warm run:
    a budget it cannot fit refuses the registration."""
    rec = port_flight.get_recorder()
    rec.clear()
    _, net = _mlp_pair(seed=8, n_in=4, n_out=2)
    sv = port_serving.as_servable(net, (4,))
    est = port_serving.servable.estimate_warmup_bytes(
        sv, port_serving.BucketLadder((1, 2)))
    assert est["buckets"] == {"1x4": (4 + 2) * 4, "2x4": (8 + 4) * 4}
    assert est["param_bytes"] == (4 * 16 + 16 + 16 * 2 + 2) * 4
    reg = port_serving.ModelRegistry()
    reg.register("w", net, example_shape=(4,), ladder=(1, 2), warmup=True)
    assert rec.events("model_warmup")[-1]["model"] == "w"
    port_memledger.configure(budget_bytes=16)
    try:
        with pytest.raises(port_memledger.CapacityError):
            reg.register("w2", net, example_shape=(4,), ladder=(1, 2),
                         warmup=True)
        with pytest.raises(port_serving.ModelNotFound):
            reg.get("w2")
    finally:
        port_memledger.configure(budget_bytes=None)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_replica_streams_differ_on_the_card(cuda):
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM

    net = TextGenerationLSTM(vocabSize=9, hidden=16, seqLength=12).init()
    with port_serving.InferenceSession() as sess:
        sess.register("s", net, example_shape=(9, 12), ladder=(1, 2),
                      warmup=True, replicas=3)
        b = sess._batchers[("s", 1)]
        streams = [r.servable.stream for r in b.executor.replicas]
        assert all(s is not None for s in streams)
        ids = {s.cuda_stream for s in streams}
        assert len(ids) == 3
        assert torch.cuda.current_stream().cuda_stream not in ids
        row = sess.health_details()["replica_sets"]["s:v1"]
        assert set(row["streams"].values()) == ids


@pytest.mark.cuda
def test_four_replica_burst_bitwise_equals_one_replica_on_the_card(cuda):
    """Single-row requests over a one-bucket ladder: every dispatch has
    the same shape, so each answer is bitwise the single replica's."""
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM

    net = TextGenerationLSTM(vocabSize=9, hidden=16, seqLength=12).init()
    rng = np.random.default_rng(11)
    xs = [np.eye(9, dtype=np.float32)[rng.integers(0, 9, size=(1, 12))]
          .transpose(0, 2, 1).copy() for _ in range(32)]
    answers = {}
    for n in (None, 4):
        with port_serving.InferenceSession(max_latency=0.0) as sess:
            sess.register("c", net, example_shape=(9, 12), ladder=(1,),
                          warmup=True, replicas=n)
            futs = [sess.predict_async("c", x) for x in xs]
            answers[n] = [f.result(timeout=60) for f in futs]
    for a, b in zip(answers[None], answers[4]):
        np.testing.assert_array_equal(a, b)
