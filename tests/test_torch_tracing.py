"""The port's tracing, serving instruments and decode spans against the
JAX package's.

Modules: ``telemetry/tracing.py`` (whole), ``telemetry/registry.py``'s
``ServingInstruments``, the batcher's, session's, admission's and decode
engine's tracing emits and instruments.

- The reference's ``TestTracingCore``, ``TestDecodeTrace``,
  ``TestDisabledContract`` (its serving and decode parts) and
  ``TestTraceExport`` (``tests/test_tracing.py``) run on both packages,
  as cases of one test parametrised by package. The reference reads the
  wedged engine through ``telemetry.health.healthz``, which the port has
  not ported yet (ROADMAP.md, queue 1 item 13); both packages are read
  through ``InferenceSession.health_details()``, the section it builds.
- The serving span tree: a sampled predict through a 2-replica session
  yields ``serving.admission``, ``serving.queue_wait``,
  ``serving.coalesce``, ``serving.replica_queue`` and ``serving.execute``
  under the client's root on both packages, the queue-wait and execute
  histograms carry the trace id as an exemplar, and a shed names its
  trace in the flight recorder.
- The decode tests the decode slice held back
  (``tests/test_decode_v2.py``: ``test_ttft_histogram_records``,
  ``test_session_health_details_and_kwargs_passthrough``) on both
  packages, with the same weights (the JAX package's ``init_params``,
  carried into the port by ``utils/convert.py``) and equal token streams.
- The disabled contract: with telemetry disabled a counting stub tracer
  sees zero calls through a replica session's predicts and a decode, and
  the answers are bitwise those of the enabled run.
"""

from __future__ import annotations

import json
import pickle
import threading
import time

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import serving as jax_serving
from deeplearning4j_tpu import telemetry as jax_telemetry
from deeplearning4j_tpu.models.bert import (
    BertConfig as JaxBertConfig, init_params as jax_bert_init)
from deeplearning4j_tpu.nn import (
    DenseLayer, LossFunction, MultiLayerNetwork as JaxNet,
    NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu.telemetry import flight as jax_flight
from deeplearning4j_tpu.telemetry import tracing as jax_tracing
from deeplearning4j_tpu.telemetry.registry import (
    MetricsRegistry as JaxMetricsRegistry)
from deeplearning4j_tpu_torch import serving as port_serving
from deeplearning4j_tpu_torch import telemetry as port_telemetry
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.telemetry import flight as port_flight
from deeplearning4j_tpu_torch.telemetry import prometheus
from deeplearning4j_tpu_torch.telemetry import tracing as port_tracing
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
from deeplearning4j_tpu_torch.utils.convert import (
    bert_params_from_numpy, params_from_numpy)

PKGS = ["jax", "torch"]


class Api:
    def __init__(self, pkg):
        self.pkg = pkg
        jx = pkg == "jax"
        self.S = jax_serving if jx else port_serving
        self.T = jax_telemetry if jx else port_telemetry
        self.tracing = jax_tracing if jx else port_tracing
        self.flight = jax_flight if jx else port_flight
        self.Registry = JaxMetricsRegistry if jx else MetricsRegistry

    def session(self, **kw):
        if self.pkg == "torch":
            kw.setdefault("device", "cpu")
        return self.S.InferenceSession(**kw)

    def mlp(self, seed=7):
        jnet = _jax_mlp(seed)
        return jnet if self.pkg == "jax" else _port_of(jnet)

    def xf(self, seed=0, vocab=32, hidden=16, n_layers=1, n_heads=2,
           max_len=64, **geom):
        p = _jax_bert_params(vocab, hidden, n_layers, n_heads, max_len,
                             seed)
        if self.pkg == "jax":
            params = jax.tree_util.tree_map(jax.numpy.asarray, p)
            return self.S.TransformerDecodeModel(params, n_heads=n_heads,
                                                 **geom)
        return self.S.TransformerDecodeModel(
            bert_params_from_numpy(p, "cpu"), n_heads=n_heads,
            device="cpu", **geom)


def _jax_mlp(seed, n_in=16, n_out=4):
    conf = (NeuralNetConfiguration.Builder().seed(seed).list()
            .layer(DenseLayer.Builder().nIn(n_in).nOut(8)
                   .activation("relu").build())
            .layer(OutputLayer.Builder().nOut(n_out).activation("softmax")
                   .lossFunction(LossFunction.MCXENT).build())
            .build())
    return JaxNet(conf).init()


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    arrays = [{k: np.asarray(v).copy() for k, v in p.items()}
              for p in jnet._params]
    return MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, arrays, "cpu"))


_BERT = {}


def _jax_bert_params(vocab, hidden, n_layers, n_heads, max_len, seed):
    key = (vocab, hidden, n_layers, n_heads, max_len, seed)
    if key not in _BERT:
        cfg = JaxBertConfig(vocab_size=vocab, hidden=hidden,
                            num_layers=n_layers, num_heads=n_heads,
                            ffn=4 * hidden, max_len=max_len)
        _BERT[key] = jax.tree_util.tree_map(
            lambda a: np.array(a, np.float32),
            jax_bert_init(cfg, jax.random.key(seed)))
    return _BERT[key]


@pytest.fixture(params=PKGS)
def api(request):
    return Api(request.param)


@pytest.fixture
def traced(api):
    """A fresh tracer and registry in ``api``'s package, sampling every
    trace; restores the process state (the 1-in-100 sampler) after."""
    reg = api.Registry()
    prev_reg = api.T.set_registry(reg)
    tr = api.tracing.Tracer()
    prev_tr = api.tracing.set_tracer(tr)
    was = api.T.enabled()
    api.T.enable()
    api.tracing.configure(enabled=True, sample_rate=1.0)
    yield tr, reg
    api.tracing.set_tracer(prev_tr)
    api.T.set_registry(prev_reg)
    (api.T.enable if was else api.T.disable)()
    api.tracing.configure(enabled=True, sample_rate=0.01)


def _tree_connected(spans):
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if s["parent_id"] not in by_id]
    orphans = [s for s in spans
               if s["parent_id"] is not None and s["parent_id"] not in by_id]
    return len(roots) == 1 and not orphans, roots


# ---------------------------------------------------------------------------
# core: ids, traceparent, sampling, ring
# ---------------------------------------------------------------------------

class TestTracingCore:
    def test_traceparent_roundtrip(self, api, traced):
        span = api.tracing.start_trace("t")
        hdr = span.traceparent()
        tid, sid, sampled = api.tracing.parse_traceparent(hdr)
        assert (tid, sid, sampled) == (span.trace_id, span.span_id, True)

    @pytest.mark.parametrize("bad", [
        None, "", "garbage", "00-zz-11-01", "00-" + "0" * 32 + "-" +
        "1" * 16 + "-01", "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
        "00-" + "a" * 32 + "-" + "0" * 16 + "-01"])
    def test_malformed_traceparent_rejected(self, api, bad):
        assert api.tracing.parse_traceparent(bad) is None

    def test_upstream_unsampled_flag_wins(self, api, traced):
        hdr = "00-" + "a" * 32 + "-" + "b" * 16 + "-00"
        assert api.tracing.start_trace("t", traceparent=hdr) is None

    def test_upstream_sampled_joins_trace(self, api, traced):
        hdr = "00-" + "A" * 32 + "-" + "b" * 16 + "-01"
        span = api.tracing.start_trace("t", traceparent=hdr)
        assert span.trace_id == "a" * 32
        assert span.parent_id == "b" * 16

    def test_head_sampler_interval(self, api, traced):
        api.tracing.configure(sample_rate=0.25)
        kept = [api.tracing.start_trace("t") is not None
                for _ in range(40)]
        assert sum(kept) == 10   # deterministic 1-in-4 counter
        api.tracing.configure(sample_rate=0.0)
        assert api.tracing.start_trace("t") is None
        assert api.tracing.sample_interval() == 0

    def test_ring_bounded(self, api, traced):
        tr, _ = traced
        tr.resize(8)
        for i in range(20):
            tr.emit(f"s{i}", "t" * 32, None, 0.0, 1.0)
        assert len(tr) == 8
        assert [s["name"] for s in tr.spans()] == \
            [f"s{i}" for i in range(12, 20)]
        api.tracing.configure(capacity=4)
        assert len(tr) == 4 and tr.capacity == 4

    def test_span_context_manager_sets_current(self, api, traced):
        t = api.tracing
        assert t.current() is None
        with t.start_trace("outer") as outer:
            ctx = t.current()
            assert ctx.trace_id == outer.trace_id
            with t.span("inner") as inner:
                assert inner.parent_id == outer.span_id
            with t.trace_or_span("nested") as nested:
                assert nested.parent_id == outer.span_id
        assert t.current() is None
        assert t.span("orphan") is t.NULL and not t.NULL
        tr, _ = traced
        assert [s["name"] for s in tr.spans()] == ["inner", "nested",
                                                   "outer"]

    def test_error_status_on_raise(self, api, traced):
        tr, _ = traced
        with pytest.raises(ValueError):
            with api.tracing.start_trace("boom"):
                raise ValueError("nope")
        rec = tr.spans()[-1]
        assert rec["status"] == "error"
        assert "ValueError" in rec["attrs"]["error"]

    def test_span_context_pickles_and_use(self, api, traced):
        t = api.tracing
        ctx = t.SpanContext("a" * 32, "b" * 16)
        back = pickle.loads(pickle.dumps(ctx))
        assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
        with t.use(("c" * 32, "d" * 16)) as got:
            assert t.current_ids() == ("c" * 32, "d" * 16)
            assert t.emit("child", got, 1.0, 2.0, k=1) is not None
        assert t.current() is None
        tr, _ = traced
        rec = tr.spans()[-1]
        assert (rec["name"], rec["parent_id"], rec["attrs"]) == \
            ("child", "d" * 16, {"k": 1})
        sid = t.ingest({"name": "w", "trace_id": "c" * 32,
                        "parent_id": "d" * 16, "start": 1.0, "end": 2.0})
        assert sid is not None and tr.spans()[-1]["name"] == "w"
        assert t.ingest({"name": "bad"}) is None

    def test_records_have_the_reference_keys(self, traced):
        """One span of each package: the same record keys and values
        (ids aside)."""
        recs = {}
        for pkg in PKGS:
            t = Api(pkg).tracing
            prev = t.set_tracer(t.Tracer())
            try:
                t.configure(sample_rate=1.0)
                with t.start_trace("r", k="v"):
                    pass
                recs[pkg] = t.get_tracer().spans()[-1]
            finally:
                t.set_tracer(prev)
                t.configure(sample_rate=0.01)
        assert set(recs["jax"]) == set(recs["torch"])
        for k in ("name", "parent_id", "status", "attrs"):
            assert recs["jax"][k] == recs["torch"][k]


# ---------------------------------------------------------------------------
# serving: the span tree, exemplars, the shed's flight record
# ---------------------------------------------------------------------------

SERVING_SPANS = ["serving.admission", "serving.coalesce",
                 "serving.execute", "serving.queue_wait",
                 "serving.replica_queue"]


class TestServingTrace:
    def test_sampled_predict_is_one_connected_tree(self, api, traced):
        tr, reg = traced
        net = api.mlp()
        sess = api.session(
            admission=api.S.AdmissionController(default_budget=8))
        try:
            sess.register("m", net, example_shape=(16,),
                          ladder=api.S.BucketLadder((1, 4)), warmup=True,
                          replicas=2)
            x = np.random.default_rng(0).normal(size=(3, 16)).astype(
                np.float32)
            root = api.tracing.start_trace("client.predict")
            with root:
                timing = {}
                y = sess.predict("m", x, timing=timing)
            assert y.shape == (3, 4)
            assert set(timing) == {"queue", "execute"}
            spans = tr.spans(root.trace_id)
            ok, roots = _tree_connected(spans)
            assert ok and roots[0]["span_id"] == root.span_id
            assert sorted(s["name"] for s in spans
                          if s is not roots[0]) == SERVING_SPANS
            ex = [s for s in spans if s["name"] == "serving.execute"][0]
            assert ex["attrs"]["batch_rows"] == 3
            assert ex["attrs"]["replica"] in ("r0", "r1")
            # the latency histograms link their buckets to the trace
            for fam in ("dl4j_serving_queue_wait_seconds",
                        "dl4j_serving_execute_seconds"):
                child = reg.histogram(fam, labelnames=("model",)).labels(
                    model="m")
                assert root.trace_id in {e[0] for e in
                                         child.exemplars.values()}
        finally:
            sess.close()

    def test_serving_instruments_count_requests(self, api, traced):
        """The serving families count a burst through replicas the same
        way on both packages: requests by outcome, dispatches, queue-wait
        and execute observations, the replica-load gauges."""
        _, reg = traced
        net = api.mlp(seed=3)
        sess = api.session(max_latency=0.0)
        try:
            sess.register("m", net, example_shape=(16,),
                          ladder=api.S.BucketLadder((1,)), warmup=True,
                          replicas=2)
            x = np.zeros((1, 16), np.float32)
            for _ in range(6):
                sess.predict("m", x)
            sess.predict("m", x, batched=False)
            snap = reg.snapshot()
        finally:
            sess.close()
        assert snap['dl4j_serving_requests_total{model="m",outcome="ok"}'] \
            == 7
        assert snap['dl4j_serving_dispatch_total{model="m"}'] == 7
        assert snap['dl4j_serving_queue_wait_seconds_count{model="m"}'] \
            == 6
        assert snap['dl4j_serving_execute_seconds_count{model="m"}'] == 7
        assert {k for k in snap if k.startswith(
            "dl4j_serving_replica_load")} == {
            'dl4j_serving_replica_load{model="m",replica="r0"}',
            'dl4j_serving_replica_load{model="m",replica="r1"}'}

    def test_shed_flight_event_names_trace(self, api, traced):
        rec = api.flight.get_recorder()
        rec.clear()
        _, reg = traced
        adm = api.S.AdmissionController(default_budget=0)
        sess = api.session(admission=adm)
        held = adm.admit("m")   # the one standing request budget 0 allows
        try:
            sess.register("m", api.mlp(), example_shape=(16,),
                          ladder=api.S.BucketLadder((1,)), warmup=True)
            root = api.tracing.start_trace("client")
            with root:
                with pytest.raises(api.S.ShedError):
                    sess.predict("m", np.zeros((16,), np.float32))
            ev = rec.events("shed")[-1]
            assert (ev["model"], ev["priority"], ev["trace_id"]) == \
                ("m", "normal", root.trace_id)
            snap = reg.snapshot()
            assert snap['dl4j_serving_shed_total{model="m",'
                        'priority="normal"}'] == 1
            assert snap['dl4j_serving_requests_total{model="m",'
                        'outcome="shed"}'] == 1
            spans = [s for s in traced[0].spans(root.trace_id)
                     if s["name"] == "serving.admission"]
            assert spans and spans[0]["status"] == "error"
        finally:
            held.release()
            sess.close()

    def test_render_exposes_serving_families(self, traced):
        """The port's serving families render as Prometheus text with
        the reference's names and help."""
        from deeplearning4j_tpu.telemetry.registry import (
            SERVING_STEALS_HELP)

        reg = MetricsRegistry()
        inst = port_telemetry.ServingInstruments(reg, "m")
        inst.steals.inc()
        inst.replica_load("r0").set(2)
        text = prometheus.render(registry=reg)
        assert f"# HELP dl4j_serving_steals_total {SERVING_STEALS_HELP}" \
            in text
        assert 'dl4j_serving_replica_load{model="m",replica="r0"} 2' in text


# ---------------------------------------------------------------------------
# decode: per-token-boundary child spans, wedge detection
# ---------------------------------------------------------------------------

class TestDecodeTrace:
    def test_boundary_spans(self, api, traced):
        model = api.xf(max_slots=2, page=8, max_pages_per_slot=4)
        eng = api.S.DecodeEngine(model, name="d").warmup()
        try:
            root = api.tracing.start_trace("client.decode")
            with root:
                tokens = eng.decode([1, 2, 3], 5, timeout=60)
            assert len(tokens) == 5
            tr, _ = traced
            spans = [s for s in tr.spans(root.trace_id)
                     if s["span_id"] != root.span_id]
            names = [s["name"] for s in spans]
            # a 3-token prompt prefills over 2 boundaries (the third
            # prompt token's boundary generates), then 5 decode tokens
            assert names.count("decode.prefill") == 2
            assert names.count("decode.token") == 5
            assert names.count("decode.queue") == 1
            assert all(s["parent_id"] == root.span_id for s in spans)
        finally:
            eng.close()

    def test_boundary_span_cap_aggregates_tail(self, api, traced):
        model = api.xf(max_slots=1, page=8, max_pages_per_slot=4)
        eng = api.S.DecodeEngine(model, name="capped").warmup()
        eng.boundary_span_cap = 4
        try:
            root = api.tracing.start_trace("client")
            with root:
                tokens = eng.decode([1, 2], 10, timeout=60)
            assert len(tokens) == 10
            tr, _ = traced
            spans = [s for s in tr.spans(root.trace_id)
                     if s["span_id"] != root.span_id]
            boundary = [s for s in spans
                        if s["name"] in ("decode.prefill",
                                         "decode.token")]
            agg = [s for s in spans if s["name"] == "decode.tokens"]
            assert len(boundary) == 4
            # 1 prefill + 10 decode boundaries total, 4 emitted -> 7
            assert len(agg) == 1 and agg[0]["attrs"]["boundaries"] == 7
        finally:
            eng.close()

    def test_chunk_and_speculate_spans(self, api, traced):
        """Chunked prefill emits ``decode.prefill_chunk`` and speculation
        ``decode.speculate`` spans, the same counts on both packages."""
        model = api.xf(max_len=128, max_slots=2, page=8,
                       max_pages_per_slot=8)
        draft = api.xf(max_len=128, max_slots=2, page=8,
                       max_pages_per_slot=8)
        eng = api.S.DecodeEngine(
            model, name="cs", chunk=4,
            speculative=api.S.SpeculativeConfig(draft, k=2)).warmup()
        try:
            root = api.tracing.start_trace("client")
            with root:
                tokens = eng.decode(list(range(1, 12)), 6, timeout=60)
            assert len(tokens) == 6
            names = [s["name"] for s in traced[0].spans(root.trace_id)]
            # each loop retires a 4-token chunk, then one prompt token
            # through the step boundary: 10 prompt tokens, 2 loops
            assert names.count("decode.prefill_chunk") == 2
            assert names.count("decode.prefill") == 2
            assert names.count("decode.speculate") >= 1
            assert names.count("decode.queue") == 1
        finally:
            eng.close()

    def test_wedged_engine_reports_degraded(self, api, traced):
        release = threading.Event()

        class _BlockingModel:
            uses_pages = False
            page = None
            max_slots = 1
            device = None

            def init_state(self):
                return []

            def reset_slot(self, state, slot):
                return state

            def step(self, state, tokens, pos, table):
                release.wait(10.0)
                return np.zeros(1, np.int32), state

        eng = api.S.DecodeEngine(_BlockingModel(), name="wedgy",
                                 wedge_timeout=0.05)
        session = api.session()
        session.register_decoder("wedgy", eng, warmup=False)
        try:
            eng.submit([1], 1)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                h = eng.health()
                if h["wedged"]:
                    break
                time.sleep(0.02)
            assert h["wedged"] and h["degraded"], h
            dec = session.health_details()["decoders"]["wedgy"]
            assert dec["wedged"] and dec["degraded"]
        finally:
            release.set()
            session.close()

    def test_healthy_engine_not_degraded(self, api, traced):
        model = api.xf(max_slots=2, page=8, max_pages_per_slot=4)
        eng = api.S.DecodeEngine(model, name="ok").warmup()
        session = api.session()
        session.register_decoder("ok", eng, warmup=False)
        try:
            eng.decode([1, 2], 3, timeout=60)
            dec = session.health_details()["decoders"]["ok"]
            assert not dec["wedged"] and not dec["degraded"]
        finally:
            session.close()


# ---------------------------------------------------------------------------
# the decode tests held back by the decode slice (tests/test_decode_v2.py)
# ---------------------------------------------------------------------------

def test_session_health_details_and_kwargs_passthrough():
    toks = {}
    for pkg in PKGS:
        api = Api(pkg)
        sess = api.session()
        try:
            m = api.xf(seed=5, max_len=128, max_slots=2, page=8,
                       max_pages_per_slot=4)
            engine = sess.register_decoder("dv2", m, chunk=16,
                                           prefix_cache=True)
            assert engine._block is not None and engine._pcache is not None
            toks[pkg] = sess.decode("dv2", [1, 2, 3, 4, 5], 4,
                                    timeout=120.0)
            assert len(toks[pkg]) == 4
            details = sess.health_details()
            assert "prefix_cache" in details["decoders"]["dv2"]
            assert "prefill" in details["decoders"]["dv2"]
        finally:
            sess.close()
    assert toks["jax"] == toks["torch"]


def test_ttft_histogram_records(api):
    inst = api.T.serving_instruments("ttftm")
    fam = api.T.get_registry().histogram(
        "dl4j_decode_ttft_seconds", labelnames=("model",))
    child = fam.labels(model="ttftm")
    c0 = child.count
    eng = api.S.DecodeEngine(api.xf(seed=5, max_len=128, max_slots=2,
                                    page=8, max_pages_per_slot=4),
                             name="ttftm", instruments=inst).warmup()
    try:
        eng.decode([1, 2, 3], 4, timeout=60.0)
        assert child.count == c0 + 1
    finally:
        eng.close()


def test_session_passes_its_instruments_to_the_decoder(traced, api):
    _, reg = traced
    sess = api.session()
    try:
        sess.register_decoder("dec", api.xf(max_slots=2, page=8,
                                            max_pages_per_slot=4))
        timing = {}
        assert len(sess.decode("dec", [1, 2], 3, timeout=60,
                               timing=timing)) == 3
        assert timing["ttft"] > 0
        snap = reg.snapshot()
    finally:
        sess.close()
    assert snap['dl4j_serving_decode_tokens_total{model="dec"}'] == 3
    assert snap['dl4j_decode_ttft_seconds_count{model="dec"}'] == 1


# ---------------------------------------------------------------------------
# disabled contract: zero tracer calls, the same answers
# ---------------------------------------------------------------------------

class _CountingStubTracer:
    calls = 0

    def __getattr__(self, name):
        type(self).calls += 1
        raise AssertionError(f"tracer touched while disabled: {name}")


def _serve_and_decode(api):
    """A replica session's predicts and a decode; returns the answers."""
    net = api.mlp(seed=4)
    x = np.random.default_rng(2).normal(size=(3, 16)).astype(np.float32)
    sess = api.session(
        admission=api.S.AdmissionController(default_budget=8))
    try:
        sess.register("m", net, example_shape=(16,),
                      ladder=api.S.BucketLadder((1, 4)), warmup=True,
                      replicas=2)
        ys = [sess.predict("m", x), sess.predict("m", x, batched=False)]
        sess.register_decoder("d", api.xf(max_slots=2, page=8,
                                          max_pages_per_slot=4))
        toks = sess.decode("d", [1, 2, 3], 4, timeout=60)
    finally:
        sess.close()
    return ys, toks


class TestDisabledContract:
    def test_zero_tracer_calls_and_same_answers(self, api, traced):
        root = api.tracing.start_trace("client")
        with root:
            want = _serve_and_decode(api)
        assert len(traced[0].spans(root.trace_id)) > 1
        _CountingStubTracer.calls = 0
        api.T.disable()
        prev = api.tracing.set_tracer(_CountingStubTracer())
        try:
            got = _serve_and_decode(api)
        finally:
            api.tracing.set_tracer(prev)
            api.T.enable()
        assert _CountingStubTracer.calls == 0
        for a, b in zip(want[0], got[0]):
            np.testing.assert_array_equal(a, b)
        assert want[1] == got[1]

    def test_sampled_off_emits_nothing(self, api, traced):
        tr, _ = traced
        api.tracing.configure(sample_rate=0.0)
        with api.tracing.start_trace("client") or api.tracing.NULL:
            _serve_and_decode(api)
        assert len(tr) == 0


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

class TestTraceExport:
    def test_export_jsonl_and_filter(self, api, traced):
        a = api.tracing.start_trace("a")
        with a:
            pass
        b = api.tracing.start_trace("b")
        with b:
            pass
        full = [json.loads(line)
                for line in api.tracing.export_jsonl().splitlines() if line]
        assert {s["name"] for s in full} == {"a", "b"}
        only_a = [json.loads(line) for line in
                  api.tracing.export_jsonl(trace_id=a.trace_id)
                  .splitlines() if line]
        assert [s["name"] for s in only_a] == ["a"]
        assert api.tracing.get_tracer().trace_ids() == [a.trace_id,
                                                        b.trace_id]
