"""The port's HTTP handlers against the JAX package's.

Module: ``serving/http.py`` (whole): the path parsers, ``handle_predict``
and ``handle_decode`` with ``timing=``, ``handle_models``,
``handle_register`` / ``handle_unregister`` over an admin object,
``HttpError`` and ``error_body``, and the status map (400, 404, 429 with
``Retry-After``, 503, 504, 500).

Each handler runs on both packages with the same model (the JAX
package's weights, carried into the port by ``utils/convert.py``) and the
same body: the answers' JSON is equal but for the predictions, which
agree within 1e-5 abs/rel (float32 on the CPU); every error class gives
the same status, message and headers on both; ``timing`` holds the same
keys (``queue`` and ``execute``; ``ttft`` for decode).
"""

from __future__ import annotations

import json
import threading

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import serving as jax_serving
from deeplearning4j_tpu.models.bert import (
    BertConfig as JaxBertConfig, init_params as jax_bert_init)
from deeplearning4j_tpu.nn import (
    DenseLayer, LossFunction, MultiLayerNetwork as JaxNet,
    NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu.serving import http as jax_http
from deeplearning4j_tpu_torch import serving as port_serving
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import http as port_http
from deeplearning4j_tpu_torch.utils.convert import (
    bert_params_from_numpy, params_from_numpy)

PKGS = ("jax", "torch")
RTOL = ATOL = 1e-5


def _jax_mlp(seed=7, n_in=5, n_out=3):
    conf = (NeuralNetConfiguration.Builder().seed(seed).list()
            .layer(DenseLayer.Builder().nIn(n_in).nOut(8)
                   .activation("tanh").build())
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


def _xf(pkg, vocab=32, hidden=16, max_len=64):
    cfg = JaxBertConfig(vocab_size=vocab, hidden=hidden, num_layers=1,
                        num_heads=2, ffn=4 * hidden, max_len=max_len)
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                               jax_bert_init(cfg, jax.random.key(3)))
    geom = dict(max_slots=2, page=8, max_pages_per_slot=4)
    if pkg == "jax":
        return jax_serving.TransformerDecodeModel(
            jax.tree_util.tree_map(jax.numpy.asarray, p), n_heads=2,
            **geom)
    return port_serving.TransformerDecodeModel(
        bert_params_from_numpy(p, "cpu"), n_heads=2, device="cpu", **geom)


class _Gate:
    """A servable mixin that holds each dispatch until released (so
    requests queue), or raises when told to."""

    def __init__(self, example_shape, **kw):
        super().__init__(example_shape, **kw)
        self.release = threading.Event()
        self.boom = False

    def warmup(self, ladder):
        return []

    def infer(self, x):
        if self.boom:
            raise RuntimeError("device lost")
        self.release.wait(10)
        return np.asarray(x) + 1


def _gate(pkg):
    S = jax_serving if pkg == "jax" else port_serving
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return type("Gate", (_Gate, S.Servable), {})((5,), **kw)


@pytest.fixture(scope="module")
def worlds():
    """Per package: (http module, session with model "m" (replicas=2),
    a gated model "g", an admission budget on "shed", and decoder "d")."""
    jnet = _jax_mlp()
    out = {}
    for pkg in PKGS:
        S = jax_serving if pkg == "jax" else port_serving
        H = jax_http if pkg == "jax" else port_http
        kw = {} if pkg == "jax" else {"device": "cpu"}
        adm = S.AdmissionController(default_budget=64)
        adm.set_budget("shed", 0)
        sess = S.InferenceSession(admission=adm, max_latency=0.0,
                                  queue_size=2, **kw)
        net = jnet if pkg == "jax" else _port_of(jnet)
        sess.register("m", net, example_shape=(5,), warmup=True,
                      ladder=S.BucketLadder((1, 2, 4)), replicas=2)
        sess.register("shed", net, example_shape=(5,), warmup=True,
                      ladder=S.BucketLadder((1,)))
        sess.register("g", _gate(pkg), ladder=S.BucketLadder((1,)))
        sess.register_decoder("d", _xf(pkg))
        out[pkg] = (H, sess, adm)
    yield out
    for _, sess, _ in out.values():
        sess.close()


def _both(worlds, fn):
    """fn(http, session, admission) on each package: the returned bytes
    decoded, or ("error", status, error body, headers)."""
    res = {}
    for pkg in PKGS:
        H, sess, adm = worlds[pkg]
        try:
            res[pkg] = json.loads(fn(H, sess, adm))
        except H.HttpError as e:
            res[pkg] = ("error", e.status, json.loads(H.error_body(e)),
                        e.headers)
    return res["jax"], res["torch"]


def _body(**kw):
    return json.dumps(kw).encode()


@pytest.mark.parametrize("path", [
    "/serving/v1/models/m:predict", "/serving/v1/models/a/b:predict",
    "/serving/v1/models/:predict", "/serving/v1/models/m:decode",
    "/serving/v1/models/m:register", "/serving/v1/models/m:unregister",
    "/serving/v2/models/m:predict", "/serving/v1/models", "m:predict"])
def test_path_parsers(path):
    for fn in ("parse_predict_path", "parse_decode_path",
               "parse_register_path", "parse_unregister_path"):
        assert getattr(port_http, fn)(path) == getattr(jax_http, fn)(path)


def test_predict_answers_match(worlds):
    x = np.random.default_rng(0).normal(size=(3, 5)).round(4).tolist()
    timings = {}

    def call(H, sess, adm):
        timings[H] = {}
        return H.handle_predict(sess, "m", _body(instances=x,
                                                 priority="high"),
                                timing=timings[H])

    a, b = _both(worlds, call)
    assert {k: v for k, v in a.items() if k != "predictions"} == \
        {k: v for k, v in b.items() if k != "predictions"} == \
        {"model": "m", "version": 1}
    np.testing.assert_allclose(b["predictions"], a["predictions"],
                               rtol=RTOL, atol=ATOL)
    tj, tp = timings[jax_http], timings[port_http]
    assert set(tj) == set(tp) == {"queue", "execute"}
    assert all(v >= 0 for v in tp.values())


def test_models_payload_matches(worlds):
    a, b = _both(worlds, lambda H, s, _: H.handle_models(s))
    rows = {pkg: {r["name"]: r for r in res["models"]}
            for pkg, res in zip(PKGS, (a, b))}
    assert set(rows["jax"]) == set(rows["torch"]) == {"m", "shed", "g"}
    for name in ("m", "shed"):
        for k in ("version", "type", "example_shape", "dtype", "ladder",
                  "warmed", "warmed_shapes"):
            assert rows["jax"][name][k] == rows["torch"][name][k], k
    for H in (jax_http, port_http):
        with pytest.raises(H.HttpError) as e:
            H.handle_models(None)
        assert e.value.status == 404


BAD_PREDICTS = {
    "unknown model": ("nope", _body(instances=[[0.0] * 5])),
    "malformed JSON": ("m", b"{not json"),
    "no instances": ("m", _body(rows=[[0.0] * 5])),
    "bad timeout": ("m", _body(instances=[[0.0] * 5], timeout_ms="soon")),
    "bad priority": ("m", _body(instances=[[0.0] * 5], priority="vip")),
    "wrong shape": ("m", _body(instances=[[0.0] * 6])),
    "unknown version": ("m", _body(instances=[[0.0] * 5], version=9)),
    "shed": ("shed", _body(instances=[[0.0] * 5])),
}


@pytest.mark.parametrize("case", sorted(BAD_PREDICTS))
def test_predict_errors_match(worlds, case):
    name, body = BAD_PREDICTS[case]
    held = {}

    def call(H, sess, adm):
        if case == "shed":   # budget 0 holds one standing request
            held[H] = adm.admit("shed")
        try:
            return H.handle_predict(sess, name, body)
        finally:
            if H in held:
                held[H].release()

    a, b = _both(worlds, call)
    assert a[0] == b[0] == "error"
    assert a == b
    want = {"unknown model": 404, "unknown version": 404, "shed": 429}
    assert a[1] == want.get(case, 400)
    if case == "shed":
        assert float(a[3]["Retry-After"]) > 0


def test_predict_queue_full_timeout_shutdown_and_device_error(worlds):
    """429 on a full queue, 504 on a timeout, 500 on a device error, 503
    once the model's batcher is closed: the same on both packages."""
    one = _body(instances=[[0.0] * 5])
    seen = {}
    for pkg in PKGS:
        H, sess, _ = worlds[pkg]
        gate = sess.registry.get("g").servable
        gate.release.clear()
        codes = []
        z = np.zeros((1, 5), np.float32)
        futs = [sess.predict_async("g", z)]
        for _ in range(1000):   # the worker took it; the gate holds it
            if not sess.stats()["g:v1"]["queue_depth"]:
                break
            threading.Event().wait(0.01)
        futs += [sess.predict_async("g", z) for _ in range(2)]   # queued
        try:
            H.handle_predict(sess, "g", one)
        except H.HttpError as e:
            codes.append((e.status, e.message))
        gate.release.set()
        for f in futs:
            f.result(10)
        try:
            gate.release.clear()
            threading.Timer(0.5, gate.release.set).start()
            H.handle_predict(sess, "g", _body(instances=[[0.0] * 5],
                                              timeout_ms=50))
        except H.HttpError as e:
            codes.append((e.status, e.message.split(" after")[0]))
        gate.release.set()
        gate.boom = True
        try:
            H.handle_predict(sess, "g", one)
        except H.HttpError as e:
            codes.append((e.status, e.message))
        gate.boom = False
        sess._batchers[("g", 1)].close()
        try:
            H.handle_predict(sess, "g", one)
        except H.HttpError as e:
            codes.append((e.status, e.message))
        seen[pkg] = codes
    assert [c for c, _ in seen["torch"]] == [429, 504, 500, 503]
    assert seen["jax"] == seen["torch"]


def test_decode_answers_and_errors_match(worlds):
    timings = {}

    def call(H, sess, adm):
        timings[H] = {}
        return H.handle_decode(sess, "d", _body(prompt=[1, 2, 3],
                                                max_new_tokens=4),
                               timing=timings[H])

    a, b = _both(worlds, call)
    assert a == b and a["model"] == "d" and len(a["tokens"]) == 4
    assert set(timings[jax_http]) == set(timings[port_http]) == {"ttft"}
    assert timings[port_http]["ttft"] > 0
    bad = {
        "unknown": ("nope", _body(prompt=[1], max_new_tokens=2), 404),
        "malformed": ("d", b"[", 400),
        "missing": ("d", _body(prompt=[1]), 400),
        "priority": ("d", _body(prompt=[1], max_new_tokens=2,
                                priority="vip"), 400),
        "params": ("d", _body(prompt=["x"], max_new_tokens=2), 400),
        "too long": ("d", _body(prompt=[1] * 40, max_new_tokens=40), 400),
        "empty": ("d", _body(prompt=[], max_new_tokens=2), 400),
    }
    for case, (name, body, status) in bad.items():
        a, b = _both(worlds, lambda H, s, _: H.handle_decode(s, name, body))
        assert a == b, case
        assert a[1] == status, (case, a)
    for H in (jax_http, port_http):
        with pytest.raises(H.HttpError) as e:
            H.handle_decode(None, "d", b"{}")
        assert e.value.status == 404


def test_decode_shed_carries_retry_after(worlds):
    def call(H, sess, adm):
        adm.set_budget("d", 0)
        held = adm.admit("d")
        try:
            return H.handle_decode(sess, "d", _body(prompt=[1],
                                                    max_new_tokens=2))
        finally:
            held.release()
            adm.set_budget("d", 64)

    a, b = _both(worlds, call)
    assert a == b and a[1] == 429
    assert float(b[3]["Retry-After"]) > 0


class _Admin:
    """An admin with ``register_spec`` and ``unregister``, over one
    package's session (the fleet's admin, reduced to what the handlers
    call)."""

    def __init__(self, sess, net):
        self.sess, self.net = sess, net

    def register_spec(self, name, spec, version, warmup=True):
        if spec.get("kind") != "mlp":
            raise ValueError(f"unknown spec kind {spec.get('kind')!r}")
        return self.sess.register(name, self.net, version=version,
                                  example_shape=(5,), ladder=(1,),
                                  warmup=warmup)

    def unregister(self, name, version=None):
        self.sess.registry.unregister(name, version)


def test_register_and_unregister_match(worlds):
    admins = {}
    for pkg in PKGS:
        _, sess, _ = worlds[pkg]
        admins[pkg] = _Admin(sess, sess.registry.get("m").servable)

    def run(case, fn):
        res = {}
        for pkg in PKGS:
            H = worlds[pkg][0]
            try:
                res[pkg] = json.loads(fn(H, admins[pkg]))
            except H.HttpError as e:
                res[pkg] = ("error", e.status, json.loads(H.error_body(e)))
        assert res["jax"] == res["torch"], case
        return res["torch"]

    ok = run("register", lambda H, a: H.handle_register(
        a, "r", _body(spec={"kind": "mlp"}, version=2)))
    assert ok == {"model": "r", "version": 2, "warmed": True}
    assert run("bad spec", lambda H, a: H.handle_register(
        a, "r", _body(spec={"kind": "cnn"}, version=3)))[1] == 400
    assert run("no version", lambda H, a: H.handle_register(
        a, "r", _body(spec={"kind": "mlp"})))[1] == 400
    assert run("malformed", lambda H, a: H.handle_register(
        a, "r", b"{"))[1] == 400
    assert run("no admin", lambda H, a: H.handle_register(
        None, "r", b"{}"))[1] == 404
    assert run("unknown version", lambda H, a: H.handle_unregister(
        a, "r", _body(version=7)))[1] == 404
    assert run("unregister", lambda H, a: H.handle_unregister(
        a, "r", _body(version=2))) == {"model": "r", "unregistered": 2}
    assert run("unknown", lambda H, a: H.handle_unregister(
        a, "r", b"{}"))[1] == 404
    assert run("no admin", lambda H, a: H.handle_unregister(
        None, "r", b"{}"))[1] == 404


def test_error_body():
    for H in (jax_http, port_http):
        e = H.HttpError(429, "slow down", headers={"Retry-After": "1.000"})
        assert json.loads(H.error_body(e)) == {"error": "slow down",
                                               "status": 429}
        assert e.headers == {"Retry-After": "1.000"}


def test_int8_ptq_served_through_the_predict_route():
    """The reference's int8 PTQ route (``tests/test_precision.py``,
    ``test_ptq_served_through_http_zero_recompiles``) through the
    handlers on both packages: predictions within the calibration bar
    (0.05) of the float net's output, three calls allocate no staging
    buffer after the first (the port's counterpart of zero recompiles,
    through 2 replicas), and the models row advertises the payload."""
    from deeplearning4j_tpu.precision import quantize as jax_quantize
    from deeplearning4j_tpu_torch.precision import quantize

    jnet = _jax_mlp(seed=24, n_in=16, n_out=4)
    X = np.random.default_rng(24).normal(size=(16, 16)).astype(np.float32)
    rows = {}
    for pkg in PKGS:
        S = jax_serving if pkg == "jax" else port_serving
        H = jax_http if pkg == "jax" else port_http
        net = jnet if pkg == "jax" else _port_of(jnet)
        q = (jax_quantize(net, [X], example_shape=(16,)) if pkg == "jax"
             else quantize(net, [X], example_shape=(16,), device="cpu"))
        kw = {} if pkg == "jax" else {"device": "cpu"}
        with S.InferenceSession(max_latency=0.001, **kw) as sess:
            sess.register("m_int8", q, ladder=S.BucketLadder((1, 8, 16)),
                          warmup=True, replicas=2)
            ref = np.asarray(net.output(X[:8]).toNumpy(), np.float32)
            body = _body(instances=X[:8].tolist())
            staged = None
            for _ in range(3):
                out = json.loads(H.handle_predict(sess, "m_int8", body))
                if pkg == "torch":
                    reps = sess._batchers[("m_int8", 1)].executor.replicas
                    now = {r.name: {s: t.data_ptr() for s, t in
                                    r.servable._staging.items()}
                           for r in reps}
                    assert staged is None or now == staged
                    staged = now
            preds = np.asarray(out["predictions"], np.float32)
            assert np.abs(preds - ref).max() <= 0.05
            rows[pkg] = json.loads(H.handle_models(sess))["models"][0]
    for k in ("quantization", "compute_dtype"):
        assert rows["jax"][k] == rows["torch"][k]
    assert rows["torch"]["bytes"]["int8"] == rows["jax"]["bytes"]["int8"] > 0
