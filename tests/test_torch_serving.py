"""The port's InferenceSession against the JAX package's network.

A JAX TextGenerationLSTM's weights move into the port through
``params_from_numpy``; the port then serves it on the CPU
(``InferenceSession(device="cpu")``) and every answer is held against the
JAX net's ``output`` on the same rows: concurrent requests coalescing
across batch buckets, a request chunked by the ladder plan, and a request
whose time axis pads up to a sequence bucket. Inputs come from a numpy
seed. Tolerance: 1e-5 abs/rel, float32 on the CPU. The batcher's queue
semantics (backpressure, timeouts, shutdown) run against a servable that
blocks until released.
"""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import TextGenerationLSTM as JaxCharRnn
from deeplearning4j_tpu.serving import buckets as jax_buckets
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import (
    BucketLadder, InferenceSession, ModelNotFound, QueueFullError, Servable,
    ServingShutdown, ServingTimeout, buckets)
from deeplearning4j_tpu_torch.utils.convert import params_from_numpy

VOCAB, HIDDEN, SEQ = 9, 128, 12
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def nets():
    jax_net = JaxCharRnn(vocabSize=VOCAB, hidden=HIDDEN,
                         seqLength=SEQ).init()
    conf = MultiLayerConfiguration.from_json(jax_net.conf.to_json())
    arrays = [{k: np.asarray(v) for k, v in p.items()}
              for p in jax_net._params]
    port = MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, arrays, "cpu"))
    return jax_net, port


def _one_hot(n, t, seed):
    idx = np.random.default_rng(seed).integers(0, VOCAB, size=(n, t))
    return np.eye(VOCAB, dtype=np.float32)[idx].transpose(0, 2, 1).copy()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_concurrent_predicts_match_jax(nets):
    jax_net, port = nets
    requests = [_one_hot(n, SEQ, seed=k) for k, n in
                enumerate([1, 3, 2, 4, 1, 5, 2, 9, 1, 3])]
    results = [None] * len(requests)
    with InferenceSession(device="cpu", max_latency=0.02) as session:
        session.register("charrnn", port, example_shape=(VOCAB, SEQ),
                         ladder=(1, 2, 4, 8), warmup=True)
        assert session.ready()

        def call(k):
            results[k] = session.predict("charrnn", requests[k])

        threads = [threading.Thread(target=call, args=(k,))
                   for k in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    for x, y in zip(requests, results):
        assert y.shape == x.shape
        _close(y, jax_net.output(x).toNumpy())


def test_time_padded_and_direct_requests_match_jax(nets):
    jax_net, port = nets
    ladder = BucketLadder((1, 2, 4), seq_lengths=(8, SEQ))
    short = _one_hot(3, 5, seed=40)            # pads to 8 timesteps
    with InferenceSession(device="cpu") as session:
        session.register("charrnn", port, example_shape=(VOCAB, SEQ),
                         ladder=ladder, warmup=True)
        assert sorted(session.models()[0]["warmed_shapes"]) == sorted(
            [b, VOCAB, t] for b in (1, 2, 4) for t in (8, SEQ))
        y = session.predict("charrnn", short)
        assert y.shape == (3, VOCAB, 5)
        _close(y, jax_net.output(short).toNumpy())
        # the caller's thread straight through the ladder (no queue); one
        # example without a batch axis comes back without one
        one = _one_hot(1, SEQ, seed=41)
        direct = session.predict("charrnn", one[0], batched=False)
        assert direct.shape == (VOCAB, SEQ)
        _close(direct, jax_net.output(one).toNumpy()[0])
        with pytest.raises(ValueError, match="expects examples"):
            session.predict("charrnn", np.zeros((2, VOCAB + 1, SEQ),
                                                np.float32))


class _Gate(Servable):
    """Answers x + 1 once released: holds dispatches so requests queue."""

    def __init__(self):
        super().__init__((3,), "cpu")
        self.release = threading.Event()

    def _infer_fn(self):
        def fn(x):
            self.release.wait(10)
            return x + 1
        return fn

    def _call_args(self):
        return ()


def test_batcher_backpressure_timeout_and_shutdown():
    gate = _Gate()
    session = InferenceSession(device="cpu", queue_size=2, max_latency=0.0)
    session.register("gate", gate, ladder=(1, 2))
    x = np.ones((1, 3), np.float32)

    def worker_took_all():
        for _ in range(1000):
            if not session.stats()["gate:v1"]["queue_depth"]:
                return
            threading.Event().wait(0.01)
        raise AssertionError("the worker never dequeued")

    first = session.predict_async("gate", x)
    worker_took_all()                             # and the gate holds it
    timed = session.predict_async("gate", x, timeout=0.0)
    queued = session.predict_async("gate", x)
    with pytest.raises(QueueFullError):
        session.predict_async("gate", x)
    gate.release.set()
    np.testing.assert_array_equal(first.result(10), x + 1)
    with pytest.raises(ServingTimeout):
        timed.result(10)
    np.testing.assert_array_equal(queued.result(10), x + 1)
    gate.release.clear()
    held = session.predict_async("gate", x)
    worker_took_all()
    waiting = session.predict_async("gate", x)
    # release the dispatch in flight only after close() has begun: it
    # completes, and the request still queued fails
    release = threading.Timer(0.2, gate.release.set)
    release.start()
    session.close()
    release.join(10)
    np.testing.assert_array_equal(held.result(10), x + 1)
    with pytest.raises(ServingShutdown):
        waiting.result(10)
    with pytest.raises(RuntimeError, match="closed"):
        session.predict_async("gate", x)


@pytest.mark.parametrize("n,t", [(1, 5), (3, 12), (7, 9), (40, 30)])
def test_buckets_match_jax(n, t):
    ladder = buckets.BucketLadder((1, 2, 4, 8, 16, 32), seq_lengths=(8, 16))
    jax_ladder = jax_buckets.BucketLadder((1, 2, 4, 8, 16, 32),
                                          seq_lengths=(8, 16))
    assert ladder.plan(n) == jax_ladder.plan(n)
    assert ladder.shapes((4, t)) == jax_ladder.shapes((4, t))
    x = np.random.default_rng(n).normal(size=(min(n, 32), 4, t))
    got, want = buckets.pad_batch(x, ladder), jax_buckets.pad_batch(
        x, jax_ladder)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(buckets.unpad(got[0], *got[1:]),
                                  jax_buckets.unpad(want[0], *want[1:]))


def test_versions_pin_and_unregister():
    a, b = _Gate(), _Gate()
    a.release.set()
    b.release.set()
    b._infer_fn = lambda: (lambda x: x + 2)
    x = np.zeros((2, 3), np.float32)
    with InferenceSession(device="cpu") as session:
        session.register("m", a, version=1, ladder=(1, 2))
        session.register("m", b, version=2, ladder=(1, 2))
        np.testing.assert_array_equal(session.predict("m", x), x + 2)
        np.testing.assert_array_equal(session.predict("m", x, version=1),
                                      x + 1)
        session.registry.unregister("m", version=2)
        np.testing.assert_array_equal(session.predict("m", x), x + 1)
        with pytest.raises(ModelNotFound):
            session.predict("m", x, version=2)
        session.registry.unregister("m")
        with pytest.raises(ModelNotFound):
            session.predict("m", x)


def test_session_needs_models_on_its_device(nets):
    _, port = nets
    meta = torch.device("meta")
    port_on_meta = type("Fake", (), {"device": meta})()
    with InferenceSession(device="cpu") as session:
        with pytest.raises(ValueError, match="lives on meta"):
            session.register("m", port_on_meta, example_shape=(VOCAB, SEQ))
