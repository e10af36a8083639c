"""The port's decode engine against the JAX package's.

Modules: ``serving/decode.py`` (PagedKVCache, RnnDecodeModel,
TransformerDecodeModel, DecodeEngine), ``prefill.py`` (ChunkedPrefill),
``prefix_cache.py`` (PrefixCache), ``speculative.py`` and the part of
``telemetry/memledger.py`` that the engine calls.

- Every decode test of the reference suites runs on both packages, as
  cases of one test parametrised by package: ``tests/test_decode_v2.py``
  (TestPagedKVRefcount, TestChunkedPrefill, TestPrefixCache,
  TestSpeculative, the health sections, the mixed-arm soak) and
  ``tests/test_serving_scale.py`` (TestPagedKVCache,
  TestContinuousBatchingDecode), and the decode seams of
  ``tests/test_memledger.py``. Both packages get the same weights: the
  JAX package's ``init_params``, carried into the port by
  ``utils/convert.py``. The reference's ``dl4j_compile_total``
  assertions stay on the JAX side; on the port's, whose PyTorch runs
  eagerly, they become: steady state builds no kernel and allocates no
  pool tensor (the pools' ``data_ptr`` is the same across joins and
  leaves).
- Parity: the same inputs fed to both packages' models, step by step
  (teacher-forced, some slots masked), give pools (the transformer, page
  0 aside) or carries (the LSTM char-RNN) within 1e-5 of the largest
  element after every step, and equal tokens; the engines' greedy streams
  are equal across packages for both models under every arm (plain,
  chunked, prefix cache, speculative).
- The port writes its pools in place: warmup leaves the engine state as
  it was (page 0 aside) for both models and both lanes, masked writes
  land only on page 0.
- ``cuda``-marked cases run the engine on the card against the CPU and
  skip here.

Small widths: transformers of hidden 16-32 (1-2 layers, 2 heads) and the
char-RNN at vocab 11, LSTM 12. Instruments are a stub with the
reference's interface on both packages (the port's serving instruments
come with the telemetry slice).
"""

from __future__ import annotations

import collections
import functools
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import serving as jax_serving
from deeplearning4j_tpu.models.bert import (
    BertConfig as JaxBertConfig, init_params as jax_bert_init)
from deeplearning4j_tpu.nn import (
    InputType, LSTM, LossFunction, MultiLayerNetwork as JaxNet,
    NeuralNetConfiguration, RnnOutputLayer)
from deeplearning4j_tpu.optimize.updaters import Adam
from deeplearning4j_tpu.serving import decode as jax_decode
from deeplearning4j_tpu.serving.batcher import QueueFullError as JaxQFE
from deeplearning4j_tpu.telemetry import compile_ledger
from deeplearning4j_tpu.telemetry import memledger as jax_memledger
from deeplearning4j_tpu import telemetry as jax_telemetry
from deeplearning4j_tpu_torch import serving as port_serving
from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import decode as port_decode
from deeplearning4j_tpu_torch.serving.batcher import QueueFullError
from deeplearning4j_tpu_torch.telemetry import flight as port_flight
from deeplearning4j_tpu_torch.telemetry import memledger as port_memledger
from deeplearning4j_tpu_torch.utils.convert import (
    bert_params_from_numpy, params_from_numpy)

PKGS = ["jax", "torch"]
PARITY_TOL = 1e-5     # of the largest element, per step


# ---------------------------------------------------------------------------
# one package's names
# ---------------------------------------------------------------------------

class Api:
    """A package's decode names, and constructors of models that give
    both packages the same weights."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.S = jax_serving if pkg == "jax" else port_serving
        self.D = jax_decode if pkg == "jax" else port_decode
        self.XF = self.S.TransformerDecodeModel
        self.kw = {} if pkg == "jax" else {"device": "cpu"}
        self.QueueFullError = JaxQFE if pkg == "jax" else QueueFullError
        self.memledger = (jax_memledger if pkg == "jax"
                          else port_memledger)

    def params(self, np_params):
        if self.pkg == "jax":
            return jax.tree_util.tree_map(jnp.asarray, np_params)
        return bert_params_from_numpy(np_params, "cpu")

    def xf(self, seed=0, vocab=64, hidden=32, n_layers=2, n_heads=2,
           max_len=128, scale=None, **geom):
        """TransformerDecodeModel.init's model (the JAX draw, or numpy
        weights of std ``scale`` when given) in this package."""
        p = (_jax_params(vocab, hidden, n_layers, n_heads, max_len, seed)
             if scale is None else
             _np_params(vocab, hidden, n_layers, max_len, seed, scale))
        return self.XF(self.params(p), n_heads=n_heads, **geom, **self.kw)

    def like(self, model, cls=None, **geom):
        """Another model over ``model``'s params (a draft)."""
        return (cls or self.XF)(model.params, n_heads=model.n_heads,
                                **geom, **self.kw)

    def rnn_net(self, seed=4, vocab=11, hidden=12, n_out=None):
        jnet = _jax_char_rnn(seed, vocab, hidden, n_out or vocab)
        return jnet if self.pkg == "jax" else _port_net(jnet)

    def engine(self, model, **kw):
        return self.S.DecodeEngine(model, **kw)


@pytest.fixture(params=PKGS)
def api(request):
    return Api(request.param)


@functools.lru_cache(maxsize=None)
def _jax_params(vocab, hidden, n_layers, n_heads, max_len, seed):
    cfg = JaxBertConfig(vocab_size=vocab, hidden=hidden,
                        num_layers=n_layers, num_heads=n_heads,
                        ffn=4 * hidden, max_len=max_len)
    return jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax_bert_init(cfg, jax.random.key(seed)))


@functools.lru_cache(maxsize=None)
def _np_params(vocab, hidden, n_layers, max_len, seed, scale):
    """BERT-layout weights of std ``scale`` from a numpy seed: large
    enough that the greedy streams do not just repeat their input."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def ln():
        return {"g": (1.0 + n(hidden)).astype(np.float32),
                "b": n(hidden)}

    f = 4 * hidden
    return {"tok_emb": n(vocab, hidden), "pos_emb": n(max_len, hidden),
            "type_emb": n(2, hidden), "emb_ln": ln(),
            "mlm_bias": n(vocab),
            "layers": [{"qkv_w": n(hidden, 3 * hidden),
                        "qkv_b": n(3 * hidden), "out_w": n(hidden, hidden),
                        "out_b": n(hidden), "ln1": ln(), "ln2": ln(),
                        "ffn_in_w": n(hidden, f), "ffn_in_b": n(f),
                        "ffn_out_w": n(f, hidden), "ffn_out_b": n(hidden)}
                       for _ in range(n_layers)]}


def _jax_char_rnn(seed, vocab, hidden, n_out):
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .updater(Adam(1e-3)).list()
            .layer(LSTM.Builder().nOut(hidden).build())
            .layer(RnnOutputLayer.Builder().nOut(n_out)
                   .activation("softmax")
                   .lossFunction(LossFunction.MCXENT).build())
            .setInputType(InputType.recurrent(vocab)).build())
    return JaxNet(conf).init()


def _port_net(jnet, device="cpu"):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    arrays = [{k: np.asarray(v).copy() for k, v in p.items()}
              for p in jnet._params]
    return MultiLayerNetwork(conf, device=device).init(
        params_from_numpy(conf, arrays, device))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _Inst:
    """The reference's ServingInstruments interface, counting locally."""

    class _C:
        def __init__(self):
            self.value = 0.0
            self.count = 0

        def inc(self, n=1.0):
            self.value += n

        def set(self, v):
            self.value = v

        def observe(self, v):
            self.count += 1

    def __init__(self):
        self.prefix_hits, self.prefix_misses = self._C(), self._C()
        self.tokens, self.slots = self._C(), self._C()
        self.ttft, self.kv_occupancy = self._C(), self._C()
        self.accepts = collections.Counter()

    def accepted(self, outcome, n=1):
        self.accepts[outcome] += n


def offline_decode(api, model, prompt, max_new):
    """The offline single-request decode loop: one token per step through
    the model's own step, fresh arrays every step."""
    state = model.init_state()
    if getattr(model, "uses_pages", False):
        kv = api.D.PagedKVCache(model.n_pages, model.page,
                                model.max_pages_per_slot, model.max_slots)
        kv.reserve(0, len(prompt) + max_new)
        table = np.ascontiguousarray(kv.table)
    else:
        table = np.zeros((model.max_slots, 1), np.int32)
    S = model.max_slots
    toks, out = list(prompt), []
    for i in range(len(prompt) + max_new):
        t = np.zeros((S,), np.int32)
        p = np.zeros((S,), np.int32)
        t[0], p[0] = toks[i], i
        nxt, state = model.step(state, t, p, table)
        if i >= len(prompt) - 1:
            tok = int(_np(nxt)[0])
            out.append(tok)
            toks.append(tok)
        if len(out) >= max_new:
            break
    return out


def _xf(api, seed=5, **kw):
    d = dict(vocab=40, hidden=16, n_layers=1, n_heads=2, max_len=576,
             max_slots=2, page=32, max_pages_per_slot=18, seed=seed)
    d.update(kw)
    return api.xf(**d)


def _steady(api, eng):
    """What steady state must leave alone: JAX's compile counter; the
    port's pool storage and built kernels."""
    if api.pkg == "jax":
        return jax_telemetry.get_registry().counter(
            "dl4j_compile_total").value
    ptrs = []
    for st in (eng._state, getattr(eng._spec, "_state", None)):
        if isinstance(st, dict):
            ptrs += [st["k"].data_ptr(), st["v"].data_ptr()]
    return ptrs, sorted(build._loaded)


# ---------------------------------------------------------------------------
# TestPagedKVRefcount / TestPagedKVCache (host bookkeeping)
# ---------------------------------------------------------------------------

def test_adopt_release_and_leak_free(api):
    kv = api.D.PagedKVCache(n_pages=6, page=4, max_pages_per_slot=6,
                            max_slots=2)
    pages = kv.reserve(0, 16)
    assert all(kv.refcount(p) == 1 for p in pages)
    kv.retain(pages[0])
    kv.retain(pages[1])
    kv.release(0)
    assert kv.free_pages == 4
    assert kv.refcount(pages[0]) == 1
    assert kv.refcount(pages[2]) == 0
    adopted = kv.reserve(1, 12, adopted=pages[:2])
    assert adopted[:2] == pages[:2]
    assert kv.refcount(pages[0]) == 2
    assert (kv.table[1, :3] == adopted).all()
    kv.release(1)
    assert kv.refcount(pages[0]) == 1
    kv.decref(pages[0])
    kv.decref(pages[1])
    assert kv.free_pages == 6
    assert kv.refcount(pages[0]) == 0


def test_copy_on_write_line_adoption_never_covers_last_token(api):
    kv = api.D.PagedKVCache(n_pages=8, page=4, max_pages_per_slot=8,
                            max_slots=2)
    cache = api.S.PrefixCache(page=4)
    prompt = list(range(12))
    pages = kv.reserve(0, 16)
    cache.publish(kv, prompt, pages[:3])
    hit, keys = cache.match(prompt)
    assert len(hit) == 2 and hit == pages[:2]
    hit2, _ = cache.match(prompt + [99, 98])
    assert hit2 == pages[:3]
    hit3, _ = cache.match(prompt[:6] + [77] * 6)
    assert hit3 == pages[:1]


def test_exhaustion_and_reserve_validation(api):
    kv = api.D.PagedKVCache(n_pages=4, page=8, max_pages_per_slot=3,
                            max_slots=2)
    kv.reserve(0, 17)
    with pytest.raises(api.D.DecodeError):
        kv.reserve(1, 24)
    pages = kv.owned(0)
    kv.retain(pages[0])
    kv.retain(pages[1])
    kv.release(0)
    kv.reserve(1, 17, adopted=pages[:2])
    kv.release(1)
    with pytest.raises(api.D.DecodeError):
        kv.reserve(0, 8, adopted=[pages[0], pages[1]])


def test_scratch_page_isolation(api):
    kv = api.D.PagedKVCache(n_pages=3, page=4, max_pages_per_slot=3,
                            max_slots=1)
    assert 0 not in kv.reserve(0, 12)
    with pytest.raises(api.D.DecodeError):
        kv.retain(0)
    kv.release(0)
    with pytest.raises(api.D.DecodeError):
        kv.reserve(0, 12, adopted=[0])
    cache = api.S.PrefixCache(page=4)
    cache.publish(kv, list(range(4)), [0])
    assert len(cache) == 0


def test_reserve_release_exhaustion(api):
    kv = api.D.PagedKVCache(n_pages=4, page=8, max_pages_per_slot=3,
                            max_slots=2)
    assert kv.pages_for(8) == 1 and kv.pages_for(9) == 2
    kv.reserve(0, 17)
    assert kv.free_pages == 1
    assert kv.can_reserve(8) and not kv.can_reserve(9)
    with pytest.raises(api.D.DecodeError):
        kv.reserve(1, 24)
    kv.release(0)
    assert kv.free_pages == 4
    assert (kv.table[0] == 0).all()
    with pytest.raises(api.D.DecodeError):
        kv.reserve(1, 25)


def test_page_zero_is_never_allocated(api):
    kv = api.D.PagedKVCache(n_pages=3, page=4, max_pages_per_slot=3,
                            max_slots=1)
    assert 0 not in kv.reserve(0, 12)


def test_prefix_cache_eviction_and_stats(api):
    kv = api.D.PagedKVCache(n_pages=6, page=2, max_pages_per_slot=6,
                            max_slots=2)
    cache = api.S.PrefixCache(page=2, max_pages=2)
    pages = kv.reserve(0, 8)
    assert cache.publish(kv, [1, 2, 3, 4, 5, 6], pages[:3]) == 3
    # over the cap of 2, but every page is still the slot's too: the
    # eviction skips pages a slot references, so all three stay
    assert len(cache) == 3
    kv.release(0)
    assert cache.reclaimable(kv) == len(cache)
    assert cache.evict(kv, 1) == 1
    assert cache.stats() == {"pages": len(cache), "hits": 0, "misses": 0,
                             "hit_rate": None}
    cache.clear(kv)
    assert kv.free_pages == 6


# ---------------------------------------------------------------------------
# TestContinuousBatchingDecode
# ---------------------------------------------------------------------------

@pytest.fixture(params=PKGS)
def xf_engine(request):
    a = Api(request.param)
    m = a.xf(vocab=40, hidden=32, n_layers=2, n_heads=2, max_len=64,
             max_slots=3, page=8, max_pages_per_slot=8, seed=5)
    eng = a.engine(m, name="xf-test").warmup()
    yield a, eng
    eng.close()


def test_slot_reuse_bit_identity_and_zero_recompiles(xf_engine):
    api, eng = xf_engine
    solo = eng.decode([5, 9, 2], 10, timeout=60.0)
    before = _steady(api, eng)
    reqs = [eng.submit([7, 1], 6), eng.submit([5, 9, 2], 10),
            eng.submit([3, 3, 3, 3], 4), eng.submit([11, 12], 8),
            eng.submit([5, 9, 2], 10), eng.submit([2], 12),
            eng.submit([5, 9, 2], 10)]
    outs = [r.result(timeout=60.0) for r in reqs]
    assert outs[1] == solo
    assert outs[4] == solo
    assert outs[6] == solo
    assert _steady(api, eng) == before
    assert len(outs[3]) == 8


def test_streaming_and_eos(xf_engine):
    api, eng = xf_engine
    ref = eng.decode([5, 9], 6, timeout=60.0)
    req = eng.submit([5, 9], 6)
    assert list(req.tokens(timeout=30.0)) == ref
    eos = ref[2]
    cut = eng.decode([5, 9], 6, eos_id=eos, timeout=60.0)
    assert cut == ref[:ref.index(eos) + 1]


def test_too_long_rejected(xf_engine):
    api, eng = xf_engine
    with pytest.raises(api.D.DecodeError):
        eng.submit(list(range(10)), 1000)
    with pytest.raises(api.D.DecodeError):
        eng.submit([1], 2000)           # past max_new_limit
    with pytest.raises(ValueError):
        eng.submit([], 2)


def test_lstm_decode_matches_rnn_time_step(api):
    """The engine's greedy stream equals an offline rnnTimeStep loop,
    neighbours or not."""
    vocab = 11
    net = api.rnn_net(seed=4, vocab=vocab, hidden=12)
    model = api.S.RnnDecodeModel(net, max_slots=3)
    eng = api.engine(model, name="lstm-test").warmup()
    prompt, n_new = [3, 1, 4], 7
    reqs = [eng.submit([2, 2], 5), eng.submit(prompt, n_new),
            eng.submit([7], 6), eng.submit([1, 5, 9, 8], 4)]
    outs = [r.result(timeout=60.0) for r in reqs]
    eng.close()
    net.rnnClearPreviousState()
    eye = np.eye(vocab, dtype=np.float32)
    for t in prompt:
        y = net.rnnTimeStep(eye[[t]]).toNumpy()
    ref = [int(np.argmax(y[0]))]
    for _ in range(n_new - 1):
        y = net.rnnTimeStep(eye[[ref[-1]]]).toNumpy()
        ref.append(int(np.argmax(y[0])))
    assert outs[1] == ref


def test_from_bert_params(api):
    cfg = JaxBertConfig(vocab_size=24, hidden=16, num_layers=1,
                        num_heads=2, ffn=32, max_len=32)
    params = api.params(jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax_bert_init(cfg, jax.random.key(0))))
    if api.pkg == "torch":
        from deeplearning4j_tpu_torch.models.bert import BertConfig
        cfg = BertConfig(vocab_size=24, hidden=16, num_layers=1,
                         num_heads=2, ffn=32, max_len=32)
    m = api.XF.from_bert(params, cfg, max_slots=2, page=4,
                         max_pages_per_slot=8, **api.kw)
    assert m.page == 4 and m.eps == cfg.layer_norm_eps
    eng = api.engine(m, name="bert-test").warmup()
    out = eng.decode([1, 2, 3], 4, timeout=60.0)
    assert len(out) == 4 and all(0 <= t < 24 for t in out)
    eng.close()


def test_pending_queue_backpressure(api):
    m = api.xf(vocab=16, hidden=16, n_layers=1, n_heads=2, max_len=32,
               max_slots=1, page=4, max_pages_per_slot=8, seed=1)
    real_step = m.step

    def _slow_step(*a, **kw):
        time.sleep(0.01)
        return real_step(*a, **kw)

    m.step = _slow_step
    eng = api.engine(m, name="bp-test", pending_size=2).warmup()
    first = eng.submit([1], 24)
    deadline = time.perf_counter() + 10.0
    while eng.active_slots < 1:
        assert time.perf_counter() < deadline
        time.sleep(0.005)
    rs = [eng.submit([1], 8) for _ in range(2)]
    with pytest.raises(api.QueueFullError):
        eng.submit([1], 8)
    for r in [first] + rs:
        r.result(timeout=60.0)
    eng.close()


def test_close_fails_pending_and_refuses_submit(api):
    m = api.xf(vocab=16, hidden=16, n_layers=1, n_heads=2, max_len=32,
               max_slots=1, page=4, max_pages_per_slot=8, seed=1)
    gate = threading.Event()
    real_step = m.step

    def _held(*a, **kw):
        gate.wait(10)
        return real_step(*a, **kw)

    m.step = _held
    eng = api.engine(m, name="close-test")
    reqs = [eng.submit([1], 4) for _ in range(3)]
    time.sleep(0.05)
    gate.set()
    eng.close()
    for r in reqs:
        if r.future.done() and r.future.exception() is None:
            continue
        with pytest.raises(api.D.DecodeShutdown):
            r.result(timeout=10)
    with pytest.raises(api.D.DecodeShutdown):
        eng.submit([1], 2)


# ---------------------------------------------------------------------------
# TestChunkedPrefill
# ---------------------------------------------------------------------------

def test_512_prompt_bit_identity_and_boundary_drop(api):
    model = _xf(api, seed=7)
    prompt = list(np.random.default_rng(3).integers(0, 40, size=512))
    ref = offline_decode(api, model, prompt, 8)
    eng = api.engine(_xf(api, seed=7), name="c512", chunk=64).warmup()
    req = eng.submit(prompt, 8)
    assert req.result(timeout=300.0) == ref
    assert req.ttft_boundaries <= 8
    assert 512 / req.ttft_boundaries >= 8
    eng.close()


def test_plain_engine_boundary_count_is_prompt_length(api):
    eng = api.engine(_xf(api, seed=2), name="c-base").warmup()
    prompt = [5, 9, 2, 11, 3, 1, 4, 8]
    req = eng.submit(prompt, 4)
    req.result(timeout=60.0)
    assert req.ttft_boundaries == len(prompt)
    eng.close()


def test_chunked_interleaves_with_inflight_decode(api):
    eng = api.engine(_xf(api, seed=11, max_slots=3), name="c-mix",
                     chunk=32).warmup()
    solo = eng.decode([5, 9, 2], 10, timeout=60.0)
    long_prompt = list(np.random.default_rng(8).integers(0, 40, size=200))
    r_long = eng.submit(long_prompt, 6)
    r_short = eng.submit([5, 9, 2], 10)
    assert r_short.result(timeout=120.0) == solo
    assert len(r_long.result(timeout=120.0)) == 6
    eng.close()


def test_rnn_chunked_prefill_bit_identity(api):
    net = api.rnn_net(seed=4, vocab=11, hidden=12)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
    ref = offline_decode(api, api.S.RnnDecodeModel(net, max_slots=3),
                         prompt, 7)
    eng = api.engine(api.S.RnnDecodeModel(net, max_slots=3),
                     name="rnn-c", chunk=8).warmup()
    req = eng.submit(prompt, 7)
    assert req.result(timeout=60.0) == ref
    assert req.ttft_boundaries <= 3
    eng.close()


def test_executable_set_and_mixed_soak_steady_state(api):
    """The reference's ledger bar on the JAX side (warmup compiles
    exactly the decode set, a mixed soak compiles nothing); on the
    port's: the soak builds no kernel and allocates no pool tensor,
    target or draft."""
    target = _xf(api, seed=7)
    draft = api.like(target, max_slots=2, page=32, max_pages_per_slot=18)
    eng = api.engine(
        _xf(api, seed=7), name="ledset", chunk=16, prefix_cache=True,
        speculative=api.S.SpeculativeConfig(draft=draft, k=3)).warmup()
    if api.pkg == "jax":
        led = compile_ledger.get_ledger()
        recs = [r for r in led.describe()
                if r["site"].startswith("decode:ledset:")]
        assert {r["site"] for r in recs} == {
            "decode:ledset:step", "decode:ledset:prefill",
            "decode:ledset:verify", "decode:ledset:draft_step",
            "decode:ledset:draft_prefill"}
    before = _steady(api, eng)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(list(rng.integers(0, 40, size=n)), 6)
            for n in (40, 3, 75, 18, 51)]
    for r in reqs:
        assert len(r.result(timeout=180.0)) == 6
    assert _steady(api, eng) == before
    eng.close()


# ---------------------------------------------------------------------------
# TestPrefixCache
# ---------------------------------------------------------------------------

def test_shared_256_prefix_prefills_only_suffix(api):
    inst = _Inst()
    eng = api.engine(_xf(api, seed=5), name="pfx", chunk=32,
                     prefix_cache=True, instruments=inst).warmup()
    rng = np.random.default_rng(4)
    shared = list(rng.integers(0, 40, size=256))
    p1 = shared + list(rng.integers(0, 40, size=9))
    p2 = shared + list(rng.integers(0, 40, size=14))
    r1 = eng.submit(p1, 6)
    cold = r1.result(timeout=180.0)
    cold_boundaries = r1.ttft_boundaries
    r2 = eng.submit(p2, 6)
    r2.result(timeout=180.0)
    assert inst.prefix_hits.value == 1
    assert r2.ttft_boundaries <= 2
    assert cold_boundaries >= 8
    r3 = eng.submit(p1, 6)
    assert r3.result(timeout=180.0) == cold
    assert r3.ttft_boundaries <= 2
    assert inst.prefix_hits.value == 2 and inst.prefix_misses.value == 1
    eng.close()


def test_no_page_leaks_after_mixed_shared_prefix_soak(api):
    eng = api.engine(_xf(api, seed=6, max_slots=3, max_len=192,
                         max_pages_per_slot=6, page=32),
                     name="leak", chunk=32, prefix_cache=True).warmup()
    rng = np.random.default_rng(2)
    shared = list(rng.integers(0, 40, size=64))
    reqs = []
    for i in range(8):
        tail = list(rng.integers(0, 40, size=3 + i))
        reqs.append(eng.submit(shared + tail, 5))
    for i in range(4):
        reqs.append(eng.submit(list(rng.integers(0, 40, size=20 + i)), 5))
    for r in reqs:
        assert len(r.result(timeout=180.0)) == 5
    assert eng._kv.used_pages > 0
    eng.clear_prefix_cache()
    assert eng._kv.free_pages == eng._kv.n_pages
    eng.close()


def test_head_of_line_reclaims_idle_cached_pages(api):
    m = api.xf(vocab=40, hidden=16, n_layers=1, n_heads=2, max_len=64,
               max_slots=1, page=8, max_pages_per_slot=8, n_pages=8,
               seed=3)
    eng = api.engine(m, name="hol", chunk=8, prefix_cache=True).warmup()
    pa = list(np.random.default_rng(0).integers(0, 40, size=40))
    pb = list(np.random.default_rng(9).integers(0, 40, size=40))
    eng.decode(pa, 8, timeout=120.0)
    assert eng._kv.free_pages < eng._kv.pages_for(48)
    assert len(eng.decode(pb, 8, timeout=60.0)) == 8
    eng.close()


def test_exhaustion_under_shared_prefixes_resolves_by_adoption(api):
    m = api.xf(vocab=40, hidden=16, n_layers=1, n_heads=2, max_len=64,
               max_slots=2, page=8, max_pages_per_slot=8, n_pages=8,
               seed=3)
    eng = api.engine(m, name="shx", chunk=8, prefix_cache=True).warmup()
    prompt = list(np.random.default_rng(5).integers(0, 40, size=40))
    r1 = eng.submit(prompt, 8)
    r2 = eng.submit(prompt + [7], 8)
    out1 = r1.result(timeout=120.0)
    out2 = r2.result(timeout=120.0)
    assert len(out1) == 8 and len(out2) == 8
    assert eng._pcache.hits >= 1
    eng.close()


# ---------------------------------------------------------------------------
# TestSpeculative
# ---------------------------------------------------------------------------

def test_perfect_draft_greedy_identity_and_acceptance(api):
    target = _xf(api, seed=5, max_len=256, max_pages_per_slot=8)
    draft = api.like(target, max_slots=2, page=32, max_pages_per_slot=8)
    prompt = list(np.random.default_rng(1).integers(0, 40, size=20))
    ref = offline_decode(api, target, prompt, 24)
    inst = _Inst()
    eng = api.engine(
        _xf(api, seed=5, max_len=256, max_pages_per_slot=8),
        name="specm", instruments=inst,
        speculative=api.S.SpeculativeConfig(draft=draft, k=4)).warmup()
    req = eng.submit(prompt, 24)
    assert req.result(timeout=180.0) == ref
    boundaries = eng._spec._boundaries
    assert boundaries > 0
    assert inst.accepts["accepted"] / boundaries > 1.0
    assert eng._spec._fallback is False
    eng.close()


def test_weak_draft_identity_and_clean_fallback(api):
    target = _xf(api, seed=5, max_len=256, max_pages_per_slot=8)

    class _ShiftedDraft(api.XF):
        def _apply(self, params, state, tokens, pos, table, pidx):
            nxt, st = super()._apply(params, state, tokens, pos, table,
                                     pidx)
            return (nxt + 1) % self.vocab, st

    weak = api.like(target, cls=_ShiftedDraft, max_slots=2, page=32,
                    max_pages_per_slot=8)
    prompt = list(np.random.default_rng(6).integers(0, 40, size=16))
    ref = offline_decode(api, target, prompt, 32)
    eng = api.engine(
        _xf(api, seed=5, max_len=256, max_pages_per_slot=8),
        name="specw",
        speculative=api.S.SpeculativeConfig(
            draft=weak, k=4, min_acceptance=0.95,
            warmup_boundaries=2, probe_every=8)).warmup()
    req = eng.submit(prompt, 32)
    assert req.result(timeout=180.0) == ref
    assert eng._spec._fallback is True
    h = eng.health()["speculative"]
    assert h["fallback"] is True and h["acceptance_ewma"] < 0.95
    eng.close()


def test_speculative_composes_with_prefix_cache(api):
    target = _xf(api, seed=5, max_len=256, max_pages_per_slot=8)
    draft = api.like(target, max_slots=2, page=32, max_pages_per_slot=8)
    eng = api.engine(
        _xf(api, seed=5, max_len=256, max_pages_per_slot=8),
        name="specpfx", chunk=32, prefix_cache=True,
        speculative=api.S.SpeculativeConfig(draft=draft, k=3)).warmup()
    prompt = list(np.random.default_rng(3).integers(0, 40, size=70))
    cold = eng.decode(prompt, 10, timeout=180.0)
    warm = eng.submit(prompt, 10)
    assert warm.result(timeout=180.0) == cold
    assert warm.ttft_boundaries <= 2
    eng.clear_prefix_cache()
    assert eng._kv.free_pages == eng._kv.n_pages
    eng.close()


def test_config_validation(api):
    target = _xf(api, seed=5)
    SC, DE = api.S.SpeculativeConfig, api.D.DecodeError
    with pytest.raises(DE):
        api.engine(target, speculative=SC(draft=_xf(api, seed=5, vocab=24),
                                          k=2))
    with pytest.raises(DE):
        api.engine(target, speculative=SC(
            draft=_xf(api, seed=5, max_slots=4), k=2))
    with pytest.raises(DE):
        api.engine(target, speculative=SC(
            draft=_xf(api, seed=5, page=16, max_pages_per_slot=36), k=2))
    with pytest.raises(DE):
        api.engine(target, speculative=SC(
            draft=_xf(api, seed=5, max_pages_per_slot=4), k=2))
    with pytest.raises(DE):
        api.engine(target, speculative=SC(draft=_xf(api, seed=5), k=0))
    rnn = api.S.RnnDecodeModel(api.rnn_net(seed=1, vocab=40, hidden=8),
                               max_slots=2)
    with pytest.raises(DE):
        api.engine(rnn, speculative=SC(draft=_xf(api, seed=5), k=2))
    with pytest.raises(DE):
        api.engine(rnn, prefix_cache=True)


# ---------------------------------------------------------------------------
# health and soak
# ---------------------------------------------------------------------------

def test_health_sections_and_backlog_degradation(api):
    eng = api.engine(_xf(api, seed=5), name="hlth", chunk=16,
                     prefix_cache=True, backlog_timeout=0.05).warmup()
    h = eng.health()
    assert h["prefill"]["chunk"] == 16
    assert h["kv_pages"]["total"] == eng._kv.n_pages
    assert h["prefix_cache"]["pages"] == 0
    assert not h["degraded"]
    stale = api.D._DecodeRequest([1, 2, 3], 4, None, 999)
    stale.t_submit -= 100.0
    eng._waiting.append(stale)
    try:
        h2 = eng.health()
        assert h2["prefill"]["starved"] is True
        assert h2["degraded"] is True
    finally:
        eng._waiting.remove(stale)
    assert eng.health()["degraded"] is False
    eng.close()


def test_mixed_arm_soak(api):
    """Chunked + prefix + speculative under four concurrent clients, and
    the pool leak-free afterwards."""
    target = _xf(api, seed=5, max_slots=3, max_len=256,
                 max_pages_per_slot=8)
    draft = api.like(target, max_slots=3, page=32, max_pages_per_slot=8)
    eng = api.engine(
        target, name="soak12", chunk=32, prefix_cache=True,
        speculative=api.S.SpeculativeConfig(draft=draft, k=3)).warmup()
    shared = list(np.random.default_rng(7).integers(0, 40, size=64))
    errors = []

    def client(i):
        try:
            rng = np.random.default_rng(100 + i)
            for k in range(4):
                prompt = (shared + list(rng.integers(0, 40, size=2 + i + k))
                          if k % 2 == 0
                          else list(rng.integers(0, 40, size=10 + i)))
                toks = eng.decode(prompt, 6, timeout=180.0)
                assert len(toks) == 6
        except Exception as e:   # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    eng.clear_prefix_cache()
    assert eng._kv.free_pages == eng._kv.n_pages
    eng.close()


# ---------------------------------------------------------------------------
# the memory ledger's decode seams (tests/test_memledger.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_ledger(api):
    """A fresh ledger and flight ring in the package under test;
    telemetry enabled, the budget unset."""
    led = api.memledger
    prev = led.set_ledger(led.MemLedger())
    led.configure(budget_bytes=None, enabled=True)
    flight_mod = (jax_telemetry.flight if api.pkg == "jax"
                  else port_flight)
    flight_mod.get_recorder().clear()
    yield led, flight_mod
    led.set_ledger(prev)
    led.configure(budget_bytes=None, enabled=True)


def _paged_model(api, hidden=16, **kw):
    d = dict(vocab=32, n_layers=1, n_heads=2, max_len=64, max_slots=2,
             page=8, max_pages_per_slot=4, seed=0)
    d.update(kw)
    return api.xf(hidden=hidden, **d)


def test_kv_claims_and_health_bytes_both_lanes(api, fresh_ledger):
    led_mod, _ = fresh_ledger
    target = _paged_model(api, hidden=16)
    draft = _paged_model(api, hidden=8)
    engine = api.engine(target, name="memdec",
                        speculative=api.S.SpeculativeConfig(draft=draft,
                                                            k=2))
    led = led_mod.get_memledger()
    by_name = {c.name: c for c in led.claims("kv_cache")}
    assert by_name["memdec:target"].bytes == \
        led_mod.tree_bytes(engine._state) > 0
    assert by_name["memdec:draft"].bytes == engine._spec.pool_bytes > 0
    h = engine.health()
    assert h["kv_pages"]["pool_bytes"] == by_name["memdec:target"].bytes
    assert h["kv_pages"]["used_bytes"] == 0
    assert h["speculative"]["kv_pages"]["pool_bytes"] == \
        by_name["memdec:draft"].bytes
    engine.close()
    assert led.claims("kv_cache") == []


def test_failed_engine_init_leaks_no_claim(api, fresh_ledger):
    led_mod, _ = fresh_ledger
    target = _paged_model(api, hidden=16)
    bad_draft = _paged_model(api, hidden=8, page=4)
    with pytest.raises(api.D.DecodeError):
        api.engine(target, name="leaky",
                   speculative=api.S.SpeculativeConfig(draft=bad_draft))
    assert led_mod.get_memledger().claims("kv_cache") == []


def test_health_used_bytes_track_reservation(api, fresh_ledger):
    engine = api.engine(_paged_model(api), name="memdec2").warmup()
    engine.submit([1, 2, 3], max_new_tokens=4).result(timeout=30)
    h = engine.health()
    assert h["kv_pages"]["pool_bytes"] > 0
    assert h["kv_pages"]["used_bytes"] == (
        h["kv_pages"]["pool_bytes"] // (engine.model.n_pages + 1)) * (
            engine.model.n_pages - h["kv_pages"]["free"])
    engine.close()


def test_decode_boundary_seam(api, fresh_ledger):
    led_mod, flight_mod = fresh_ledger
    model = api.xf(vocab=32, hidden=16, n_layers=1, n_heads=2, max_len=64,
                   max_slots=2, page=8, max_pages_per_slot=4)
    engine = api.engine(model, name="oomdec").warmup()

    def boom(*a, **k):
        if api.pkg == "jax":
            from deeplearning4j_tpu.resilience.faults import InjectedOom
            raise InjectedOom(nbytes=9999, where="decode step")
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 9.76 KiB.")

    model.step = boom
    req = engine.submit([1, 2], max_new_tokens=3)
    with pytest.raises(led_mod.DeviceOomError) as ei:
        req.result(timeout=30)
    assert ei.value.site == "decode:oomdec:step"
    assert ei.value.requested_bytes in (9999, 9994)
    evts = [e for e in flight_mod.get_recorder().events("oom")
            if e["site"] == "decode:oomdec:step"]
    assert evts
    engine.close()


def test_non_oom_boundary_failure_is_a_runtime_error(api):
    model = api.xf(vocab=32, hidden=16, n_layers=1, n_heads=2, max_len=64,
                   max_slots=2, page=8, max_pages_per_slot=4)
    engine = api.engine(model, name="errdec", chunk=4).warmup()
    real = engine._block.run

    def broken(*a, **k):
        raise ValueError("launch failed")

    engine._block.run = broken
    req = engine.submit([1, 2, 3, 4, 5, 6], max_new_tokens=3)
    with pytest.raises(RuntimeError, match="chunk prefill failed"):
        req.result(timeout=30)
    engine._block.run = real
    # the engine thread survives the failed boundary
    assert len(engine.decode([1, 2, 3, 4, 5, 6], 3, timeout=30)) == 3
    engine.close()


def test_oversized_kv_pool_rejected_before_allocation(api, fresh_ledger,
                                                      monkeypatch):
    led_mod, flight_mod = fresh_ledger
    model = api.xf(vocab=32, hidden=64, n_layers=4, n_heads=2,
                   max_len=4096, max_slots=8, page=16,
                   max_pages_per_slot=256, n_pages=2048)
    allocated = []
    real_init = model.init_state
    if api.pkg == "torch":
        def spy(device=None):
            if device is None:
                allocated.append(True)
            return real_init(device=device)
        model.init_state = spy
    led_mod.configure(budget_bytes=100_000)
    try:
        with pytest.raises(led_mod.CapacityError) as ei:
            api.engine(model, name="toolargekv")
    finally:
        led_mod.configure(budget_bytes=None)
    assert ei.value.site == "decode:toolargekv:kv"
    assert ei.value.detail["lane"] == "target"
    assert ei.value.need_bytes == 4 * 2049 * 16 * 64 * 4 * 2
    assert allocated == []
    assert led_mod.get_memledger().claims("kv_cache") == []
    plans = flight_mod.get_recorder().events("capacity_plan")
    assert plans and plans[-1]["fits"] is False


def test_planner_skipped_when_capacity_unknown(api, fresh_ledger):
    led_mod, flight_mod = fresh_ledger
    assert not led_mod.capacity_known()
    flight_mod.get_recorder().clear()
    eng = api.engine(_paged_model(api), name="cheap")
    assert flight_mod.get_recorder().events("capacity_plan") == []
    eng.close()


def test_unknown_headroom_admits(api, fresh_ledger):
    led_mod, _ = fresh_ledger
    plan = led_mod.plan_capacity("probe", 1 << 40)
    assert plan["fits"] and plan["headroom_bytes"] is None


def test_fitting_pool_admitted_with_budget(fresh_ledger, api):
    led_mod, flight_mod = fresh_ledger
    led_mod.configure(budget_bytes=1 << 30)
    try:
        eng = api.engine(_paged_model(api), name="fits")
    finally:
        led_mod.configure(budget_bytes=None)
    plans = flight_mod.get_recorder().events("capacity_plan")
    assert plans and plans[-1]["fits"] is True
    eng.close()


def test_port_headroom_counts_claims_on_a_budgeted_cpu():
    prev = port_memledger.set_ledger(port_memledger.MemLedger())
    try:
        port_memledger.configure(budget_bytes=10_000)
        assert port_memledger.capacity_known("cpu:0")
        assert port_memledger.headroom("cpu:0") == 10_000
        c = port_memledger.claim("kv_cache", "x", nbytes=4_000,
                                 device="cpu:0")
        assert port_memledger.headroom("cpu:0") == 6_000
        with pytest.raises(port_memledger.CapacityError):
            port_memledger.plan_capacity("y", 7_000, device="cpu:0")
        c.release()
        assert port_memledger.headroom("cpu:0") == 10_000
    finally:
        port_memledger.configure(budget_bytes=None)
        port_memledger.set_ledger(prev)


def test_port_is_oom_and_requested_bytes():
    e = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has ...")
    assert port_memledger.is_oom(e)
    assert port_memledger.requested_bytes(e) == 2 << 30
    assert port_memledger.is_oom(MemoryError())
    assert not port_memledger.is_oom(ValueError("x"))
    assert not port_memledger.is_oom(port_memledger.DeviceOomError("x"))
    assert port_memledger.requested_bytes(RuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory allocating 512 bytes.")) == 512
    assert port_memledger.tree_bytes(
        {"a": [torch.zeros(3, 4, device="meta"), np.zeros(5, np.int16)],
         "b": None}) == 48 + 10


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _margin(logits_fn, row):
    z = np.sort(np.asarray(logits_fn)[row])
    return float(z[-1] - z[-2])


def _xf_pair(**kw):
    return (Api("jax").xf(**kw), Api("torch").xf(**kw))


XF_PARITY = dict(vocab=64, hidden=32, n_layers=2, n_heads=2, max_len=64,
                 max_slots=3, page=8, max_pages_per_slot=8, seed=21,
                 scale=0.3)


def test_transformer_teacher_forced_parity():
    """Both packages' models, fed the same tokens at the same positions
    (three slots at different depths, one masked in some steps), hold
    their pools within 1e-5 of the largest element after every step,
    page 0 aside, and answer the same tokens."""
    jm, pm = _xf_pair(**XF_PARITY)
    S = jm.max_slots
    kv = jax_decode.PagedKVCache(jm.n_pages, jm.page,
                                 jm.max_pages_per_slot, S)
    for s, n in enumerate((60, 40, 25)):
        kv.reserve(s, n)
    table = kv.table.copy()
    js, ps = jm.init_state(), pm.init_state()
    rng = np.random.default_rng(0)
    feeds = rng.integers(0, 64, size=(60, S)).astype(np.int32)
    worst = 0.0
    for i in range(60):
        pos = np.array([i, max(0, i - 20), i // 3], np.int32)
        active = np.array([True, i >= 20, i % 4 != 1])
        tok = feeds[i]
        if i % 5 == 0:
            jn, js = jm.step(js, tok, pos, table)
            pn, ps = pm.step(ps, tok, pos, table)
            rows = range(S)
        else:
            jn, js = jm.step_masked(js, tok, pos, table, active)
            pn, ps = pm.step_masked(ps, tok, pos, table, active)
            rows = [s for s in range(S) if active[s]]
        for k in ("k", "v"):
            worst = max(worst, _rel_err(_np(ps[k])[:, 1:],
                                        np.asarray(js[k])[:, 1:]))
        jn, pn = np.asarray(jn), _np(pn)
        for s in rows:
            assert jn[s] == pn[s], (i, s)
        if i % 5:
            assert all(pn[s] == -1 for s in range(S) if not active[s])
    assert worst <= PARITY_TOL, worst


def test_rnn_teacher_forced_parity():
    """The char-RNN's carries after every step (plain and masked) within
    1e-5 of the largest element, tokens equal."""
    jnet = _jax_char_rnn(4, 11, 12, 11)
    pnet = _port_net(jnet)
    jm = jax_decode.RnnDecodeModel(jnet, max_slots=4)
    pm = port_decode.RnnDecodeModel(pnet, max_slots=4)
    js, ps = jm.init_state(), pm.init_state()
    table = np.zeros((4, 1), np.int32)
    rng = np.random.default_rng(1)
    worst = 0.0
    for i in range(40):
        tok = rng.integers(0, 11, size=4).astype(np.int32)
        pos = np.full((4,), i, np.int32)
        if i % 3 == 0:
            jn, js = jm.step(js, tok, pos, table)
            pn, ps = pm.step(ps, tok, pos, table)
        else:
            active = rng.random(4) < 0.6
            jn, js = jm.step_masked(js, tok, pos, table, active)
            pn, ps = pm.step_masked(ps, tok, pos, table, active)
        assert np.array_equal(np.asarray(jn), _np(pn)), i
        for k in ("h", "c"):
            worst = max(worst, _rel_err(_np(ps[0][k]),
                                        np.asarray(js[0][k])))
        if i == 7:
            js, ps = jm.reset_slot(js, 2), pm.reset_slot(ps, 2)
            assert not _np(ps[0]["h"])[2].any()
    assert pm.steps == 40
    assert worst <= PARITY_TOL, worst


def _arm_streams(api, arm, rnn):
    if rnn:
        net = api.rnn_net(seed=9, vocab=11, hidden=12)
        model = api.S.RnnDecodeModel(net, max_slots=3)
        kw = {"chunk": 5} if arm == "chunk" else {}
        prompts = [[3, 1, 4, 1, 5, 9, 2], [7], [2, 2, 8, 1], [10, 0]]
    else:
        model = api.xf(**XF_PARITY)
        kw = {"plain": {}, "chunk": {"chunk": 8},
              "prefix": {"chunk": 8, "prefix_cache": True},
              "spec": {}}[arm]
        if arm == "spec":
            draft = api.XF(
                {**model.params, "layers": model.params["layers"][:1]},
                n_heads=2, max_slots=3, page=8, max_pages_per_slot=8,
                **api.kw)
            kw = {"speculative": api.S.SpeculativeConfig(draft=draft,
                                                         k=3)}
        rng = np.random.default_rng(2)
        shared = [int(t) for t in rng.integers(0, 64, size=17)]
        prompts = [shared + [5, 6], [7, 1], shared + [9],
                   [int(t) for t in rng.integers(0, 64, size=30)]]
    eng = api.engine(model, name=f"par-{arm}", **kw).warmup()
    reqs = [eng.submit(p, 12) for p in prompts]
    out = [r.result(timeout=120.0) for r in reqs]
    out.append(eng.decode(prompts[0], 12, timeout=120.0))
    eng.close()
    return out


@pytest.mark.parametrize("arm,rnn", [("plain", False), ("chunk", False),
                                     ("prefix", False), ("spec", False),
                                     ("plain", True), ("chunk", True)])
def test_engine_streams_match_jax(arm, rnn):
    """The port's engine emits the JAX engine's tokens for the same
    weights and traffic, under every arm; and every arm's streams equal
    the plain arm's (chunked, prefix-cached and speculative decoding are
    greedy-identical)."""
    got = _arm_streams(Api("torch"), arm, rnn)
    want = _arm_streams(Api("jax"), arm, rnn)
    assert got == want
    assert got[0] == got[-1]          # alone vs wedged
    assert got == _arm_streams(Api("torch"), "plain", rnn)


# ---------------------------------------------------------------------------
# pools written in place
# ---------------------------------------------------------------------------

def _snapshot(state):
    if isinstance(state, dict):
        return {k: v.clone() for k, v in state.items()}
    return [{k: v.clone() for k, v in s.items()} if isinstance(s, dict)
            else s for s in state]


def test_warmup_leaves_the_transformer_state_page_0_aside():
    api = Api("torch")
    target = api.xf(**XF_PARITY)
    draft = api.like(target, max_slots=3, page=8, max_pages_per_slot=8)
    eng = api.engine(target, name="wu", chunk=4,
                     speculative=api.S.SpeculativeConfig(draft=draft, k=2))
    # give every page of both pools a value, as traffic would
    for st in (eng._state, eng._spec._state):
        for v in st.values():
            with torch.inference_mode():
                v.copy_(torch.randn(v.shape, generator=torch.Generator()
                                    .manual_seed(3)))
    before = _snapshot(eng._state)
    before_d = _snapshot(eng._spec._state)
    ptrs = _steady(api, eng)
    eng.warmup()
    for k in ("k", "v"):
        assert torch.equal(eng._state[k][:, 1:], before[k][:, 1:])
        assert torch.equal(eng._spec._state[k][:, 1:], before_d[k][:, 1:])
    assert _steady(api, eng) == ptrs
    eng.close()


def test_warmup_leaves_the_rnn_state():
    api = Api("torch")
    model = api.S.RnnDecodeModel(api.rnn_net(), max_slots=3)
    eng = api.engine(model, name="wu-rnn", chunk=4)
    with torch.inference_mode():
        eng._state = list(eng._state)
        eng._state[0] = {k: torch.randn(v.shape) for k, v in
                         eng._state[0].items()}
    before = _snapshot(eng._state)
    eng.warmup()
    for k in ("h", "c"):
        # slot 0 is reset, as in the reference; the other rows are kept
        assert not eng._state[0][k][0].any()
        assert torch.equal(eng._state[0][k][1:], before[0][k][1:])
    eng.close()


def test_masked_and_block_writes_land_only_on_page_0():
    api = Api("torch")
    model = api.xf(**XF_PARITY)
    kv = port_decode.PagedKVCache(model.n_pages, model.page,
                                  model.max_pages_per_slot, 3)
    kv.reserve(0, 30)
    kv.reserve(2, 9)
    table = kv.table.copy()
    state = model.init_state()
    with torch.inference_mode():
        for v in state.values():
            v.copy_(torch.randn(v.shape))
    before = _snapshot(state)
    z = np.zeros((3,), np.int32)
    model.step_masked(state, np.array([4, 5, 6]), np.array([7, 3, 2]),
                      table, np.zeros((3,), bool))
    block = port_serving.ChunkedPrefill(model, 6)
    outs, state = block.run(state, np.ones((3, 6), np.int32), z, z, table)
    assert (outs == -1).all()
    block.warmup(state, table)
    for k in ("k", "v"):
        assert torch.equal(state[k][:, 1:], before[k][:, 1:])
    # an active write lands on the slot's page at its offset, nowhere else
    outs, state = block.run(state, np.full((3, 6), 9, np.int32),
                            np.array([10, 0, 0], np.int32),
                            np.array([2, 0, 0], np.int32), table)
    assert (outs[0, :2] >= 0).all() and (outs[:, 2:] == -1).all()
    page = kv.owned(0)[1]               # positions 10, 11: page 1 of slot 0
    changed = (state["k"] != before["k"]).any(dim=(0, 3, 4))
    changed[0] = False
    assert changed.nonzero().tolist() == [[page, 2], [page, 3]]


def test_engine_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serving.TransformerDecodeModel.init(vocab=8, hidden=8,
                                                 n_layers=1, n_heads=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serving.TransformerDecodeModel(
            _jax_params(8, 8, 1, 2, 16, 0), n_heads=2)
    m = port_serving.TransformerDecodeModel.init(
        vocab=8, hidden=8, n_layers=1, n_heads=2, max_len=16,
        device="cpu")
    assert m.device.type == "cpu" and m.params["tok_emb"].device.type \
        == "cpu"
    eng = port_serving.DecodeEngine(m, name="cpu-named")
    assert eng._state["k"].device.type == "cpu"
    assert eng._plan_device == "cpu:0"
    eng.close()


# ---------------------------------------------------------------------------
# on the card (skipped without CUDA)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_rnn_engine_matches_cpu_and_launches_row_2(cuda):
    from deeplearning4j_tpu_torch.kernels import lstm
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM

    gpu = TextGenerationLSTM(vocabSize=20, hidden=64, seqLength=8).init()
    cpu = MultiLayerNetwork(gpu.conf, device="cpu").init(
        [{k: v.detach().cpu().clone() for k, v in p.items()}
         for p in gpu._params])
    prompts = [[3, 1, 4, 1, 5], [9], [2, 6, 5, 3, 5, 8, 9, 7]]
    outs = {}
    for name, net in (("gpu", gpu), ("cpu", cpu)):
        model = port_serving.RnnDecodeModel(net, max_slots=4)
        eng = port_serving.DecodeEngine(model, name=f"c-{name}", chunk=3)
        eng.warmup()
        before, steps = lstm.lstm_seq_infer.launches, model.steps
        outs[name] = [eng.submit(p, 10).result(timeout=120)
                      for p in prompts]
        launched = lstm.lstm_seq_infer.launches - before
        eng.close()
        if name == "gpu":
            assert launched == 2 * (model.steps - steps) > 0
            assert eng._state[0]["h"].device.type == "cuda"
        else:
            assert launched == 0
    assert outs["gpu"] == outs["cpu"]


@pytest.mark.cuda
def test_cuda_transformer_engine_matches_cpu(cuda):
    p = _np_params(64, 32, 2, 64, 21, 0.3)
    outs = {}
    for dev in ("cuda", "cpu"):
        m = port_serving.TransformerDecodeModel(
            bert_params_from_numpy(p, dev), n_heads=2, max_slots=3, page=8,
            max_pages_per_slot=8, device=dev)
        eng = port_serving.DecodeEngine(m, name=f"x-{dev}", chunk=4,
                                        prefix_cache=True).warmup()
        ptr = eng._state["k"].data_ptr()
        outs[dev] = [eng.decode([1, 2, 3, 4, 5, 6, 7, 8, 9], 12,
                                timeout=120),
                     eng.decode([5], 12, timeout=120)]
        assert eng._state["k"].data_ptr() == ptr
        eng.close()
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
def test_cuda_session_defaults_to_the_card(cuda):
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM

    net = TextGenerationLSTM(vocabSize=12, hidden=32, seqLength=8).init()
    with port_serving.InferenceSession() as sess:
        eng = sess.register_decoder(
            "c", port_serving.RnnDecodeModel(net, max_slots=2))
        assert eng.device.type == "cuda"
        assert len(sess.decode("c", [1, 2], 5, timeout=60)) == 5
