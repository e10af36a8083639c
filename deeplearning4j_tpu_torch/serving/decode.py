"""Continuous (iteration-level) batching for autoregressive decode.

Counterpart of ``deeplearning4j_tpu/serving/decode.py``. Request-level
batching runs a batch start to finish, so a 5-token completion waits for
the 200-token one beside it. Token streams need iteration-level batching:
the device runs ONE token step for every in-flight sequence per
iteration, new sequences join at any token boundary, and finished ones
free their slot at once.

Fixed shapes everywhere: every step runs at ``[max_slots]`` token vectors
over a preallocated paged KV pool. Joins and leaves change the CONTENT of
slots, never a shape, and the steady state allocates no pool tensor (the
pool's storage stays the same across joins and leaves; asserted in
tests).

The KV cache is PAGED (`PagedKVCache`): a pool of fixed-size
``[page]``-token blocks with a per-slot page table. A joining sequence
reserves ``ceil(total_len / page)`` pages up front (no mid-flight
eviction), a leaving one returns them; page 0 is a scratch page that idle
and masked slots write into, so the step stays branch-free.

Two models:

- `RnnDecodeModel`: a `MultiLayerNetwork` with recurrent layers; slot
  state is the per-slot ``{h, c}`` carry rows (``rnnTimeStep``'s state,
  batched over slots). Each step feeds every slot one token as a one-hot
  [S, nIn, 1] timestep through the net's own ``_forward``, so on the GPU
  every LSTM layer launches its inference kernel (``kernels/lstm.py``
  ``lstm_seq_infer``) at T = 1, N = ``max_slots``. Params are read live
  from the net at every step.
- `TransformerDecodeModel`: causal decode-only transformer over the paged
  KV pool, the post-LN block of ``models/bert.py`` (qkv/out/ln1/ffn/ln2,
  tanh-approximate gelu, population variance, a tied float32 LM head, no
  type embedding), so `from_bert()` serves a BERT encoder's weights as a
  token stream. Params and pools are float32 whatever the BERT config's
  compute dtype. Its GEMMs are cuBLAS's and its attention plain PyTorch
  ops, as the JAX package leaves both to XLA.

Per-sequence determinism: every op along a slot's path is row-wise (LSTM
carries, masked paged attention, layer norm, argmax) at fixed shapes, so a
sequence's tokens are BIT-IDENTICAL whether it decodes alone or wedged
between strangers, and chunked prefill and speculative decoding (which
run the same masked step) give the per-token stream bit for bit.

Where the port differs by design:

- the KV pools are written IN PLACE (``index_put_`` into the preallocated
  ``[L, n_pages + 1, page, H, D]`` tensors, which a step returns as they
  are): the reference's functional ``.at[].set`` + ``stack`` would copy
  the whole pool every token. This is safe because every write that the
  reference throws away lands on scratch page 0: masked slots, the block
  steps past a slot's count, and `warmup`, which runs its step on an
  all-scratch page table. Duplicate writes into page 0 (several idle
  slots) are unordered on CUDA; nothing reads page 0 unmasked. The RNN
  carries stay functional ([S, H], cheap to replace);
- the paged attention computes each slot's whole page list at once
  (gather, the causal/length mask, one softmax) where the reference
  iterates pages with an online softmax: the same function, masked
  entries exactly zero, to float32 rounding of the reference;
- no compile ledger and no executable store: PyTorch runs eagerly, so
  there is nothing to compile or to persist;
- the sharded-mesh lanes are not ported yet (ROADMAP.md, queue 1 item
  12). The tracing spans (``decode.queue``, one ``decode.prefill`` /
  ``decode.token`` / ``decode.prefill_chunk`` / ``decode.speculate``
  span a boundary a sampled request rides, up to ``boundary_span_cap``,
  then one aggregate ``decode.tokens``) and the session's instruments are
  the reference's;
- a model's device is "cuda" unless the caller names the CPU. The engine
  runs on its model's device, its worker thread under
  ``torch.inference_mode()``; reading a boundary's next tokens back to the
  host is its one synchronisation. A failed step (a kernel launch that
  fails included) fails that boundary's requests with the typed error of
  `_boundary_error` and is never re-run on a plain version.
"""

from __future__ import annotations

import math
import queue as _queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.models.bert import (
    BertConfig, _layer_norm, init_params)
from deeplearning4j_tpu_torch.nn.conf.layers import take_rows
from deeplearning4j_tpu_torch.telemetry import flight, memledger, tracing
from deeplearning4j_tpu_torch.tree_util import tree_map


class DecodeError(RuntimeError):
    pass


class DecodeShutdown(RuntimeError):
    """Engine closed with this request still pending."""


def _on(device, a, dtype=torch.int64):
    """A host array (or a tensor) as a ``dtype`` tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)


def _host(t):
    """A tensor's values on the host, as numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


# ---------------------------------------------------------------------------
# paged KV bookkeeping (host side)
# ---------------------------------------------------------------------------

class PagedKVCache:
    """Host-side page accounting for a preallocated device KV pool.

    `n_pages` counts the usable pool (page 0 is reserved scratch for idle
    slots, so the device pool holds ``n_pages + 1`` pages). Allocation is
    all-up-front per sequence: `reserve()` either grants every page the
    sequence can ever touch or refuses.

    Pages are REFCOUNTED: a slot's reservation holds one reference per
    page, and the cross-request `PrefixCache` holds its own on pages it
    has published. A page returns to the free pool only when its last
    reference drops, so after `PrefixCache.clear()` and every slot's
    `release()` the pool is fully free again."""

    def __init__(self, n_pages, page, max_pages_per_slot, max_slots):
        if page < 1 or n_pages < 1:
            raise ValueError(f"need page >= 1 and n_pages >= 1, got "
                             f"page={page} n_pages={n_pages}")
        self.page = int(page)
        self.n_pages = int(n_pages)
        self.max_pages_per_slot = int(max_pages_per_slot)
        # page 0 = scratch; usable pages are 1..n_pages
        self._free = list(range(self.n_pages, 0, -1))
        self.table = np.zeros((max_slots, self.max_pages_per_slot),
                              np.int32)
        self._owned: dict[int, list[int]] = {}
        self._ref: dict[int, int] = {}

    def pages_for(self, total_len: int) -> int:
        return math.ceil(total_len / self.page)

    def can_reserve(self, total_len: int) -> bool:
        need = self.pages_for(total_len)
        return need <= len(self._free) and \
            need <= self.max_pages_per_slot

    def reserve(self, slot: int, total_len: int, adopted=()):
        """Grant every page ``slot`` can ever touch: ``adopted`` pages
        (shared, refcount bumped: the prefix-cache hit) fill the leading
        table entries in position order, fresh pages cover the suffix.
        Refuses rather than partially grants."""
        need = self.pages_for(total_len)
        adopted = list(adopted)
        if need > self.max_pages_per_slot:
            raise DecodeError(
                f"sequence of {total_len} tokens needs {need} pages > "
                f"max_pages_per_slot={self.max_pages_per_slot}")
        if len(adopted) > need:
            raise DecodeError(
                f"adopting {len(adopted)} pages for a {need}-page "
                f"sequence")
        fresh_need = need - len(adopted)
        if fresh_need > len(self._free):
            raise DecodeError(
                f"KV pool exhausted: need {fresh_need} fresh pages, "
                f"{len(self._free)} free")
        if 0 in adopted:
            raise DecodeError("scratch page 0 is never sharable")
        fresh = [self._free.pop() for _ in range(fresh_need)]
        pages = adopted + fresh
        for p in pages:
            self._ref[p] = self._ref.get(p, 0) + 1
        self._owned[slot] = pages
        self.table[slot, :] = 0
        self.table[slot, :need] = pages
        return pages

    def release(self, slot: int):
        pages = self._owned.pop(slot, [])
        for p in reversed(pages):
            self.decref(p)
        self.table[slot, :] = 0

    def retain(self, page: int):
        """An extra reference (the prefix cache publishing a page)."""
        if page == 0:
            raise DecodeError("scratch page 0 is never sharable")
        self._ref[page] = self._ref.get(page, 0) + 1

    def decref(self, page: int) -> bool:
        """Drop one reference; the page returns to the free pool when
        nobody holds it anymore. Returns True when freed."""
        n = self._ref.get(page, 0) - 1
        if n > 0:
            self._ref[page] = n
            return False
        self._ref.pop(page, None)
        self._free.append(page)
        return True

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def owned(self, slot: int) -> list:
        """The slot's page list in position order (adopted prefix
        first): what the prefix cache publishes from."""
        return list(self._owned.get(slot, ()))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)


def _boundary_error(e, site, what):
    """The failure a request sees when its boundary failed: a typed
    DeviceOomError (and a flight ``oom`` event naming the site and the top
    claims) when the step died on an allocation, else a RuntimeError
    naming the step and the cause."""
    err = memledger.oom_error(e, site=site)
    if err is not None:
        return err
    return RuntimeError(f"{what}: {type(e).__name__}: {e}")


def _pool_bytes_estimate(model):
    """Bytes a paged model's KV pool will pin, from ``init_state`` on the
    "meta" device: shapes only, nothing allocated. None when the model
    cannot say (the planner then does not guess)."""
    try:
        return memledger.tree_bytes(model.init_state(device="meta"))
    except Exception:   # noqa: BLE001 - a model the planner cannot size
        return None


# ---------------------------------------------------------------------------
# decode models
# ---------------------------------------------------------------------------

class RnnDecodeModel:
    """Token-step decode over a MultiLayerNetwork with recurrent layers
    (the char-RNN as a token stream).

    Slot state = the network's streaming carry, batched over ``max_slots``
    rows; a step feeds every slot its next token id as a one-hot [S, nIn,
    1] timestep through the net's own ``_forward``: the math of
    ``rnnTimeStep``. Params are read live from the net at every step.
    The model runs on the net's device. ``steps`` counts the steps,
    masked steps and block columns dispatched (each one forward of the
    net)."""

    uses_pages = False
    page = None

    def __init__(self, net, max_slots=8, vocab=None):
        net._check_init()
        self.net = net
        self.device = net.device
        self.max_slots = int(max_slots)
        self._rec = set(net._recurrent_indices(forbid_bidirectional=True))
        if not self._rec:
            raise DecodeError("RnnDecodeModel needs at least one "
                              "recurrent layer")
        self.n_in = net.layers[0].nIn
        self.vocab = int(vocab) if vocab is not None else int(self.n_in)
        self.steps = 0

    # state: the full per-layer states list with recurrent carries seeded
    # to [max_slots] rows
    def init_state(self):
        with torch.inference_mode():
            return self.net._seed_rnn_states(self.net._states,
                                             self.max_slots)

    def _fn(self, params, state, tokens, pos, table):
        self.steps += 1
        with torch.inference_mode():
            tok = _on(self.device, tokens)
            # one-hot by comparison: an id outside [0, nIn) is a zero row,
            # as jax.nn.one_hot gives
            ids = torch.arange(self.n_in, device=self.device)
            x = (tok[:, None] == ids[None, :]).to(torch.float32)[:, :, None]
            y, new_state = self.net._forward(params, state, x)
            logits = y[:, :, 0].float()
            nxt = torch.argmax(logits[:, :self.vocab], dim=-1)
        return nxt, new_state

    def masked_fn(self, params, state, tokens, pos, table, active):
        """The step gated per slot: inactive rows keep their carries
        bitwise (``torch.where`` on the carry rows) and answer -1; active
        rows compute exactly ``_fn``. Chunked prefill composes this, which
        is what makes it bit-identical to the per-token path."""
        nxt, new_state = self._fn(params, state, tokens, pos, table)
        with torch.inference_mode():
            act = _on(self.device, active, torch.bool)
            out = list(new_state)
            for i in self._rec:
                out[i] = {
                    k: torch.where(
                        act.reshape((-1,) + (1,) * (v.dim() - 1)),
                        v, state[i][k])
                    for k, v in new_state[i].items()}
            return torch.where(act, nxt, torch.full_like(nxt, -1)), out

    def _reset_fn(self, state, slot):
        with torch.inference_mode():
            out = list(state)
            idx = torch.tensor([int(slot)], device=self.device)
            for i in self._rec:
                out[i] = {k: v.index_fill(0, idx, 0)
                          for k, v in state[i].items()}
            return out

    def params_for_step(self):
        # read live from the net at every dispatch (never captured)
        return self.net._compute_params(self.net._params)

    def step(self, state, tokens, pos, table):
        return self._fn(self.params_for_step(), state, tokens, pos, table)

    def step_masked(self, state, tokens, pos, table, active):
        return self.masked_fn(self.params_for_step(), state, tokens, pos,
                              table, np.ascontiguousarray(active, bool))

    def reset_slot(self, state, slot):
        return self._reset_fn(state, slot)


def _params_on(params, device):
    """A parameter tree (tensors or numpy leaves) as float32 tensors on
    ``device``; tensors already there are used as they are."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=device, dtype=torch.float32)
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return tree_map(leaf, params)


class TransformerDecodeModel:
    """Causal single-token decode over a paged KV pool.

    The post-LN encoder block of ``models/bert.py`` (qkv/out/ln1/ffn/ln2
    naming, gelu FFN, tied LM head), so `from_bert()` serves an encoder's
    weights as a token stream. A slot attends over its OWN page-table
    pages, all of them at once, with the causal/length mask. The model
    runs on ``device`` ("cuda" unless the CPU is named)."""

    uses_pages = True

    def __init__(self, params, n_heads, max_slots=8, page=16,
                 max_pages_per_slot=8, n_pages=None, eps=1e-12,
                 device=None):
        self.device = resolve_device(device)
        self.params = _params_on(params, self.device)
        self.n_heads = int(n_heads)
        hidden = int(self.params["tok_emb"].shape[1])
        if hidden % self.n_heads:
            raise DecodeError(f"hidden {hidden} not divisible by "
                              f"{n_heads} heads")
        self.hidden = hidden
        self.head_dim = hidden // self.n_heads
        self.vocab = int(self.params["tok_emb"].shape[0])
        self.max_len = int(self.params["pos_emb"].shape[0])
        self.max_slots = int(max_slots)
        self.page = int(page)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.n_pages = (int(n_pages) if n_pages is not None
                        else max_slots * max_pages_per_slot)
        self.eps = eps
        self.n_layers = len(self.params["layers"])

    @classmethod
    def from_bert(cls, params, cfg, **kw):
        """Lift a ``models/bert.py`` param tree into a decode model (cfg:
        BertConfig, for the head count and the LayerNorm eps)."""
        kw.setdefault("page", 16)
        return cls(params, n_heads=cfg.num_heads,
                   eps=cfg.layer_norm_eps, **kw)

    @classmethod
    def init(cls, vocab=64, hidden=32, n_layers=2, n_heads=2,
             max_len=128, seed=0, device=None, **kw):
        """Standalone random init (bert-style param naming), drawn from a
        ``torch.Generator`` seeded with ``seed``."""
        cfg = BertConfig(vocab_size=vocab, hidden=hidden,
                         num_layers=n_layers, num_heads=n_heads,
                         ffn=4 * hidden, max_len=max_len)
        device = resolve_device(device)
        params = init_params(cfg, torch.Generator().manual_seed(int(seed)),
                             device)
        return cls(params, n_heads=n_heads, device=device, **kw)

    # pools: [L, n_pages + 1, page, H, D]; page 0 is scratch
    def init_state(self, device=None):
        dev = self.device if device is None else torch.device(device)
        shape = (self.n_layers, self.n_pages + 1, self.page,
                 self.n_heads, self.head_dim)
        with torch.inference_mode():
            return {"k": torch.zeros(shape, device=dev),
                    "v": torch.zeros(shape, device=dev)}

    def _paged_attention(self, q, kpool, vpool, table, valid):
        """q [S,H,D] against each slot's pages, all at once: gather the
        slot's ``max_pages_per_slot`` pages, mask positions past ``pos``
        (causal + length) to -inf, one softmax. Masked entries weigh
        exactly zero, so a slot's output never depends on its neighbours
        or on what its unused pages hold."""
        s_, h_, d_ = q.shape
        span = self.max_pages_per_slot * self.page
        kb = kpool[table].reshape(s_, span, h_, d_)
        vb = vpool[table].reshape(s_, span, h_, d_)
        s = torch.einsum("shd,slhd->shl", q, kb) * (1.0 / math.sqrt(d_))
        s = s.masked_fill(~valid[:, None, :], float("-inf"))
        # position 0 is always valid, so every row's max is finite
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("shl,slhd->shd", p, vb)
        return o / p.sum(dim=-1).clamp_min(1e-30)[..., None]

    def _inputs(self, tokens, pos, table):
        d = self.device
        return _on(d, tokens), _on(d, pos), _on(d, table)

    def _fn(self, params, state, tokens, pos, table):
        with torch.inference_mode():
            tok, pos, table = self._inputs(tokens, pos, table)
            rows = torch.arange(self.max_slots, device=self.device)
            pidx = table[rows, pos // self.page]     # [S] write page
            return self._apply(params, state, tok, pos, table, pidx)

    def masked_fn(self, params, state, tokens, pos, table, active):
        """The step with inactive slots routed to scratch: their pool
        writes land on page 0 and their outputs are -1, while an active
        row computes bit-exactly what ``_fn`` computes (the same
        [S]-shaped row-wise math): what chunked prefill and the
        speculative verify are built on."""
        with torch.inference_mode():
            tok, pos, table = self._inputs(tokens, pos, table)
            act = _on(self.device, active, torch.bool)
            pos = torch.where(act, pos, torch.zeros_like(pos))
            rows = torch.arange(self.max_slots, device=self.device)
            pidx = torch.where(act, table[rows, pos // self.page],
                               torch.zeros_like(pos))
            nxt, new_state = self._apply(params, state, tok, pos, table,
                                         pidx)
            return torch.where(act, nxt, torch.full_like(nxt, -1)), \
                new_state

    def _apply(self, params, state, tokens, pos, table, pidx):
        S = self.max_slots
        nh, hd = self.n_heads, self.head_dim
        eps = self.eps

        def ln(x, p):
            return _layer_norm(x, p["g"], p["b"], eps)

        h = take_rows(params["tok_emb"], tokens) + take_rows(
            params["pos_emb"], pos)
        h = ln(h, params["emb_ln"])
        off = pos % self.page
        span = self.max_pages_per_slot * self.page
        valid = torch.arange(span, device=self.device)[None, :] <= \
            pos[:, None]
        for li, lp in enumerate(params["layers"]):
            qkv = h @ lp["qkv_w"] + lp["qkv_b"]
            q, k, v = qkv.split(self.hidden, dim=-1)
            q = q.reshape(S, nh, hd)
            kpool, vpool = state["k"][li], state["v"][li]
            # in place: the pool is the engine's one preallocated tensor
            kpool[pidx, off] = k.reshape(S, nh, hd)
            vpool[pidx, off] = v.reshape(S, nh, hd)
            att = self._paged_attention(q, kpool, vpool, table, valid)
            att = att.reshape(S, nh * hd) @ lp["out_w"] + lp["out_b"]
            h = ln(h + att, lp["ln1"])
            ffn = F.gelu(h @ lp["ffn_in_w"] + lp["ffn_in_b"],
                         approximate="tanh")
            ffn = ffn @ lp["ffn_out_w"] + lp["ffn_out_b"]
            h = ln(h + ffn, lp["ln2"])
        logits = h @ params["tok_emb"].T + params["mlm_bias"]
        return torch.argmax(logits, dim=-1), state

    def params_for_step(self):
        return self.params

    def step(self, state, tokens, pos, table):
        return self._fn(self.params, state, tokens, pos, table)

    def step_masked(self, state, tokens, pos, table, active):
        return self.masked_fn(self.params, state, tokens, pos, table,
                              np.ascontiguousarray(active, bool))

    def reset_slot(self, state, slot):
        # stale page contents are unreachable once the page table drops
        # them (the length mask covers in-page staleness): no wipe
        return state


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "eos_id", "future", "stream",
                 "slot", "ptr", "generated", "t_submit", "req_id",
                 "trace", "spans_emitted", "t_suppressed",
                 "ttft_boundaries", "published", "t_first")
    _END = object()

    def __init__(self, prompt, max_new, eos_id, req_id):
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("decode needs at least one prompt token")
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.future: Future = Future()
        self.stream: _queue.Queue = _queue.Queue()
        self.slot = None
        self.ptr = 0            # next prompt position to feed
        self.generated: list[int] = []
        self.t_submit = time.perf_counter()
        self.req_id = req_id
        # sampled-trace context captured at submit (None = unsampled):
        # the engine thread emits per-token-boundary child spans to it
        self.trace = tracing.current()
        self.spans_emitted = 0     # per-boundary spans so far
        self.t_suppressed = None   # first boundary past the span cap
        # engine boundaries this request rode before its first token:
        # the number chunked prefill and prefix adoption exist to shrink
        self.ttft_boundaries = 0
        self.published = False     # prompt pages in the prefix cache
        self.t_first = None        # wall time of the first token

    def tokens(self, timeout=None):
        """Generator of tokens as they decode (terminates with the
        sequence; raises if the engine failed the request)."""
        while True:
            item = self.stream.get(timeout=timeout)
            if item is self._END:
                exc = self.future.exception()
                if exc is not None:
                    raise exc
                return
            yield item

    def result(self, timeout=None) -> list:
        return self.future.result(timeout=timeout)


class DecodeEngine:
    """Continuous batcher: one worker thread advancing every in-flight
    sequence one token per iteration.

    - `submit(prompt, max_new_tokens)` joins at the next token boundary
      if a slot (and, for paged models, enough KV pages) is free, else
      waits in the pending queue;
    - prompt PREFILL runs through the same step, one token per
      iteration: a joining sequence interleaves with in-flight decodes
      from its first token;
    - a finished sequence (max_new reached or eos) frees its slot and
      pages at the SAME token boundary, and the next pending request
      takes them over at once;
    - `warmup()` runs one throwaway step (and block step) on an
      all-scratch page table, so every kernel is built before traffic and
      the engine state is left as it was (page 0 aside).

    The decode layers (all default-off, composable):

    - ``chunk=N``: chunked prefill: prompts retire in N-token blocks at
      each boundary (`serving/prefill.py`), cutting TTFT boundaries from
      O(prompt_len) to O(prompt_len / N) while decoding slots keep
      streaming; bit-identical to the per-token path by construction;
    - ``prefix_cache=True``: completed full prompt pages are refcounted
      and published under a rolling token-prefix hash
      (`serving/prefix_cache.py`); a request with a matching prefix
      adopts the pages and prefills only its suffix. Admission counts
      cache-idle pages as reclaimable;
    - ``speculative=SpeculativeConfig(draft, k)``: a draft model proposes
      k tokens per boundary, verified in one call through the block step,
      with acceptance-EWMA fallback to plain decode
      (`serving/speculative.py`). Greedy output is identical to
      target-only decode.
    """

    def __init__(self, model, name="decode", pending_size=64,
                 max_new_limit=1024, instruments=None,
                 wedge_timeout=30.0, chunk=None, prefix_cache=False,
                 speculative=None, backlog_timeout=120.0):
        self.model = model
        self.name = name
        self.device = getattr(model, "device", None)
        # with sequences in flight, a token boundary is expected at least
        # this often: an engine stuck inside one step longer reports
        # itself "degraded"
        self.wedge_timeout = float(wedge_timeout)
        self._last_boundary = None
        # hard per-request generation cap for EVERY model: a page-less RNN
        # model has no natural ceiling
        self.max_new_limit = int(max_new_limit)
        self._instruments_fn = (instruments if callable(instruments)
                                else lambda: instruments)
        self._pending: _queue.Queue = _queue.Queue(maxsize=pending_size)
        self._waiting: list = []   # engine-side FIFO (page head-block)
        self._active: dict[int, _DecodeRequest] = {}
        self._free_slots = list(range(model.max_slots - 1, -1, -1))
        # capacity planning: the KV pool's bytes (from shapes on the
        # "meta" device, nothing allocated) against the headroom of the
        # model's device BEFORE the pool is allocated
        self._plan_device = memledger.device_label(self.device)
        if getattr(model, "uses_pages", False) and \
                memledger.capacity_known(device=self._plan_device):
            pool_est = _pool_bytes_estimate(model)
            if pool_est is not None:
                memledger.plan_capacity(
                    f"decode:{name}:kv", pool_est,
                    detail={"lane": "target", "pages": model.n_pages,
                            "page": model.page,
                            "slots": model.max_slots},
                    device=self._plan_device)
        try:
            self._state = model.init_state()
        except Exception as e:
            memledger.raise_if_oom(e, site=f"decode:{name}:kv",
                                   lane="target")
            raise
        self._kv = None
        self._pool_bytes = memledger.tree_bytes(self._state)
        self._mem_claim = None   # registered at the END of __init__
        if getattr(model, "uses_pages", False):
            self._kv = PagedKVCache(model.n_pages, model.page,
                                    model.max_pages_per_slot,
                                    model.max_slots)
        self._table = (self._kv.table if self._kv is not None
                       else np.zeros((model.max_slots, 1), np.int32))
        self._spec = None
        self._draft_mem_claim = None
        if speculative is not None:
            from deeplearning4j_tpu_torch.serving.speculative import (
                SpeculativeConfig, SpeculativeDecoder)

            cfg = (speculative if isinstance(speculative,
                                             SpeculativeConfig)
                   else SpeculativeConfig(draft=speculative))
            if self._kv is None:
                raise DecodeError("speculative decoding needs a paged "
                                  "target model (the verifier rides "
                                  "the block step over the paged pool)")
            if getattr(cfg.draft, "vocab", None) != model.vocab:
                raise DecodeError(
                    f"draft vocab {getattr(cfg.draft, 'vocab', None)} "
                    f"!= target vocab {model.vocab}")
            if cfg.draft.max_slots != model.max_slots:
                raise DecodeError(
                    f"draft max_slots {cfg.draft.max_slots} != target "
                    f"max_slots {model.max_slots}")
            # the draft lane mirrors the target's page accounting: equal
            # page size keeps adoption depths in one unit, and a pool at
            # least as roomy keeps every submit-side limit check (which
            # consults only the target) valid for the draft too
            if cfg.draft.page != model.page:
                raise DecodeError(
                    f"draft page {cfg.draft.page} != target page "
                    f"{model.page}")
            if cfg.draft.max_pages_per_slot < model.max_pages_per_slot \
                    or cfg.draft.n_pages < model.n_pages:
                raise DecodeError(
                    f"draft pool (max_pages_per_slot="
                    f"{cfg.draft.max_pages_per_slot}, n_pages="
                    f"{cfg.draft.n_pages}) smaller than the target's "
                    f"({model.max_pages_per_slot}, {model.n_pages})")
            if getattr(cfg.draft, "device", self.device) != self.device:
                raise DecodeError(
                    f"draft on {cfg.draft.device}, target on "
                    f"{self.device}")
            if chunk is None:
                # the verify width doubles as the prefill block
                chunk = cfg.k + 1
            if memledger.capacity_known(device=self._plan_device):
                draft_est = _pool_bytes_estimate(cfg.draft)
                if draft_est is not None:
                    memledger.plan_capacity(
                        f"decode:{name}:kv", draft_est,
                        detail={"lane": "draft",
                                "pages": cfg.draft.n_pages,
                                "page": cfg.draft.page,
                                "slots": cfg.draft.max_slots},
                        device=self._plan_device)
            try:
                self._spec = SpeculativeDecoder(
                    cfg, chunk, name, prefix_cache=bool(prefix_cache))
            except Exception as e:
                memledger.raise_if_oom(e, site=f"decode:{name}:kv",
                                       lane="draft")
                raise
        self._block = None
        if chunk is not None:
            from deeplearning4j_tpu_torch.serving.prefill import (
                ChunkedPrefill)

            self._block = ChunkedPrefill(model, chunk)
        self._pcache = None
        if prefix_cache:
            from deeplearning4j_tpu_torch.serving.prefix_cache import (
                PrefixCache)

            if self._kv is None:
                raise DecodeError("prefix caching needs a paged model "
                                  "(KV pages are what gets shared)")
            self._pcache = (prefix_cache if isinstance(prefix_cache,
                                                       PrefixCache)
                            else PrefixCache(self._kv.page))
        self.backlog_timeout = float(backlog_timeout)
        self._closed = False
        self._warmed = False
        self._ids = 0
        # claims registered LAST: a validation raise above must not leak
        # a claim for an engine that never existed
        self._mem_claim = memledger.claim(
            "kv_cache", f"{name}:target", nbytes=self._pool_bytes,
            device=self._plan_device, slots=model.max_slots,
            pages=getattr(model, "n_pages", None))
        if self._spec is not None:
            self._draft_mem_claim = memledger.claim(
                "kv_cache", f"{name}:draft",
                nbytes=self._spec.pool_bytes, device=self._plan_device,
                slots=self._spec.model.max_slots,
                pages=self._spec.model.n_pages)
        # serializes submit(): the capacity check and the req-id counter
        # both race under concurrent callers
        self._submit_lock = threading.Lock()
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name=f"dl4j:decode:engine-{name}",
            daemon=True)
        self._thread.start()

    # -- client side ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens, eos_id=None,
               timeout=None) -> _DecodeRequest:
        if self._closed:
            raise DecodeShutdown(f"decode engine {self.name!r} closed")
        if int(max_new_tokens) > self.max_new_limit:
            raise DecodeError(
                f"max_new_tokens={max_new_tokens} exceeds the "
                f"engine's limit of {self.max_new_limit} "
                f"(max_new_limit=)")
        total = len(list(prompt)) + int(max_new_tokens)
        max_len = getattr(self.model, "max_len", None)
        if max_len is not None and total > max_len:
            raise DecodeError(
                f"prompt + max_new_tokens = {total} exceeds the "
                f"model's max_len {max_len}")
        if self._kv is not None:
            need = self._kv.pages_for(total)
            # against BOTH the per-slot max and the pool total: a request
            # that could never reserve would head-block the FIFO forever
            limit = min(self.model.max_pages_per_slot,
                        self._kv.n_pages)
            if need > limit:
                raise DecodeError(
                    f"sequence of {total} tokens needs {need} KV "
                    f"pages > the engine's limit of {limit} "
                    f"(max_pages_per_slot="
                    f"{self.model.max_pages_per_slot}, pool="
                    f"{self._kv.n_pages})")
        with self._submit_lock:
            # the backpressure bound spans the submit queue AND the
            # engine's head-blocking FIFO
            if self._pending.qsize() + len(self._waiting) >= \
                    self._pending.maxsize:
                from deeplearning4j_tpu_torch.serving.batcher import (
                    QueueFullError)

                raise QueueFullError(
                    f"decode pending queue for {self.name!r} full "
                    f"({self._pending.maxsize} waiting)")
            self._ids += 1
            req = _DecodeRequest(prompt, max_new_tokens, eos_id,
                                 self._ids)
            self._pending.put_nowait(req)
        self._wake.set()
        return req

    def decode(self, prompt, max_new_tokens, eos_id=None,
               timeout=None) -> list:
        """Synchronous decode: the generated token ids."""
        return self.submit(prompt, max_new_tokens,
                           eos_id=eos_id).result(timeout=timeout)

    def warmup(self):
        """Run a throwaway step (and a block column when blocks are on) so
        every kernel is built and every path has run before traffic. The steps run on an all-scratch page table: their
        pool writes land on page 0, and the RNN carries they return are
        dropped, so the engine state is as it was (page 0 aside)."""
        state = self.model.reset_slot(self._state, 0)
        tokens = np.zeros((self.model.max_slots,), np.int32)
        pos = np.zeros((self.model.max_slots,), np.int32)
        table = np.zeros_like(self._table)
        self.model.step(state, tokens, pos, table)
        if self._block is not None:
            self._block.warmup(self._state, table)
        if self._spec is not None:
            self._spec.warmup()
        self._state = self.model.reset_slot(self._state, 0)
        self._warmed = True
        return self

    @property
    def active_slots(self) -> int:
        return len(self._active)

    def _backlog_age(self):
        """Age of the oldest request still waiting for its first token
        (queued, head-blocked, or mid-prefill)."""
        oldest = None
        for req in list(self._waiting):
            if oldest is None or req.t_submit < oldest:
                oldest = req.t_submit
        for req in list(self._active.values()):
            if not req.generated and (oldest is None
                                      or req.t_submit < oldest):
                oldest = req.t_submit
        return (time.perf_counter() - oldest) if oldest is not None \
            else None

    def health(self) -> dict:
        """Liveness detail: active/waiting counts, wedge detection (no
        token boundary for longer than ``wedge_timeout`` with sequences
        in flight), the prefill backlog age (degraded past
        ``backlog_timeout``), KV-page occupancy in pages and bytes, the
        prefix cache and speculation state. Degraded, never down."""
        active = len(self._active)
        last = self._last_boundary
        age = (time.monotonic() - last) if last is not None else None
        wedged = bool(active and age is not None
                      and age > self.wedge_timeout)
        backlog = self._backlog_age()
        starved = bool(backlog is not None
                       and backlog > self.backlog_timeout)
        out = {"active": active,
               "waiting": self._pending.qsize() + len(self._waiting),
               "boundary_age_seconds": (round(age, 3)
                                        if age is not None else None),
               "wedged": wedged,
               "degraded": (wedged or starved
                            or not self._thread.is_alive())}
        if self._block is not None:
            out["prefill"] = {
                "chunk": self._block.chunk,
                "backlog": sum(
                    1 for r in list(self._active.values())
                    if not r.generated) + len(self._waiting),
                "oldest_age_seconds": (round(backlog, 3)
                                       if backlog is not None
                                       else None),
                "starved": starved}
        if self._kv is not None:
            # the device pool holds n_pages + 1 pages (page 0 = scratch)
            per_page = self._pool_bytes // (self._kv.n_pages + 1)
            out["kv_pages"] = {"total": self._kv.n_pages,
                               "free": self._kv.free_pages,
                               "occupancy": round(
                                   self._kv.used_pages
                                   / self._kv.n_pages, 4),
                               "pool_bytes": self._pool_bytes,
                               "used_bytes": per_page
                               * self._kv.used_pages}
        if self._pcache is not None:
            out["prefix_cache"] = self._pcache.stats()
        if self._spec is not None:
            out["speculative"] = self._spec.health()
        return out

    def close(self, timeout=5.0):
        self._closed = True
        self._wake.set()
        self._thread.join(timeout)
        # the pools die with the engine: release their claims
        if self._mem_claim is not None:
            self._mem_claim.release()
        if self._draft_mem_claim is not None:
            self._draft_mem_claim.release()
        # fail everything still pending or active
        leftovers = list(self._active.values()) + list(self._waiting)
        self._active.clear()
        self._waiting = []
        while True:
            try:
                leftovers.append(self._pending.get_nowait())
            except _queue.Empty:
                break
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(
                    DecodeShutdown("decode engine closed"))
            req.stream.put(_DecodeRequest._END)

    # -- engine side ---------------------------------------------------------
    def _page_plan(self, req):
        """Admission plan for the head-of-line request, or None when it
        must wait: matched cached pages are ADOPTED, and pages held only
        by the cache count as reclaimable."""
        from deeplearning4j_tpu_torch.serving.prefix_cache import (
            plan_admission)

        total = len(req.prompt) + req.max_new
        plan = plan_admission(self._kv, self._pcache, req.prompt, total)
        if plan is None:
            return None
        if self._spec is not None:
            # the draft lane never adopts DEEPER than the target skips
            # (the suffix prefill would write into shared draft pages)
            dplan = self._spec.plan(req.prompt, total,
                                    max_adopt=len(plan["adopt"]))
            if dplan is None:
                return None
            return plan, dplan
        return plan, None

    def _admit(self):
        """Move pending requests into free slots at this token boundary.
        The submit queue drains into an engine-private FIFO first, so a
        request that can't get its KV pages yet head-blocks (fairness)."""
        from deeplearning4j_tpu_torch.serving.prefix_cache import (
            apply_admission)

        while True:
            try:
                self._waiting.append(self._pending.get_nowait())
            except _queue.Empty:
                break
        admitted = 0
        while self._free_slots and self._waiting:
            req = self._waiting[0]
            plan = None
            if self._kv is not None:
                plan = self._page_plan(req)
                if plan is None:
                    break   # head-of-line waits for pages: strict FIFO
            self._waiting.pop(0)
            slot = self._free_slots.pop()
            req.slot = slot
            adopted = 0
            if self._kv is not None:
                tplan, dplan = plan
                total = len(req.prompt) + req.max_new
                try:
                    adopted = apply_admission(self._kv, self._pcache,
                                              tplan, slot, total)
                    if dplan is not None:
                        self._spec.admit(slot, total, dplan,
                                         target_adopted=adopted)
                except Exception as e:   # noqa: BLE001
                    # a lane-accounting failure fails THIS request, never
                    # the engine thread
                    self._kv.release(slot)
                    if self._spec is not None:
                        self._spec.release(slot)
                    self._free_slots.append(slot)
                    req.slot = None
                    if not req.future.done():
                        req.future.set_exception(DecodeError(
                            f"admission failed: "
                            f"{type(e).__name__}: {e}"))
                    req.stream.put(_DecodeRequest._END)
                    continue
                if adopted:
                    # the adopted pages already hold this prefix's KV:
                    # prefill starts at the suffix
                    req.ptr = adopted * self._kv.page
                if self._pcache is not None:
                    inst = self._instruments_fn()
                    if adopted:
                        self._pcache.hits += 1
                        if inst is not None:
                            inst.prefix_hits.inc()
                    else:
                        self._pcache.misses += 1
                        if inst is not None:
                            inst.prefix_misses.inc()
            self._state = self.model.reset_slot(self._state, slot)
            self._active[slot] = req
            admitted += 1
            if req.trace is not None:
                # submit -> slot join: the decode analog of queue-wait
                tracing.emit("decode.queue", req.trace, req.t_submit,
                             time.perf_counter(), slot=slot,
                             req_id=req.req_id)
            flight.record("decode_join", model=self.name,
                          req_id=req.req_id, slot=slot,
                          prompt=len(req.prompt), max_new=req.max_new,
                          adopted_pages=adopted)
        return admitted

    # per-request ceiling on per-boundary spans; the remainder folds into
    # one aggregate decode.tokens span at finish
    boundary_span_cap = 64

    def _finish(self, req, error=None):
        slot = req.slot
        if req.trace is not None and req.t_suppressed is not None:
            tracing.emit("decode.tokens", req.trace, req.t_suppressed,
                         time.perf_counter(), slot=slot,
                         boundaries=(len(req.prompt) + len(req.generated)
                                     - 1 - req.spans_emitted))
        self._active.pop(slot, None)
        if self._kv is not None:
            self._kv.release(slot)
        if self._spec is not None:
            self._spec.release(slot)
        self._free_slots.append(slot)
        if error is not None:
            if not req.future.done():
                req.future.set_exception(error)
        elif not req.future.done():
            req.future.set_result(list(req.generated))
        req.stream.put(_DecodeRequest._END)
        flight.record("decode_leave", model=self.name,
                      req_id=req.req_id, slot=slot,
                      generated=len(req.generated),
                      seconds=round(time.perf_counter() - req.t_submit,
                                    6))

    def clear_prefix_cache(self):
        """Drop every cached prefix chain (both lanes), releasing the
        cache's page references."""
        n = 0
        if self._pcache is not None and self._kv is not None:
            n = self._pcache.clear(self._kv)
        if self._spec is not None:
            n += self._spec.clear_prefix_cache()
        return n

    def _publish(self, req, slot):
        """Put the request's full prompt pages into the prefix cache,
        once, at the boundary where its prompt is fully written."""
        if self._pcache is None or req.published or \
                req.ptr < len(req.prompt):
            return
        req.published = True
        n_full = len(req.prompt) // self._kv.page
        if not n_full:
            return
        owned = self._kv.owned(slot)
        if len(owned) >= n_full:
            self._pcache.publish(self._kv, req.prompt, owned[:n_full])
        if self._spec is not None:
            self._spec.publish(req.prompt, slot)

    def _emit_token(self, req, tok, inst):
        """Append one generated token, stream it, observe TTFT on the
        first. Returns True when the request just finished."""
        req.generated.append(tok)
        req.stream.put(tok)
        if req.t_first is None:
            req.t_first = time.perf_counter()
            if inst is not None:
                inst.ttft.observe(req.t_first - req.t_submit)
        return (len(req.generated) >= req.max_new
                or (req.eos_id is not None and tok == req.eos_id))

    def _fail_all(self, e, site, what):
        err = _boundary_error(e, f"decode:{self.name}:{site}", what)
        for req in list(self._active.values()):
            self._finish(req, error=err)

    def _prefill_boundary(self, inst) -> bool:
        """Boundary phase 1: retire up to ``chunk`` prompt tokens per
        prefilling slot through the block step, always leaving the final
        prompt token for the emitting phase. Returns False when the step
        failed (every request was failed)."""
        todo = {s: r for s, r in list(self._active.items())
                if r.ptr < len(r.prompt) - 1}
        if not todo:
            return True
        S = self.model.max_slots
        C = self._block.chunk
        blocks = np.zeros((S, C), np.int32)
        pos0 = np.zeros((S,), np.int32)
        counts = np.zeros((S,), np.int32)
        for slot, req in todo.items():
            n = min(C, len(req.prompt) - 1 - req.ptr)
            blocks[slot, :n] = req.prompt[req.ptr:req.ptr + n]
            pos0[slot] = req.ptr
            counts[slot] = n
        # a copy: admission mutates the table between boundaries
        table = self._table.copy()
        t_b0 = time.perf_counter()
        try:
            _, self._state = self._block.run(
                self._state, blocks, pos0, counts, table)
            if self._spec is not None:
                self._spec.prefill(blocks, pos0, counts)
        except Exception as e:   # noqa: BLE001
            self._fail_all(e, "prefill", "chunk prefill failed")
            return False
        t_b1 = time.perf_counter()
        self._last_boundary = time.monotonic()
        for slot, req in todo.items():
            if self._active.get(slot) is not req:
                continue
            req.ptr += int(counts[slot])
            if req.trace is not None and \
                    req.spans_emitted < self.boundary_span_cap:
                req.spans_emitted += 1
                tracing.emit("decode.prefill_chunk", req.trace, t_b0,
                             t_b1, slot=slot,
                             tokens=int(counts[slot]), pos=req.ptr)
        return True

    def _step_boundary(self, inst):
        """One per-token boundary: every active slot advances one token
        (prefilling slots feed their next prompt token)."""
        S = self.model.max_slots
        tokens = np.zeros((S,), np.int32)
        pos = np.zeros((S,), np.int32)
        active = np.zeros((S,), bool)
        # snapshot: close() may clear _active concurrently
        for slot, req in list(self._active.items()):
            if req.ptr < len(req.prompt):
                tokens[slot] = req.prompt[req.ptr]
            else:
                tokens[slot] = req.generated[-1]
            pos[slot] = req.ptr
            active[slot] = True
        table = self._table.copy()
        t_b0 = time.perf_counter()
        try:
            nxt, self._state = self.model.step(self._state, tokens, pos,
                                               table)
            nxt = _host(nxt)
            if self._spec is not None:
                # fallback boundaries keep the draft pool in sync so a
                # later speculation probe proposes from real context
                self._spec.track(tokens, pos, active)
        except Exception as e:   # noqa: BLE001
            self._fail_all(e, "step", "decode step failed")
            return
        t_b1 = time.perf_counter()
        self._last_boundary = time.monotonic()
        n_decoded = 0
        for slot, req in list(self._active.items()):
            prefilling = req.ptr + 1 < len(req.prompt)
            if req.trace is not None:
                # one child span per token boundary this sequence took
                # part in: prefill and decode interleave through the same
                # step, and the span name says which phase this boundary
                # was. Capped per request, so a long generation cannot
                # evict every concurrent trace from the bounded ring:
                # boundaries past the cap fold into one decode.tokens
                # span at finish
                if req.spans_emitted < self.boundary_span_cap:
                    req.spans_emitted += 1
                    tracing.emit(
                        "decode.prefill" if prefilling
                        else "decode.token",
                        req.trace, t_b0, t_b1, slot=slot, pos=req.ptr)
                elif req.t_suppressed is None:
                    req.t_suppressed = t_b0
            req.ptr += 1
            self._publish(req, slot)
            if req.ptr < len(req.prompt):
                continue            # still prefilling
            tok = int(nxt[slot])
            done = self._emit_token(req, tok, inst)
            n_decoded += 1
            if self._spec is not None and inst is not None:
                inst.accepted("fallback", 1)
            if done:
                self._finish(req)
        if inst is not None:
            inst.tokens.inc(n_decoded)

    def _speculative_boundary(self, inst):
        """Boundary phase 2, speculative: the draft proposes k tokens per
        decoding slot, the target verifies the whole block in ONE call
        through the block step, and the accepted prefix (plus the
        verifier's own next token) is emitted. Greedy-identical to plain
        decode, up to k + 1 tokens per boundary."""
        S = self.model.max_slots
        ready = {s: r for s, r in list(self._active.items())
                 if r.ptr >= len(r.prompt) - 1}
        if not ready:       # everyone still prefilling: plain boundary
            self._step_boundary(inst)
            return
        V = self._spec.k + 1
        feed = np.zeros((S,), np.int32)
        pos = np.zeros((S,), np.int32)
        active = np.zeros((S,), bool)
        for slot, req in ready.items():
            feed[slot] = (req.prompt[req.ptr]
                          if req.ptr < len(req.prompt)
                          else req.generated[-1])
            pos[slot] = req.ptr
            active[slot] = True
        table = self._table.copy()
        t_b0 = time.perf_counter()
        try:
            drafts = self._spec.propose(feed, pos, active)
            blocks = np.zeros((S, V), np.int32)
            counts = np.zeros((S,), np.int32)
            for slot, req in ready.items():
                c = min(V, req.max_new - len(req.generated))
                blocks[slot, 0] = feed[slot]
                if c > 1:
                    blocks[slot, 1:c] = drafts[slot, :c - 1]
                counts[slot] = c
            outs, self._state = self._block.run(
                self._state, blocks, pos, counts, table)
        except Exception as e:   # noqa: BLE001
            self._fail_all(e, "verify", "speculative decode failed")
            return
        t_b1 = time.perf_counter()
        self._last_boundary = time.monotonic()
        n_decoded = 0
        for slot, req in ready.items():
            if self._active.get(slot) is not req:
                continue
            c = int(counts[slot])
            if c < 1:
                continue
            # o_0 is the target's answer to the real last token (always
            # valid); each later o_j is valid iff the draft proposal fed
            # at j matched o_{j-1}: the greedy acceptance rule
            m = 1
            while m < c and \
                    int(blocks[slot, m]) == int(outs[slot, m - 1]):
                m += 1
            self._spec.observe(m, c)
            if inst is not None:
                inst.accepted("accepted", m)
                if c > m:
                    inst.accepted("rejected", c - m)
            if req.trace is not None and \
                    req.spans_emitted < self.boundary_span_cap:
                req.spans_emitted += 1
                tracing.emit("decode.speculate", req.trace, t_b0, t_b1,
                             slot=slot, drafted=c - 1, accepted=m,
                             pos=req.ptr)
            # rejected positions were written past the accepted point in
            # both pools: above the causal mask until the true tokens
            # overwrite those same positions (no rollback)
            req.ptr += m
            self._publish(req, slot)
            done = False
            for j in range(m):
                done = self._emit_token(req, int(outs[slot, j]), inst)
                n_decoded += 1
                if done:
                    break
            if done:
                self._finish(req)
        self._spec.boundary_done()
        if inst is not None:
            inst.tokens.inc(n_decoded)

    def _loop(self):
        # inference mode is thread-local: the worker enters it itself, on
        # the model's device
        with torch.inference_mode():
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._run()

    def _run(self):
        while not self._closed:
            self._admit()
            if not self._active:
                self._last_boundary = None   # idle: nothing to wedge
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            self._last_boundary = time.monotonic()
            for req in list(self._active.values()):
                if not req.generated:
                    req.ttft_boundaries += 1
            inst = self._instruments_fn()
            if self._block is not None and \
                    not self._prefill_boundary(inst):
                continue
            if self._spec is not None and any(
                    r.ptr >= len(r.prompt) - 1
                    for r in list(self._active.values())) \
                    and self._spec.speculate_now():
                self._speculative_boundary(inst)
            else:
                self._step_boundary(inst)
            if inst is not None:
                inst.slots.set(len(self._active))
                if self._kv is not None:
                    inst.kv_occupancy.set(
                        self._kv.used_pages / max(1, self._kv.n_pages))
