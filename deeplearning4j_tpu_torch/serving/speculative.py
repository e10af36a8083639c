"""Speculative decoding over the paged decode engine.

Counterpart of ``deeplearning4j_tpu/serving/speculative.py``. A small
DRAFT model proposes ``k`` tokens per boundary; the TARGET verifies all of
them in ONE batched call through the block step of chunked prefill
(`serving/prefill.py`). Greedy equivalence is exact: the verify outputs
``o_j`` are the target's own argmax after consuming the fed prefix, so the
engine emits ``o_0`` (always: the target's answer to the real last token)
and then each ``o_j`` whose draft proposal matched ``o_{j-1}``; the
emitted stream is the target-only greedy stream token for token.

Rejected positions need no rollback: both lanes' KV pools are
POSITIONAL, so writes past the accepted point sit above the causal length
mask until the true tokens overwrite them at the same positions, and the
draft's accepted-prefix writes are exactly right because matching is what
acceptance means. The port writes both pools in place; a draft step that
the reference throws away (the warmup's) writes only scratch page 0.

The draft lane mirrors the target's plumbing: its own `PagedKVCache`
(refcounted), its own `PrefixCache` when the engine caches prefixes, the
same block step for prompt prefill, and a masked single-token step so
proposals for decoding slots never touch a slot still prefilling.

Acceptance-rate fallback: an EWMA of the per-boundary draft acceptance
rate; when it falls below ``min_acceptance`` the engine falls back to
plain decode (the draft lane keeps tracking emitted tokens so its state
stays aligned), probing speculation again every ``probe_every``
boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from deeplearning4j_tpu_torch.serving.prefill import ChunkedPrefill
from deeplearning4j_tpu_torch.serving.prefix_cache import (
    PrefixCache, apply_admission, plan_admission)
from deeplearning4j_tpu_torch.telemetry import flight, memledger


@dataclass
class SpeculativeConfig:
    """draft: a paged decode model (same vocab and max_slots as the
    target; typically far smaller). k: draft proposals per boundary
    (the verify block is ``k + 1`` wide). min_acceptance: EWMA
    draft-acceptance floor below which the engine falls back to plain
    decode; probe_every: boundaries between speculation probes while
    in fallback."""

    draft: object
    k: int = 4
    min_acceptance: float = 0.35
    ewma_alpha: float = 0.25
    warmup_boundaries: int = 8
    probe_every: int = 64


class SpeculativeDecoder:
    """The engine-side draft lane + acceptance bookkeeping."""

    def __init__(self, cfg: SpeculativeConfig, chunk, name,
                 prefix_cache=False):
        from deeplearning4j_tpu_torch.serving.decode import (
            DecodeError, PagedKVCache)

        model = cfg.draft
        if not getattr(model, "uses_pages", False):
            raise DecodeError(
                "speculative decoding needs a paged draft model "
                "(positional KV state is what makes rejected draft "
                "writes free to roll back)")
        if int(cfg.k) < 1:
            raise DecodeError(f"speculative k must be >= 1, got {cfg.k}")
        self.cfg = cfg
        self.model = model
        self.name = name
        self.k = int(cfg.k)
        self._kv = PagedKVCache(model.n_pages, model.page,
                                model.max_pages_per_slot,
                                model.max_slots)
        self._pcache = PrefixCache(model.page) if prefix_cache else None
        self._state = model.init_state()
        # the draft lane's pinned pool bytes: health() reports them
        # beside the target's, and the engine claims them
        self.pool_bytes = memledger.tree_bytes(self._state)
        self._block = ChunkedPrefill(model, chunk)
        self._ewma = None
        self._boundaries = 0
        self._fallback = False
        self._since_probe = 0
        # per-slot publishable chain depth: when the draft adopted a
        # SHALLOWER prefix than the target skipped, the draft pages in
        # between were never written (the mirrored prefill starts at
        # the target's adopted length) — publishing them would cache
        # garbage KV under valid keys
        self._publish_depth: dict = {}

    # -- page lane (mirrors the engine's target lane) ------------------------
    def plan(self, prompt, total_len, max_adopt):
        """Draft-lane admission plan; ``max_adopt`` caps adoption at
        the target lane's adopted depth — the draft must never adopt
        deeper than the target skips, or the engine's suffix prefill
        would write into shared draft pages."""
        return plan_admission(self._kv, self._pcache, prompt, total_len,
                              max_adopt=max_adopt)

    def admit(self, slot, total_len, plan, target_adopted=0):
        adopted = apply_admission(self._kv, self._pcache, plan, slot,
                                  total_len)
        # draft pages [adopted, target_adopted) are a HOLE: the engine
        # prefills both lanes from the target's adopted length, so
        # only the adopted prefix is publishable when it falls short
        self._publish_depth[slot] = (None if adopted >= target_adopted
                                     else adopted)
        return adopted

    def release(self, slot):
        self._kv.release(slot)
        self._publish_depth.pop(slot, None)

    def publish(self, prompt, slot):
        if self._pcache is None:
            return
        n_full = len(prompt) // self._kv.page
        depth = self._publish_depth.get(slot)
        if depth is not None:
            n_full = min(n_full, depth)
        owned = self._kv.owned(slot)
        if n_full and len(owned) >= n_full:
            self._pcache.publish(self._kv, prompt, owned[:n_full])

    def clear_prefix_cache(self):
        return (self._pcache.clear(self._kv)
                if self._pcache is not None else 0)

    # -- device calls --------------------------------------------------------
    def _table(self):
        # a copy: admit/release mutate the table between boundaries
        return self._kv.table.copy()

    def prefill(self, blocks, pos0, counts):
        """Mirror a target chunk-prefill block on the draft lane."""
        _, self._state = self._block.run(
            self._state, blocks, pos0, counts, self._table())

    def propose(self, feed, pos, active):
        """k greedy draft proposals per active slot: [S, k] int32.
        Proposal j is written into the draft pool at ``pos + j``: exactly
        the positions verify consumes, so an accepted prefix leaves the
        draft state already correct."""
        S = feed.shape[0]
        out = np.zeros((S, self.k), np.int32)
        toks = np.ascontiguousarray(feed, np.int32)
        table = self._table()
        state = self._state
        for j in range(self.k):
            nxt, state = self.model.step_masked(
                state, toks, np.ascontiguousarray(pos + j, np.int32),
                table, active)
            toks = nxt.cpu().numpy().astype(np.int32)
            out[:, j] = toks
        self._state = state
        return out

    def track(self, tokens, pos, active):
        """Keep the draft pool in sync while the engine runs plain
        boundaries (fallback), so a later probe proposes from real
        context instead of holes."""
        _, self._state = self.model.step_masked(
            self._state, tokens, pos, self._table(), active)

    def warmup(self):
        """A masked draft step with every slot inactive and one block
        column: their writes land on the draft pool's scratch page 0."""
        S = self.model.max_slots
        z = np.zeros((S,), np.int32)
        off = np.zeros((S,), bool)
        self.model.step_masked(self._state, z, z, self._table(), off)
        self._block.warmup(self._state, self._table())
        return self

    # -- acceptance / fallback ----------------------------------------------
    def observe(self, accepted, fed):
        """One slot's verify outcome: ``accepted`` of ``fed`` block
        tokens emitted. The free token (o_0) is excluded from the
        rate — it measures the DRAFT, not the verifier."""
        if fed <= 1:
            return
        rate = (accepted - 1) / (fed - 1)
        a = self.cfg.ewma_alpha
        self._ewma = rate if self._ewma is None else \
            a * rate + (1.0 - a) * self._ewma

    def boundary_done(self):
        self._boundaries += 1
        if self._boundaries < self.cfg.warmup_boundaries or \
                self._ewma is None:
            return
        collapsed = self._ewma < self.cfg.min_acceptance
        if collapsed and not self._fallback:
            flight.record("speculation_fallback", model=self.name,
                          acceptance=round(self._ewma, 4),
                          boundary=self._boundaries)
        elif self._fallback and not collapsed:
            flight.record("speculation_resume", model=self.name,
                          acceptance=round(self._ewma, 4),
                          boundary=self._boundaries)
        self._fallback = collapsed
        if collapsed:
            self._since_probe = 0

    def speculate_now(self) -> bool:
        """Whether this boundary should draft+verify (True) or run the
        plain token step (False, fallback). While fallen back, every
        ``probe_every``-th boundary speculates once to re-measure."""
        if not self._fallback:
            return True
        self._since_probe += 1
        if self._since_probe >= self.cfg.probe_every:
            self._since_probe = 0
            return True
        return False

    def health(self) -> dict:
        out = {"fallback": self._fallback,
               "acceptance_ewma": (round(self._ewma, 4)
                                   if self._ewma is not None else None),
               "boundaries": self._boundaries,
               "k": self.k,
               # the draft lane's KV pool in BYTES beside its pages
               "kv_pages": {
                   "total": self._kv.n_pages,
                   "free": self._kv.free_pages,
                   "pool_bytes": self.pool_bytes,
                   "used_bytes": (self.pool_bytes // (self._kv.n_pages + 1))
                   * self._kv.used_pages}}
        if self._pcache is not None:
            out["prefix_cache"] = self._pcache.stats()
        return out
