"""Chunked prefill: prompts retire in fixed-size blocks.

Counterpart of ``deeplearning4j_tpu/serving/prefill.py``. The per-token
engine prefills one prompt token per boundary, so a 2k-token prompt pays
2k boundaries of host bookkeeping before emitting anything.
`ChunkedPrefill` retires prompt tokens in ``[max_slots, chunk]`` blocks:
time-to-first-token drops from O(prompt_len) boundaries to
O(prompt_len / chunk), while in-flight decodes keep streaming through the
per-token step at every boundary (the engine runs the block first, then
the token step).

Bit-identity with the per-token path holds BY CONSTRUCTION: the block is
a loop over its columns calling the SAME masked single-token function the
step runs (``masked_fn`` on the decode models), at the same
``[max_slots]`` shapes, so column j computes exactly what the per-token
path computes at that boundary. The reference runs the loop as a
``lax.fori_loop`` over every column; here it is a Python loop that stops
after the last column any slot has a token in (``max(counts)``): the
columns past it would change nothing but scratch page 0.

Masking: ``counts[s]`` is how many of slot s's block tokens are real.
Columns past a slot's count route its KV-pool writes to scratch page 0
and keep its RNN carries (``torch.where``): an idle or decoding slot
passes through a block bit-unchanged.

The same class is the SPECULATIVE VERIFIER: a ``[max_slots, k + 1]``
block of draft tokens through `run()` returns the target's next-token
argmax at every position in one call.
"""

from __future__ import annotations

import numpy as np
import torch


class ChunkedPrefill:
    """``[max_slots, width]`` block steps over a decode model's masked
    token step. One instance serves every block width."""

    def __init__(self, model, chunk):
        if int(chunk) < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.model = model
        self.chunk = int(chunk)

    def _fn(self, params, state, blocks, pos0, counts, table, n_cols):
        outs = []
        for j in range(n_cols):
            active = j < counts
            pos = np.where(active, pos0 + j, 0).astype(np.int32)
            nxt, state = self.model.masked_fn(
                params, state, blocks[:, j], pos, table, active)
            outs.append(nxt)
        return outs, state

    def run(self, state, blocks, pos0, counts, table):
        """Consume ``counts[s]`` tokens of ``blocks[s]`` per slot starting
        at ``pos0[s]``. Returns ``(outs, state)``: ``outs[s, j]`` (numpy)
        is the model's next-token argmax after consuming block token j
        (-1 past a slot's count), ignored by prefill and consumed by the
        speculative verify."""
        blocks = np.ascontiguousarray(blocks, dtype=np.int32)
        pos0 = np.ascontiguousarray(pos0, dtype=np.int32)
        counts = np.ascontiguousarray(counts, dtype=np.int32)
        S, V = blocks.shape
        n_cols = int(counts.max()) if counts.size else 0
        outs, state = self._fn(self.model.params_for_step(), state,
                               blocks, pos0, counts, table, n_cols)
        out = np.full((S, V), -1, np.int32)
        if outs:
            with torch.inference_mode():
                out[:, :n_cols] = torch.stack(outs, dim=1).cpu().numpy()
        return out, state

    def warmup(self, state, table):
        """One all-inactive column through the masked step (its pool
        writes land on scratch page 0; the state it returns is dropped).
        Eager PyTorch compiles nothing per block width, so one column
        serves every width, the verify's included."""
        S = self.model.max_slots
        z = np.zeros((S,), np.int32)
        self._fn(self.model.params_for_step(), state,
                 np.zeros((S, 1), np.int32), z, z, table, 1)
        return self
