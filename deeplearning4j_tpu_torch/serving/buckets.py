"""Shape bucketing for inference.

A copy of ``deeplearning4j_tpu/serving/buckets.py`` (numpy only). A
`BucketLadder` fixes a small set of batch sizes (and optionally padded
sequence lengths); requests are padded UP to the smallest covering
bucket, executed, and the padding rows are sliced back off. In the port
the ladder bounds the set of shapes the kernels see, so warmup can run
each of them once before traffic. Padding repeats the last real row, so
every value stays finite; time padding is trailing zeros, which a causal
recurrence never reads back into the real steps.
"""

from __future__ import annotations

import numpy as np

# powers of two up to 32: small enough to warm quickly, dense enough that
# occupancy (real rows / bucket rows) never drops below 50%
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)


class BucketLadder:
    """An ascending set of batch-size buckets plus an optional ascending
    set of padded sequence lengths (for [N, C, T] time-series inputs)."""

    def __init__(self, batch_sizes=DEFAULT_BATCH_BUCKETS, seq_lengths=None):
        sizes = sorted(set(int(b) for b in batch_sizes))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch buckets must be >= 1, got {batch_sizes}")
        self.batch_sizes = tuple(sizes)
        self.seq_lengths = (tuple(sorted(set(int(t) for t in seq_lengths)))
                            if seq_lengths else None)
        if self.seq_lengths and self.seq_lengths[0] < 1:
            raise ValueError(f"seq buckets must be >= 1, got {seq_lengths}")

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    def covering(self, n: int):
        """Smallest bucket >= n, or None when n exceeds the ladder."""
        for b in self.batch_sizes:
            if b >= n:
                return b
        return None

    def covering_seq(self, t: int):
        """Smallest sequence bucket >= t; lengths beyond the ladder are
        left unpadded (they run at their own length)."""
        if not self.seq_lengths:
            return t
        for s in self.seq_lengths:
            if s >= t:
                return s
        return t

    def plan(self, n: int) -> list[int]:
        """Bucket sizes covering n rows: full max-buckets, then the
        smallest covering bucket for the tail. sum(plan) >= n always."""
        if n < 1:
            raise ValueError(f"need n >= 1, got {n}")
        out = []
        while n > self.max_batch:
            out.append(self.max_batch)
            n -= self.max_batch
        out.append(self.covering(n))
        return out

    def shapes(self, example_shape: tuple) -> list[tuple]:
        """Every warmup input shape: batch buckets x seq buckets (seq
        buckets replace the trailing time axis of 2D+ examples)."""
        example_shape = tuple(example_shape)
        variants = [example_shape]
        if self.seq_lengths and len(example_shape) >= 2:
            variants = [example_shape[:-1] + (t,) for t in self.seq_lengths]
        return [(b,) + v for b in self.batch_sizes for v in variants]

    def describe(self) -> dict:
        return {"batch_sizes": list(self.batch_sizes),
                "seq_lengths": (list(self.seq_lengths)
                                if self.seq_lengths else None)}


def pad_rows(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Pad the batch axis up to `bucket` rows by repeating the last row
    (repeated rows keep every value finite so no NaN can leak into
    row-independent ops)."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    if n == bucket:
        return arr
    if n > bucket:
        raise ValueError(f"batch {n} exceeds bucket {bucket}")
    return np.concatenate([arr, np.repeat(arr[-1:], bucket - n, axis=0)],
                          axis=0)


def pad_time(arr: np.ndarray, t_bucket: int) -> np.ndarray:
    """Zero-pad the trailing time axis of an [N, C, T] batch up to
    t_bucket timesteps."""
    arr = np.asarray(arr)
    t = arr.shape[-1]
    if t == t_bucket:
        return arr
    if t > t_bucket:
        raise ValueError(f"sequence length {t} exceeds bucket {t_bucket}")
    pad = np.zeros(arr.shape[:-1] + (t_bucket - t,), arr.dtype)
    return np.concatenate([arr, pad], axis=-1)


def pad_batch(arr: np.ndarray, ladder: BucketLadder):
    """Pad a request batch into its covering bucket. Returns
    (padded, n_real, t_real) — slice results with `unpad(y, n_real,
    t_real)`. Batches larger than the ladder are the caller's problem
    (see BucketLadder.plan)."""
    arr = np.asarray(arr)
    n, t = arr.shape[0], arr.shape[-1] if arr.ndim >= 3 else None
    if t is not None:
        arr = pad_time(arr, ladder.covering_seq(t))
    bucket = ladder.covering(n)
    if bucket is None:
        raise ValueError(
            f"batch {n} exceeds the ladder max {ladder.max_batch}; "
            f"chunk it with ladder.plan()")
    return pad_rows(arr, bucket), n, t


def unpad(y: np.ndarray, n: int, t=None) -> np.ndarray:
    """Slice a bucketed result back to the real rows (and, for 3D
    sequence outputs, the real timesteps)."""
    y = y[:n]
    if t is not None and y.ndim >= 3 and y.shape[-1] != t:
        y = y[..., :t]
    return y
