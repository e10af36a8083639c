"""The step route of the LSTM and GRU kernels, and the choice of route.

The persistent kernels (``csrc/lstm_seq_infer.cu``, ``lstm_seq_bwd.cu``,
``gru_seq.cu``, ``gru_seq_bwd.cu``) keep a slice of R in shared memory for
a whole sequence: the LSTM's across the blocks of a thread-block cluster
(16 at most), the GRU's across a co-resident grid. Past a width they
cannot launch (the LSTM's H = 448 at any N, the GRU's near 1,056,
depending on N); past H = 300 the LSTM's backward also leaves to the
step route the batches where it is faster. There the JAX package leaves its
Pallas kernels for a ``lax.scan``; here ``csrc/rnn_step.cu`` takes over:
one launch per time step, R read from L2/HBM once a step, the reduction
split across a thread-block cluster, the steps chained by programmatic
dependent launch (design and bounds in its header). The backward's dR
(and drb) come from the persistent sources' dR passes, which take any H.
``step_plan`` mirrors the source's launch plan (``rnn_step_plan``) for the
CPU tests, and ``step_cells`` which block finalises each output cell.

The persistent sources answer, by shape and before any launch, whether
their kernel would launch on this card (``lstm_seq_fits``,
``lstm_seq_bwd_fits``, ``gru_seq_fits``, ``gru_seq_bwd_fits``: the launch's
own checks, shared memory and the occupancy calculator's co-resident
blocks or clusters, with nothing launched); the wrappers in ``lstm.py`` and ``gru.py``
ask through ``takes_persistent`` on CUDA tensors and never route by
catching a failed launch. The step wrappers below are what they call
otherwise; each counts one launch per sequence (T or T+1 kernel launches)
in ``.launches``, and for CPU tensors runs the same plain version as the
persistent route.
"""

from __future__ import annotations

import functools

import torch

from deeplearning4j_tpu_torch.kernels import build, gru, lstm
from deeplearning4j_tpu_torch.kernels.lstm import _count, _cuda_f32

# kind -> (source, entry, arguments after N and H)
_FITS = {
    "lstm_infer": ("lstm_seq_infer", "lstm_seq_fits", (0,)),
    "lstm_fwd": ("lstm_seq_infer", "lstm_seq_fits", (1,)),
    "lstm_bwd": ("lstm_seq_bwd", "lstm_seq_bwd_fits", ()),
    "gru_infer": ("gru_seq", "gru_seq_fits", (0,)),
    "gru_fwd": ("gru_seq", "gru_seq_fits", (1,)),
    "gru_bwd": ("gru_seq_bwd", "gru_seq_bwd_fits", ()),
}


@functools.lru_cache(maxsize=None)
def _fits(kind, n, hsz, device) -> int:
    source, entry, flags = _FITS[kind]
    return build.query(source, entry, f"{kind} route query",
                       [n, hsz, *flags], device)


def takes_persistent(kind, n, hsz, device) -> bool:
    """The route for a CUDA launch of ``kind`` (a key of ``_FITS``): the
    persistent kernel when its source finds it would launch at batch n and
    width hsz on this card (0); else, where R's slice does not fit in
    shared memory (-1) or the card cannot hold the plan's grid (GRU) or
    one cluster of its size (LSTM) at once (-2), the step route."""
    if kind not in _FITS:
        raise ValueError(f"unknown persistent kernel {kind!r}")
    rc = _fits(kind, n, hsz, torch.device(device))
    if rc not in (0, -1, -2):
        raise RuntimeError(f"{kind} route query at N={n} H={hsz}: code "
                           f"{rc}")
    return rc == 0


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

STEP_CELLS = ("lstm", "gru")
STEP_KINDS = ("infer", "fwd", "bwd")
PLAN_FIELDS = ("units", "cluster", "rows", "tiles", "rows_per_thread",
               "row_threads", "col_threads", "splits", "threads", "stages",
               "smem_bytes", "blocks", "k_per_rank")
_CHUNK, _PAD, _STAGES = 64, 68, 3
_SMEM_PER_SM = 233472   # bytes an H100 SM gives its blocks
_FWD_THREADS, _BWD_THREADS, _MAX_ROWS, _RANK_K = 384, 256, 64, 1024


def _cdiv(a, b):
    return -(-a // b)


def step_plan(cell, kind, n, hsz, sms):
    """The step kernels' launch plan for ``cell`` ("lstm", "gru") and
    ``kind`` ("infer", "fwd", "bwd") at batch n and width hsz on a card of
    ``sms`` SMs, as ``csrc/rnn_step.cu`` computes it (``rnn_step_plan``):
    a dict of ``PLAN_FIELDS``.

    A block owns ``units`` hidden units (G*units columns of R forward,
    units rows of R backward) and every row, in ``tiles`` row tiles of
    ``rows``; ``cluster`` blocks share the slice and split the reduction
    (H forward, G*H backward) into ranges of ``k_per_rank``. Units and
    cluster give the most blocks not above ``sms``, a rank summing at
    least two chunks of 64 and none idle; among those, the smallest cluster whose ranks
    sum at most 1024 of k, else the shortest sum a rank (as measured on
    an H100: ``scripts/rnn_step_ab.py``). Each thread holds
    ``rows_per_thread`` rows (8 from 32 rows, 4 from 4, else 1) x 4
    columns; ``splits`` thread groups share each chunk's k, as many as 384 threads (forward) or 256 (backward)
    allow. The shared memory is the larger of a ring of ``stages`` (R's
    chunk and the rows' chunk, rows padded to 68 floats) and the partial
    tile [splits, rows, columns], then the [rows, columns] sums that the
    cluster's ranks send the rank finalising them: three stages, or two
    where only two let a block of at most 256 threads share its SM with
    the next step's."""
    if cell not in STEP_CELLS or kind not in STEP_KINDS or min(
            n, hsz, sms) < 1:
        raise ValueError(f"step route: no plan for {cell} {kind} at N={n}, "
                         f"H={hsz}, {sms} SMs")
    g = 4 if cell == "lstm" else 3
    bwd = kind == "bwd"
    k = g * hsz if bwd else hsz
    best = (0, 0, 0, 0)   # (blocks, score, units, cluster)
    for units in ((16, 32, 64) if bwd else (16, 32)):
        for cluster in (1, 2, 4):
            blocks = _cdiv(hsz, units) * cluster
            rank_k = _cdiv(k, cluster)
            kr = _cdiv(rank_k, _CHUNK) * _CHUNK
            if blocks > sms or (cluster > 1 and (
                    k < 2 * _CHUNK * cluster or (cluster - 1) * kr >= k)):
                continue
            score = -cluster if rank_k <= _RANK_K else -_RANK_K - rank_k
            if (blocks, score) > best[:2]:
                best = (blocks, score, units, cluster)
    if best[0] == 0:
        units = 64 if bwd else 32
        best = (_cdiv(hsz, units), 0, units, 1)
    blocks, _, units, cluster = best
    tiles = _cdiv(n, _MAX_ROWS)
    rows = _cdiv(n, tiles)
    tm = 8 if rows >= 32 else 4 if rows >= 4 else 1
    rth = _cdiv(rows, tm)
    cols = units if bwd else g * units
    cth = cols // 4
    splits = _CHUNK // 4
    max_threads = _BWD_THREADS if bwd else _FWD_THREADS
    while splits > 1 and rth * cth * splits > max_threads:
        splits //= 2
    rt, threads = rth * tm, rth * cth * splits
    stage = (units * _PAD if bwd else _CHUNK * cols) + rt * _PAD
    smem = {n: 4 * (max(n * stage, splits * rt * cols) + rt * cols)
            for n in (_STAGES, 2)}
    pairs = {n: 2 * (b + 1024) <= _SMEM_PER_SM for n, b in smem.items()}
    stages = 2 if (threads <= _BWD_THREADS and not pairs[_STAGES]
                   and pairs[2]) else _STAGES
    return dict(units=units, cluster=cluster, rows=rows, tiles=tiles,
                rows_per_thread=tm, row_threads=rth, col_threads=cth,
                splits=splits, threads=threads, stages=stages,
                smem_bytes=smem[stages], blocks=blocks,
                k_per_rank=_cdiv(_cdiv(k, cluster), _CHUNK) * _CHUNK)


def step_source_plan(cell, kind, n, hsz, sms, device=None):
    """The same plan asked of the compiled source (nothing launched)."""
    out = torch.zeros(len(PLAN_FIELDS), dtype=torch.int32)
    device = torch.device("cuda") if device is None else device
    rc = build.query("rnn_step", "rnn_step_plan", "step route plan",
                     [STEP_CELLS.index(cell), STEP_KINDS.index(kind), n, hsz,
                      sms, out], device)
    if rc != 0:
        raise ValueError(f"step route: the source refuses {cell} {kind} at "
                         f"N={n}, H={hsz}, {sms} SMs (code {rc})")
    return dict(zip(PLAN_FIELDS, (int(x) for x in out)))


def step_cells(plan, n, hsz):
    """Which block finalises which output cell, as the step kernels assign
    them: for each block (slice = block // cluster, rank = block % cluster)
    and row tile, the rank's share of the tile's rows x units cells, cells
    in row-major order split into ``cluster`` equal ranges. Returns a
    LongTensor [blocks * tiles, share] of cell ids n * hsz + unit (-1 where
    a share runs past the tile or a unit past hsz)."""
    units, cluster, rows = plan["units"], plan["cluster"], plan["rows"]
    out = []
    for block in range(plan["blocks"]):
        slice_, rank = divmod(block, cluster)
        for tile in range(plan["tiles"]):
            n0 = tile * rows
            cells = min(rows, n - n0) * units
            share = _cdiv(cells, cluster)
            e = torch.arange(rank * share, (rank + 1) * share)
            unit = slice_ * units + e % units
            ids = (n0 + e // units) * hsz + unit
            out.append(torch.where((e < cells) & (unit < hsz), ids, -1))
    width = max(len(x) for x in out)
    return torch.stack([torch.nn.functional.pad(x, (0, width - len(x)),
                                                value=-1) for x in out])


# ---------------------------------------------------------------------------
# step-route wrappers
# ---------------------------------------------------------------------------

def lstm_step_infer(xw, r, h0, c0):
    """``lstm_seq_infer`` by the step route: (hs, hT, cT)."""
    lstm._check_shapes("lstm_step_infer", xw, r, h0, c0)
    if xw.device.type == "cpu":
        return lstm.lstm_seq_infer_reference(xw, r, h0, c0)
    xw, r, h0, c0 = _cuda_f32("lstm_step_infer", [xw, r, h0, c0])
    t, n, four_h = xw.shape
    hsz = four_h // 4
    hs = xw.new_empty((t, n, hsz))
    c = c0.clone()   # the c state, updated in place; ends as cT
    build.call("rnn_step", "rnn_step_fwd_lstm_f32", "lstm_step_infer",
               [xw, r, h0, c0, hs, c, None, None, 0, t, n, hsz], xw.device)
    _count(lstm_step_infer)
    return hs, hs[-1].clone(), c


def lstm_step_fwd(xw, r, h0, c0):
    """``lstm_seq_fwd`` by the step route: (hs, gates, cs)."""
    lstm._check_shapes("lstm_step_fwd", xw, r, h0, c0)
    if xw.device.type == "cpu":
        return lstm.lstm_seq_fwd_reference(xw, r, h0, c0)
    xw, r, h0, c0 = _cuda_f32("lstm_step_fwd", [xw, r, h0, c0])
    t, n, four_h = xw.shape
    hsz = four_h // 4
    hs = xw.new_empty((t, n, hsz))
    gates = xw.new_empty((t, n, four_h))
    cs = xw.new_empty((t, n, hsz))
    build.call("rnn_step", "rnn_step_fwd_lstm_f32", "lstm_step_fwd",
               [xw, r, h0, c0, hs, None, gates, cs, 1, t, n, hsz], xw.device)
    _count(lstm_step_fwd)
    return hs, gates, cs


def lstm_step_bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0):
    """``lstm_seq_bwd`` by the step route: (dxw, dR, dh0, dc0)."""
    if dhs.device.type == "cpu":
        return lstm.lstm_seq_bwd_reference(dhs, dhT, dcT, gates, cs, hs, r,
                                           h0, c0)
    dhs, dhT, dcT, gates, cs, hs, r, h0, c0 = _cuda_f32(
        "lstm_step_bwd", [dhs, dhT, dcT, gates, cs, hs, r, h0, c0])
    t, n, hsz = dhs.shape
    dxw = gates.new_empty((t, n, 4 * hsz))
    dc = dcT.clone()   # the dc carry, updated in place; ends as dc0
    dh0 = gates.new_empty((n, hsz))
    build.call("rnn_step", "rnn_step_bwd_lstm_f32", "lstm_step_bwd",
               [dhs, dhT, gates, cs, r, c0, dxw, dc, dh0, t, n, hsz],
               dhs.device)
    dr = gates.new_empty((hsz, 4 * hsz))
    build.call("lstm_seq_bwd", "lstm_seq_bwd_dr_f32", "lstm_step_bwd dR",
               [hs, h0, dxw, dr, t, n, hsz], dhs.device)
    _count(lstm_step_bwd)
    return dxw, dr, dh0, dc


def gru_step_infer(xw, r, rb, h0):
    """``gru_seq_infer`` by the step route: (hs, hT)."""
    gru._check_shapes("gru_step_infer", xw, r, rb, h0)
    if xw.device.type == "cpu":
        return gru.gru_seq_infer_reference(xw, r, rb, h0)
    xw, r, rb, h0 = _cuda_f32("gru_step_infer", [xw, r, rb, h0])
    t, n, three_h = xw.shape
    hsz = three_h // 3
    hs = xw.new_empty((t, n, hsz))
    build.call("rnn_step", "rnn_step_fwd_gru_f32", "gru_step_infer",
               [xw, r, rb, h0, hs, None, None, None, 0, t, n, hsz], xw.device)
    _count(gru_step_infer)
    return hs, hs[-1].clone()


def gru_step_fwd(xw, r, rb, h0):
    """``gru_seq_fwd`` by the step route: (hs, ru, rz_c, cand)."""
    gru._check_shapes("gru_step_fwd", xw, r, rb, h0)
    if xw.device.type == "cpu":
        return gru.gru_seq_fwd_reference(xw, r, rb, h0)
    xw, r, rb, h0 = _cuda_f32("gru_step_fwd", [xw, r, rb, h0])
    t, n, three_h = xw.shape
    hsz = three_h // 3
    hs = xw.new_empty((t, n, hsz))
    ru = xw.new_empty((t, n, 2 * hsz))
    rzc = xw.new_empty((t, n, hsz))
    cand = xw.new_empty((t, n, hsz))
    build.call("rnn_step", "rnn_step_fwd_gru_f32", "gru_step_fwd",
               [xw, r, rb, h0, hs, ru, rzc, cand, 1, t, n, hsz], xw.device)
    _count(gru_step_fwd)
    return hs, ru, rzc, cand


def gru_step_bwd(dhs, dhT, ru, rzc, cand, hs, r, h0):
    """``gru_seq_bwd`` by the step route: (dxw, dR, drb, dh0)."""
    if dhs.device.type == "cpu":
        return gru.gru_seq_bwd_reference(dhs, dhT, ru, rzc, cand, hs, r, h0)
    dhs, dhT, ru, rzc, cand, hs, r, h0 = _cuda_f32(
        "gru_step_bwd", [dhs, dhT, ru, rzc, cand, hs, r, h0])
    t, n, hsz = dhs.shape
    dxw = ru.new_empty((t, n, 3 * hsz))
    drz = ru.new_empty((t, n, 3 * hsz))
    dhu = ru.new_empty((n, hsz))
    dh0 = ru.new_empty((n, hsz))
    build.call("rnn_step", "rnn_step_bwd_gru_f32", "gru_step_bwd",
               [dhs, dhT, ru, rzc, cand, hs, r, h0, dxw, drz, dhu, dh0, t, n,
                hsz], dhs.device)
    dr = ru.new_empty((hsz, 3 * hsz))
    drb = ru.new_empty((3 * hsz,))
    build.call("gru_seq_bwd", "gru_seq_bwd_dr_f32", "gru_step_bwd dR",
               [hs, h0, drz, dr, drb, t, n, hsz], dhs.device)
    _count(gru_step_bwd)
    return dxw, dr, drb, dh0


for _fn in (lstm_step_infer, lstm_step_fwd, lstm_step_bwd, gru_step_infer,
            gru_step_fwd, gru_step_bwd):
    _fn.launches = 0
