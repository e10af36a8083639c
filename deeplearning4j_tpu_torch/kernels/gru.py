"""GRU (reset-after) recurrence as hand-written CUDA kernels, with its
gradient.

Counterpart of ``deeplearning4j_tpu/kernels/gru.py``. Its three Pallas
kernels become CUDA C++ (design and bounds are in each file's header):

- ``_fwd_infer_kernel`` -> ``gru_seq_infer`` (``csrc/gru_seq.cu``, entry
  ``gru_seq_infer_f32``): the inference recurrence;
- ``_fwd_kernel`` -> ``gru_seq_fwd`` (the same source built with its
  residual-saving flag, entry ``gru_seq_fwd_f32``): the training forward,
  which also writes ru, rz_c and cand;
- ``_bwd_kernel`` -> ``gru_seq_bwd`` (``csrc/gru_seq_bwd.cu``): the
  reverse sweep through time and the dR, drb reduction.

``gru_seq`` binds the last two into a ``torch.autograd.Function``, the
counterpart of the JAX package's ``jax.custom_vjp``.

Layouts as in the JAX package: xw [T, N, 3H] (input projection with the
input bias folded in), R [H, 3H], rb [3H] (the recurrent bias, added
inside the recurrence because the reset gate multiplies its candidate
part), h0 [N, H]. Gate packing r, u, then the candidate c:

    rz = h R + rb;  r, u = sigmoid(xw_ru + rz_ru)
    cand = tanh(xw_c + r rz_c);  h' = u h + (1 - u) cand

Each wrapper takes its plain version only for tensors on the CPU. On a
CUDA tensor it launches its kernel, or raises: a build or launch failure is
an error, never a silent reroute. Each counts its launches in
``.launches``. Widths whose persistent kernel cannot launch on the card
(about H > 1,056) take the step route of ``kernels/rnn_step.py``, chosen
by shape before the launch, which counts its own launches.

``gru_seq_plan`` mirrors the forward kernel's launch plan (``csrc/gru_seq.cu``
``make_plan``, asked of the source by ``gru_seq_source_plan``) for the CPU
tests; ``gru_seq_cells`` and ``gru_seq_k_ranges`` say which block
finalises each output cell and which k each cluster rank sums. The
backward's two plans have mirrors too (``csrc/gru_seq_bwd.cu``):
``gru_seq_bwd_plan`` for the reverse sweep (``gru_seq_bwd_cells`` and
``gru_seq_bwd_j_ranges`` the cells each block finalises and the j each
rank sums) and ``gru_bwd_dr_plan`` for the dR pass, whose order of
summation ``gru_bwd_dr_model`` follows on the CPU.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.kernels.lstm import (
    _count, _cuda_f32, _launch, _route)

# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------


def _step(xw_t, rz, hsz, h_prev):
    """One step of the JAX package's ``_step``: (ru, rz_c, cand, h)."""
    ru = torch.sigmoid(xw_t[:, :2 * hsz] + rz[:, :2 * hsz])
    rz_c = rz[:, 2 * hsz:]
    cand = torch.tanh(xw_t[:, 2 * hsz:] + ru[:, :hsz] * rz_c)
    u = ru[:, hsz:]
    h = u * h_prev + (1.0 - u) * cand
    return ru, rz_c, cand, h


def gru_seq_infer_reference(xw, r, rb, h0):
    """The plain version of ``gru_seq_infer``: a loop over T with the
    kernel's math. Returns (hs, hT)."""
    hsz = r.shape[0]
    h = h0
    hs = []
    for t in range(xw.shape[0]):
        *_, h = _step(xw[t], h @ r + rb, hsz, h)
        hs.append(h)
    return torch.stack(hs), h


def gru_seq_fwd_reference(xw, r, rb, h0):
    """The plain version of ``gru_seq_fwd``: (hs, ru [T,N,2H], rz_c, cand
    [T,N,H])."""
    hsz = r.shape[0]
    h = h0
    hs, rus, rzcs, cands = [], [], [], []
    for t in range(xw.shape[0]):
        ru, rz_c, cand, h = _step(xw[t], h @ r + rb, hsz, h)
        hs.append(h)
        rus.append(ru)
        rzcs.append(rz_c)
        cands.append(cand)
    return (torch.stack(hs), torch.stack(rus), torch.stack(rzcs),
            torch.stack(cands))


def gru_seq_bwd_reference(dhs, dhT, ru, rzc, cand, hs, r, h0):
    """The plain version of ``gru_seq_bwd``: an explicit reverse loop with
    the math of the JAX package's ``_bwd_kernel`` (not autograd through a
    forward loop). Returns (dxw, dR, drb, dh0).

    The input side gets dz = [dr, du, dc_pre]; the recurrent side, and so
    dR, drb and the carry, gets drz = [dr, du, dc_pre * r]."""
    hsz = r.shape[0]
    dh_rec = dhT
    dxw = torch.empty(ru.shape[:2] + (3 * hsz,), dtype=ru.dtype,
                      device=ru.device)
    dr = torch.zeros_like(r)
    drb = torch.zeros(3 * hsz, dtype=r.dtype, device=r.device)
    for t in reversed(range(dhs.shape[0])):
        rgate, u = ru[t, :, :hsz], ru[t, :, hsz:]
        h_prev = hs[t - 1] if t else h0
        dh = dhs[t] + dh_rec
        dcand = dh * (1.0 - u)
        du = dh * (h_prev - cand[t])
        dc_pre = dcand * (1.0 - cand[t] * cand[t])
        dru_r = dc_pre * rzc[t] * rgate * (1.0 - rgate)
        dru_u = du * u * (1.0 - u)
        dxw[t] = torch.cat([dru_r, dru_u, dc_pre], dim=1)
        drz = torch.cat([dru_r, dru_u, dc_pre * rgate], dim=1)
        dh_rec = dh * u + drz @ r.T
        dr += h_prev.T @ drz
        drb += drz.sum(dim=0)
    return dxw, dr, drb, dh_rec


# ---------------------------------------------------------------------------
# the forward kernel's launch plan
# ---------------------------------------------------------------------------

PLAN_FIELDS = ("units", "cluster", "rows", "tiles", "rows_per_thread",
               "row_threads", "col_threads", "splits", "threads", "stages",
               "smem_bytes", "blocks", "k_per_rank", "groups", "share")
_CHUNK, _MAX_THREADS, _MAX_ROWS, _MAX_STAGES = 64, 384, 64, 9
_MAX_CLUSTER = 2
_SMEM_OPTIN = 232448   # bytes a block may opt into on an H100


def _cdiv(a, b):
    return -(-a // b)


def _round4(a):
    return (a + 3) & ~3


def _smem(kr, cols, stages, rth, tm, splits, cluster, share):
    """Bytes: R's slice [kr][cols], the ring of ``stages`` stages (rth row
    slots of tm rows at stride 64, slots at stride tm * 64 + 4; the splits'
    sums [splits][rth * tm][cols] go over it), the ranks' sums
    [cluster][3][share] and the mbarrier counting their arrival."""
    return 4 * (kr * cols + max(stages * rth * (tm * _CHUNK + 4),
                                splits * rth * tm * cols)
                + cluster * 3 * share) + 16


def gru_seq_plan(n, hsz, sms):
    """The launch plan of ``gru_seq_infer`` and ``gru_seq_fwd`` at batch n
    and width hsz on a card of ``sms`` SMs, as ``csrc/gru_seq.cu`` computes
    it (``make_plan``; the entry ``gru_seq_plan``): (code, plan), the plan
    a dict of ``PLAN_FIELDS``, or None with code -1 (no slice of R fits in
    shared memory), -2 (one fits but needs more blocks than SMs) or -3 (an
    empty dimension).

    A block owns ``units`` hidden units (their 3 gate columns) and a
    cluster of ``cluster`` blocks splits the reduction over k into ranges
    of ``k_per_rank``; each rank keeps its part of R in shared memory for
    the whole sequence. Rows come in ``tiles`` row tiles of ``rows`` (at
    most 64), each thread holding ``rows_per_thread`` rows (8 from 32 rows,
    4 from 4, else 1) x 4 columns, ``splits`` thread groups sharing each
    64-k chunk (as many as 384 threads allow). Units and cluster give the
    most blocks not above ``sms`` whose shared memory (R's slice, a ring of
    two stages, the ranks' sums) fits in 227 KiB, then the largest
    cluster; ``groups`` copies of the grid split the row tiles where the
    SMs allow. The h ring has a stage for each 64-k chunk of a rank's k and
    one more where they fit (all chunks in flight at once), else at most 9
    stages, fewer where they do not fit. (On the card the launch takes a
    smaller cluster where it cannot hold all of the plan's clusters at
    once: ``gru_seq_source_plan`` with ``sms`` <= 0.)"""
    if min(n, hsz, sms) < 1:
        return -3, None
    tiles = _cdiv(n, _MAX_ROWS)
    rows = _cdiv(n, tiles)
    tm = 8 if rows >= 32 else 4 if rows >= 4 else 1
    rth = _cdiv(rows, tm)
    rc, best = -1, None
    for units in (8, 16, 32):
        cluster = 1
        while cluster <= _MAX_CLUSTER:
            cols = 3 * units
            cth = cols // 4
            blocks = _cdiv(hsz, units) * cluster
            kr = _round4(_cdiv(hsz, cluster))
            splits = min(_MAX_THREADS // (rth * cth), _CHUNK // 4)
            share = _round4(_cdiv(rows * units, cluster))
            if (cluster > 1 and (cluster - 1) * kr >= hsz) or _smem(
                    kr, cols, 2, rth, tm, splits, cluster,
                    share) > _SMEM_OPTIN:
                pass
            elif blocks > sms:
                rc = -2 if rc == -1 else rc
            elif rc != 0 or (blocks, cluster) > (best["blocks"],
                                                 best["cluster"]):
                rc = 0
                best = dict(units=units, cluster=cluster, rows=rows,
                            tiles=tiles, rows_per_thread=tm, row_threads=rth,
                            col_threads=cth, splits=splits,
                            threads=rth * cth * splits, blocks=blocks,
                            k_per_rank=kr, share=share)
            cluster *= 2
    if rc != 0:
        return rc, None
    groups = min(sms // best["blocks"], tiles)
    chunks = _cdiv(best["k_per_rank"], _CHUNK)

    def smem(stages):
        return _smem(best["k_per_rank"], 3 * best["units"], stages, rth, tm,
                     best["splits"], best["cluster"], best["share"])

    stages = chunks + 1
    if smem(stages) > _SMEM_OPTIN:
        stages = min(chunks, _MAX_STAGES)
        while stages > 2 and smem(stages) > _SMEM_OPTIN:
            stages -= 1
    best.update(groups=groups, blocks=best["blocks"] * groups, stages=stages,
                smem_bytes=smem(stages))
    return 0, {k: best[k] for k in PLAN_FIELDS}


def gru_seq_source_plan(n, hsz, save, sms, device=None):
    """The same (code, plan) asked of the compiled source, nothing
    launched; with ``sms`` <= 0 the plan this card launches (for save 0,
    the inference forward, or 1, the training forward), with a smaller
    cluster where the card cannot hold the plan's clusters at once."""
    out = torch.zeros(len(PLAN_FIELDS), dtype=torch.int32)
    device = torch.device("cuda") if device is None else device
    rc = build.query("gru_seq", "gru_seq_plan", "gru_seq plan",
                     [n, hsz, int(save), sms, out], device)
    return rc, (dict(zip(PLAN_FIELDS, (int(x) for x in out)))
                if rc == 0 else None)


def gru_seq_cells(plan, n, hsz):
    """The cells (ids row * hsz + unit) that each block of ``plan``
    finalises, block after block, as the kernel assigns them: block b is
    rank b % cluster of unit slice (b // cluster) % slices in row group
    b // (cluster * slices); over each of its group's row tiles the rank
    takes the ``share``-long range of the tile's rows x units cells (row
    major) at rank * share. A LongTensor; each cell of [n, hsz] appears
    once."""
    units, cluster, rows = plan["units"], plan["cluster"], plan["rows"]
    slices = _cdiv(hsz, units)
    out = []
    for block in range(plan["blocks"]):
        rank, cl_id = block % cluster, block // cluster
        slice_, group = cl_id % slices, cl_id // slices
        for tile in range(group, plan["tiles"], plan["groups"]):
            n0 = tile * rows
            cells = min(rows, n - n0) * units
            share = _round4(_cdiv(cells, cluster))
            e = torch.arange(min(cells, rank * share),
                             min(cells, rank * share + share))
            unit = slice_ * units + e % units
            out.append(((n0 + e // units) * hsz + unit)[unit < hsz])
    return torch.cat(out)


def gru_seq_k_ranges(plan, hsz):
    """[kb, ke) of the reduction over k that each cluster rank sums."""
    kr = plan["k_per_rank"]
    return [(q * kr, min(hsz, (q + 1) * kr)) for q in range(plan["cluster"])]


# ---------------------------------------------------------------------------
# the backward kernels' launch plans
# ---------------------------------------------------------------------------

BWD_PLAN_FIELDS = ("units", "cluster", "rows_per_warp", "tiles", "threads",
                   "smem_bytes", "blocks", "j_per_rank", "groups")
DR_PLAN_FIELDS = ("tiles", "splits", "chunk", "blocks", "smem_bytes")
_BWD_UNITS, _BWD_WARPS, _BWD_MAX_SUMS = (8, 16, 20), 16, 64
# the dR pass: 128 x 128 tiles of dR, 16 m a step, a six-stage ring of A
# and B tiles, two blocks an SM, M split in at most 4 chunks, the
# cluster's sum counted as 4 steps
_DR_TILE, _DR_BK, _DR_STAGES, _DR_PER_SM = 128, 16, 6, 2
_DR_MAX_SPLITS, _DR_REDUCE_STEPS = 4, 4


def _padded_sums(rw, units):
    """The sums a lane keeps, rw x units, padded to a power of two from 8
    for the warp's reduce-scatter."""
    need, out = rw * units, 8
    while out < need:
        out *= 2
    return out


def _rows_per_warp(n, units):
    rw = 1 if n <= _BWD_WARPS else 2 if n <= 2 * _BWD_WARPS else 4
    while rw > 1 and _padded_sums(rw, units) > _BWD_MAX_SUMS:
        rw //= 2
    return rw


def gru_seq_bwd_plan(n, hsz, sms):
    """The launch plan of ``gru_seq_bwd``'s reverse sweep at batch n and
    width hsz on a card of ``sms`` SMs, as ``csrc/gru_seq_bwd.cu`` computes
    it (``make_plan``; the entry ``gru_seq_bwd_plan``): (code, plan), the
    plan a dict of ``BWD_PLAN_FIELDS``, or None with code -1, -2 or -3 as
    in ``gru_seq_plan``.

    A block of 16 warps owns ``units`` (8, 16 or 20) hidden units k, and a
    cluster of ``cluster`` blocks splits the sum over j (3H) into ranges of
    ``j_per_rank``; each rank keeps R's rows of its units over its j-range
    in shared memory. Each warp owns ``rows_per_warp`` rows (1 up to 16
    rows of N, 2 up to 32, else 4, fewer where a lane's rows x units sums,
    padded to a power of two, pass 64), so a row tile is 16 of them. The
    plan takes the most blocks not above ``sms`` whose shared memory
    (R's slice, the ranks' sums and their mbarrier) fits in 227 KiB, then
    the most units; ``groups`` copies of the grid split the row tiles
    where the SMs allow."""
    if min(n, hsz, sms) < 1:
        return -3, None
    width = 3 * hsz
    rc, best = -1, None
    for units in _BWD_UNITS:
        cluster = 1
        while cluster <= _MAX_CLUSTER:
            blocks = _cdiv(hsz, units) * cluster
            jr = _round4(_cdiv(width, cluster))
            rw = _rows_per_warp(n, units)
            smem = 4 * (units * jr + _BWD_WARPS * rw * units) + 16
            if (cluster > 1 and (cluster - 1) * jr >= width) \
                    or smem > _SMEM_OPTIN:
                pass
            elif blocks > sms:
                rc = -2 if rc == -1 else rc
            elif rc != 0 or (blocks, units) > (best["blocks"],
                                               best["units"]):
                rc = 0
                best = dict(units=units, cluster=cluster, rows_per_warp=rw,
                            blocks=blocks, j_per_rank=jr, smem_bytes=smem)
            cluster *= 2
    if rc != 0:
        return rc, None
    tiles = _cdiv(n, _BWD_WARPS * best["rows_per_warp"])
    groups = min(sms // best["blocks"], tiles)
    best.update(tiles=tiles, groups=groups, blocks=best["blocks"] * groups,
                threads=32 * _BWD_WARPS)
    return 0, {k: best[k] for k in BWD_PLAN_FIELDS}


def gru_seq_bwd_source_plan(n, hsz, sms, device=None):
    """The sweep's (code, plan) asked of the compiled source, nothing
    launched; with ``sms`` <= 0 the plan this card launches (a cluster of
    1 where it cannot hold the plan's clusters at once)."""
    out = torch.zeros(len(BWD_PLAN_FIELDS), dtype=torch.int32)
    device = torch.device("cuda") if device is None else device
    rc = build.query("gru_seq_bwd", "gru_seq_bwd_plan", "gru_seq_bwd plan",
                     [n, hsz, sms, out], device)
    return rc, (dict(zip(BWD_PLAN_FIELDS, (int(x) for x in out)))
                if rc == 0 else None)


def gru_seq_bwd_cells(plan, n, hsz):
    """The cells (ids row * hsz + unit) that each block of the sweep's
    ``plan`` finalises, block after block, as the kernel assigns them:
    block b is rank b % cluster of unit slice (b // cluster) % slices in
    row group b // (cluster * slices); over each of its group's row tiles
    the rank finalises its units' share (units / cluster of them, from
    rank * units / cluster) of every row. A LongTensor; each cell of
    [n, hsz] appears once."""
    units, cluster, rw = plan["units"], plan["cluster"], plan["rows_per_warp"]
    share = units // cluster
    slices = _cdiv(hsz, units)
    rows = torch.arange(_BWD_WARPS * rw)
    out = []
    for block in range(plan["blocks"]):
        rank, cl_id = block % cluster, block // cluster
        slice_, group = cl_id % slices, cl_id // slices
        unit = slice_ * units + rank * share + torch.arange(share)
        for tile in range(group, plan["tiles"], plan["groups"]):
            row = tile * _BWD_WARPS * rw + rows
            ids = row[:, None] * hsz + unit[None, :]
            out.append(ids[(row < n)[:, None] & (unit < hsz)[None, :]])
    return torch.cat(out)


def gru_seq_bwd_j_ranges(plan, hsz):
    """[jb, je) of the sweep's sum over j (3H) that each cluster rank
    takes."""
    jr = plan["j_per_rank"]
    return [(q * jr, min(3 * hsz, (q + 1) * jr))
            for q in range(plan["cluster"])]


def gru_bwd_dr_plan(t, n, hsz, sms):
    """The dR pass's plan (``csrc/gru_seq_bwd.cu`` ``make_dr_plan``; the
    entry ``gru_seq_bwd_dr_plan``) for T = t steps at batch n and width
    hsz on ``sms`` SMs: (code, plan), the plan a dict of
    ``DR_PLAN_FIELDS``, or None with code -3.

    dR's 128 x 128 tiles each sum over M = t * n rows; ``splits`` (1, 2 or
    4) blocks of one cluster share a tile, split s summing rows [s * chunk,
    (s + 1) * chunk). The plan takes the splits of least cost, counted as
    waves of two blocks an SM times the 16-row steps of a chunk (plus 4
    for the cluster's sum), the fewer splits where two tie."""
    if min(t, n, hsz, sms) < 1:
        return -3, None
    tiles = _cdiv(hsz, _DR_TILE) * _cdiv(3 * hsz, _DR_TILE)
    steps = _cdiv(t * n, _DR_BK)
    best = None
    splits = 1
    while splits <= _DR_MAX_SPLITS:
        chunk_steps = _cdiv(steps, splits)
        if splits == 1 or (splits - 1) * chunk_steps < steps:
            cost = (_cdiv(tiles * splits, sms * _DR_PER_SM) * chunk_steps
                    + (_DR_REDUCE_STEPS if splits > 1 else 0))
            if best is None or cost < best[0]:
                best = (cost, splits, chunk_steps * _DR_BK)
        splits *= 2
    _, splits, chunk = best
    smem = 4 * (_DR_STAGES * _DR_BK * 2 * _DR_TILE + _DR_TILE)
    return 0, dict(tiles=tiles, splits=splits, chunk=chunk,
                   blocks=tiles * splits, smem_bytes=smem)


def gru_bwd_dr_source_plan(t, n, hsz, sms, device=None):
    """The dR pass's (code, plan) asked of the compiled source; with
    ``sms`` <= 0 for this card's SM count."""
    out = torch.zeros(len(DR_PLAN_FIELDS), dtype=torch.int32)
    device = torch.device("cuda") if device is None else device
    rc = build.query("gru_seq_bwd", "gru_seq_bwd_dr_plan",
                     "gru_seq_bwd dR plan", [t, n, hsz, sms, out], device)
    return rc, (dict(zip(DR_PLAN_FIELDS, (int(x) for x in out)))
                if rc == 0 else None)


def gru_bwd_dr_model(hs, h0, drz, plan):
    """dR and drb in the dR pass's order of summation: over the M = T*N
    rows of hprev (h0, then hs[:-1]) and drz in the plan's chunks, each
    chunk's sum formed alone, then the chunks' partials added in split
    order, from zero. The CPU tests hold it against the JAX package."""
    hsz = h0.shape[1]
    a = torch.cat([h0[None], hs[:-1]]).reshape(-1, hsz)
    b = drz.reshape(-1, 3 * hsz)
    dr = torch.zeros((hsz, 3 * hsz), dtype=b.dtype, device=b.device)
    drb = torch.zeros((3 * hsz,), dtype=b.dtype, device=b.device)
    chunk = plan["chunk"]
    for split in range(plan["splits"]):
        rows = slice(split * chunk, (split + 1) * chunk)
        dr = dr + a[rows].T @ b[rows]
        drb = drb + b[rows].sum(dim=0)
    return dr, drb


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_shapes(what, xw, r, rb, h0):
    if xw.dim() != 3 or min(xw.shape) < 1:
        raise ValueError(f"xw must be [T>=1, N>=1, 3H>=3], got "
                         f"{tuple(xw.shape)}")
    _, n, three_h = xw.shape
    hsz = r.shape[0]
    if three_h != 3 * hsz or tuple(r.shape) != (hsz, 3 * hsz):
        raise ValueError(f"xw {tuple(xw.shape)} and R {tuple(r.shape)} do "
                         f"not agree on H")
    if tuple(rb.shape) != (3 * hsz,):
        raise ValueError(f"rb must be [{3 * hsz}], got {tuple(rb.shape)}")
    if tuple(h0.shape) != (n, hsz):
        raise ValueError(f"h0 must be [{n}, {hsz}], got {tuple(h0.shape)}")
    for a in (r, rb, h0):
        if a.device != xw.device:
            raise ValueError(f"{what} inputs lie on different devices")


def gru_seq_infer(xw, r, rb, h0):
    """Full GRU recurrence without residuals: (hs [T,N,H], hT).

    The inference route: its outputs carry no graph on the GPU, so it
    refuses inputs that require grad while grad mode is on (``gru_seq``
    is the differentiable route)."""
    _check_shapes("gru_seq_infer", xw, r, rb, h0)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (xw, r, rb, h0)):
        raise RuntimeError(
            "gru_seq_infer has no gradient: call gru_seq for inputs that "
            "require grad, or run under torch.no_grad()/inference_mode()")
    if xw.device.type == "cpu":
        return gru_seq_infer_reference(xw, r, rb, h0)
    xw, r, rb, h0 = _cuda_f32("gru_seq_infer", [xw, r, rb, h0])
    t, n, three_h = xw.shape
    hsz = three_h // 3
    if not _route().takes_persistent("gru_infer", n, hsz, xw.device):
        return _route().gru_step_infer(xw, r, rb, h0)
    hs = xw.new_empty((t, n, hsz))
    hT = xw.new_empty((n, hsz))
    _launch("gru_seq", "gru_seq_infer_f32", "gru_seq_infer",
            [xw, r, rb, h0, hs, hT], t, n, hsz, xw.device)
    _count(gru_seq_infer)
    return hs, hT


def gru_seq_fwd(xw, r, rb, h0):
    """The training forward: (hs [T,N,H], ru [T,N,2H], rz_c [T,N,H],
    cand [T,N,H])."""
    _check_shapes("gru_seq_fwd", xw, r, rb, h0)
    if xw.device.type == "cpu":
        return gru_seq_fwd_reference(xw, r, rb, h0)
    xw, r, rb, h0 = _cuda_f32("gru_seq_fwd", [xw, r, rb, h0])
    t, n, three_h = xw.shape
    hsz = three_h // 3
    if not _route().takes_persistent("gru_fwd", n, hsz, xw.device):
        return _route().gru_step_fwd(xw, r, rb, h0)
    hs = xw.new_empty((t, n, hsz))
    ru = xw.new_empty((t, n, 2 * hsz))
    rzc = xw.new_empty((t, n, hsz))
    cand = xw.new_empty((t, n, hsz))
    _launch("gru_seq", "gru_seq_fwd_f32", "gru_seq_fwd",
            [xw, r, rb, h0, hs, ru, rzc, cand], t, n, hsz, xw.device)
    _count(gru_seq_fwd)
    return hs, ru, rzc, cand


def gru_seq_bwd(dhs, dhT, ru, rzc, cand, hs, r, h0):
    """The backward through time: (dxw [T,N,3H], dR [H,3H], drb [3H],
    dh0 [N,H])."""
    t, n, hsz = dhs.shape
    want = {"dhT": (n, hsz), "ru": (t, n, 2 * hsz), "rzc": (t, n, hsz),
            "cand": (t, n, hsz), "hs": (t, n, hsz), "r": (hsz, 3 * hsz),
            "h0": (n, hsz)}
    args = dict(dhT=dhT, ru=ru, rzc=rzc, cand=cand, hs=hs, r=r, h0=h0)
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"gru_seq_bwd: {name} must be {list(shape)}, "
                             f"got {list(args[name].shape)}")
        if args[name].device != dhs.device:
            raise ValueError("gru_seq_bwd inputs lie on different devices")
    if dhs.device.type == "cpu":
        return gru_seq_bwd_reference(dhs, dhT, ru, rzc, cand, hs, r, h0)
    ins = _cuda_f32("gru_seq_bwd", [dhs, dhT, ru, rzc, cand, hs, r, h0])
    if not _route().takes_persistent("gru_bwd", n, hsz, dhs.device):
        return _route().gru_step_bwd(*ins)
    dxw = ru.new_empty((t, n, 3 * hsz))
    drz = ru.new_empty((t, n, 3 * hsz))   # scratch: the recurrent-side dz
    dr = ru.new_empty((hsz, 3 * hsz))
    drb = ru.new_empty((3 * hsz,))
    dh0 = ru.new_empty((n, hsz))
    _launch("gru_seq_bwd", "gru_seq_bwd_f32", "gru_seq_bwd",
            ins + [dxw, drz, dr, drb, dh0], t, n, hsz, dhs.device)
    _count(gru_seq_bwd)
    return dxw, dr, drb, dh0


for _fn in (gru_seq_infer, gru_seq_fwd, gru_seq_bwd):
    _fn.launches = 0


class _GruSeq(torch.autograd.Function):
    """(xw, R, rb, h0) -> (hs, hT), with the gradient of all four."""

    @staticmethod
    def forward(ctx, xw, r, rb, h0):
        hs, ru, rzc, cand = gru_seq_fwd(xw, r, rb, h0)
        ctx.save_for_backward(ru, rzc, cand, hs, r, h0)
        # a copy, so that no output is a view of another
        return hs, hs[-1].clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dhs, dhT):
        ru, rzc, cand, hs, r, h0 = ctx.saved_tensors
        return gru_seq_bwd(dhs, dhT, ru, rzc, cand, hs, r, h0)


def gru_seq(xw, r, rb, h0):
    """Full GRU recurrence (hs [T,N,H], hT) that autograd can
    differentiate: ``gru_seq_fwd`` forward, ``gru_seq_bwd`` backward (on
    the CPU their plain versions)."""
    _check_shapes("gru_seq", xw, r, rb, h0)
    return _GruSeq.apply(xw, r, rb, h0)
