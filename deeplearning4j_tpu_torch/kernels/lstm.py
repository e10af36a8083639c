"""LSTM recurrence as hand-written CUDA kernels, with its gradient.

Counterpart of ``deeplearning4j_tpu/kernels/lstm.py``. Its three Pallas
kernels become CUDA C++ (design and bounds are in each file's header):

- ``_fwd_infer_kernel`` -> ``lstm_seq_infer`` (``csrc/lstm_seq_infer.cu``,
  entry ``lstm_seq_infer_f32``): the inference recurrence;
- ``_fwd_kernel`` -> ``lstm_seq_fwd`` (the same source built with its
  residual-saving flag, entry ``lstm_seq_fwd_f32``): the training forward,
  which also writes the post-activation gates and the cell states;
- ``_bwd_kernel`` -> ``lstm_seq_bwd`` (``csrc/lstm_seq_bwd.cu``): the
  reverse sweep through time and the dR reduction.

``lstm_seq`` binds the last two into a ``torch.autograd.Function``, the
counterpart of the JAX package's ``jax.custom_vjp``.

The forward and the backward's sweep run each row group as one
thread-block cluster that holds R and passes h (dz) between its blocks
over distributed shared memory. ``lstm_seq_plan`` and ``lstm_seq_bwd_plan``
mirror their launch plans (``make_plan`` in ``csrc/lstm_cluster.cuh``,
which both sources include; asked of each source by
``lstm_seq_source_plan`` and ``lstm_seq_bwd_source_plan``) for the CPU
tests, given the clusters of each size the card holds at once
(``lstm_seq_clusters``); ``lstm_seq_cells`` says which block finalises each
output cell, ``lstm_seq_rank_columns`` which columns each cluster rank
passes on. ``lstm_bwd_dr_plan`` mirrors the dR pass's plan.

Layouts as in the JAX package: xw [T, N, 4H] (input projection with bias
and forgetBias folded in), R [H, 4H], h0/c0 [N, H]. Gate packing i, f, g,
o.

Each wrapper takes its plain version only for tensors on the CPU. On a
CUDA tensor it launches its kernel, or raises: a build or launch failure is
an error, never a silent reroute. Each counts its launches in
``.launches``. Shapes whose persistent kernel does not launch on the card
take the step route of ``kernels/rnn_step.py``, chosen by shape before
the launch, which counts its own launches: H > 448, where no cluster's
blocks hold R in shared memory, and for the backward, past H = 300, the
batches where the step route is faster (``sweep_takes``).
"""

from __future__ import annotations

import threading

import torch

from deeplearning4j_tpu_torch.kernels import build

_count_lock = threading.Lock()


def _count(fn):
    with _count_lock:
        fn.launches += 1


def _route():
    """``kernels/rnn_step.py``, which picks the persistent kernel or the
    step route by shape (imported here: it imports this module)."""
    from deeplearning4j_tpu_torch.kernels import rnn_step

    return rnn_step


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _gate_step(z, c_prev, hsz):
    i = torch.sigmoid(z[:, :hsz])
    f = torch.sigmoid(z[:, hsz:2 * hsz])
    g = torch.tanh(z[:, 2 * hsz:3 * hsz])
    o = torch.sigmoid(z[:, 3 * hsz:])
    c = f * c_prev + i * g
    return i, f, g, o, c, o * torch.tanh(c)


def lstm_seq_infer_reference(xw, r, h0, c0):
    """The plain version of ``lstm_seq_infer``: a loop over T with the
    kernel's math."""
    hsz = r.shape[0]
    h, c = h0, c0
    hs = []
    for t in range(xw.shape[0]):
        *_, c, h = _gate_step(xw[t] + h @ r, c, hsz)
        hs.append(h)
    return torch.stack(hs), h, c


def lstm_seq_fwd_reference(xw, r, h0, c0):
    """The plain version of ``lstm_seq_fwd``: (hs, gates, cs), gates the
    post-activation [i|f|g|o] of every step."""
    hsz = r.shape[0]
    h, c = h0, c0
    hs, gates, cs = [], [], []
    for t in range(xw.shape[0]):
        i, f, g, o, c, h = _gate_step(xw[t] + h @ r, c, hsz)
        hs.append(h)
        gates.append(torch.cat([i, f, g, o], dim=1))
        cs.append(c)
    return torch.stack(hs), torch.stack(gates), torch.stack(cs)


def lstm_seq_bwd_reference(dhs, dhT, dcT, gates, cs, hs, r, h0, c0):
    """The plain version of ``lstm_seq_bwd``: an explicit reverse loop with
    the math of the JAX package's ``_bwd_kernel`` (not autograd through a
    forward loop). Returns (dxw, dR, dh0, dc0)."""
    hsz = r.shape[0]
    dh_rec, dc = dhT, dcT
    dxw = torch.empty_like(gates)
    dr = torch.zeros_like(r)
    for t in reversed(range(dhs.shape[0])):
        i, f, g, o = gates[t].split(hsz, dim=1)
        c_prev = cs[t - 1] if t else c0
        h_prev = hs[t - 1] if t else h0
        tc = torch.tanh(cs[t])
        dh = dhs[t] + dh_rec
        do = dh * tc
        dc = dc + dh * o * (1.0 - tc * tc)
        dz = torch.cat([dc * g * i * (1.0 - i),
                        dc * c_prev * f * (1.0 - f),
                        dc * i * (1.0 - g * g),
                        do * o * (1.0 - o)], dim=1)
        dxw[t] = dz
        dh_rec = dz @ r.T
        dc = dc * f
        dr += h_prev.T @ dz
    return dxw, dr, dh_rec, dc


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

PLAN_FIELDS = ("cluster", "units", "k_pad", "rows", "tiles", "rows_per_thread",
               "row_threads", "splits", "k_per_split", "threads",
               "smem_bytes", "blocks", "resident")
DR_PLAN_FIELDS = ("tiles", "splits", "chunk", "blocks", "smem_bytes")
CLUSTER_SIZES = (1, 2, 4, 8, 16)
_CLUSTER_ORDER = (8, 16, 4, 2, 1)   # by preference
_SMEM_OPTIN = 232448   # bytes a block may opt into on an H100
_MAX_ROWS = 64
_MIN_THREADS = 128   # a block's floor where one row's layout allows
# forward, sweep: cells a thread finalises, splits of the reduction
_MAX_CELLS = {False: 4, True: 2}
_MAX_SPLITS = {False: 8, True: 32}
# the dR pass: 128 x 128 tiles of dR, 16 m a step, a six-stage ring of A
# and B tiles, two blocks an SM, M split in at most 8 chunks, the
# cluster's sum counted as 4 steps
_DR_TILE, _DR_BK, _DR_STAGES, _DR_PER_SM = 128, 16, 6, 2
_DR_MAX_SPLITS, _DR_REDUCE_STEPS = 8, 4


def _cdiv(a, b):
    return -(-a // b)


def _round4(a):
    return (a + 3) & ~3


def _layout(bwd, cluster, units, rows):
    """A block's layout for ``rows`` rows in clusters of ``cluster``
    blocks of ``units`` units (``layout`` in ``csrc/lstm_cluster.cuh``),
    or None.

    Rows per thread from the rows (8 from 8, 4 from 3, else the rows);
    row slots to cover them; then the most splits of the reduction
    (k_pad units forward, 4 k_pad columns of dz in the sweep) up to 8
    (forward) or 32 (sweep), each at least 16 long (shorter where the
    threads would be too few to finalise the cells), within 512 threads
    (256 at 8 rows a thread), whose shared memory fits in 227 KiB: R's
    slice, the double-buffered h (dz), the splits' partial sums, the
    block's staged outputs and two mbarriers. A thread finalises at most 4
    (forward) or 2 (sweep) cells."""
    kh = cluster * units
    ncol, kd = (units, 4 * kh) if bwd else (4 * units, kh)
    cq = ncol // 4
    tm = 8 if rows >= 8 else 4 if rows >= 3 else rows
    rth = _cdiv(rows, tm)
    rcp = rth * tm
    cap = 256 if tm == 8 else 512
    if cq * rth > cap:
        return None
    ks = min(_MAX_SPLITS[bwd], cap // (cq * rth),
             max(_cdiv(kd, 16),
                 _cdiv(rows * units, _MAX_CELLS[bwd] * cq * rth)))
    while True:
        kr = _round4(_cdiv(kd, ks))
        splits = _cdiv(kd, kr)
        kp = splits * kr
        floats = (kp * ncol + 2 * rcp * (kp + 4) + splits * rcp * ncol
                  + rcp * (4 * units if bwd else units) + 4)
        threads = cq * rth * splits
        if (4 * floats <= _SMEM_OPTIN
                and rows * units <= _MAX_CELLS[bwd] * threads):
            return dict(cluster=cluster, units=units, k_pad=kh, rows=rows,
                        rows_per_thread=tm, row_threads=rth, splits=splits,
                        k_per_split=kr, threads=threads,
                        smem_bytes=4 * floats)
        if ks == 1:
            return None
        ks -= 1


def _caps(caps):
    """{cluster size: clusters the card holds at once} from a dict or a
    sequence over CLUSTER_SIZES."""
    if isinstance(caps, dict):
        return {c: int(caps.get(c, 0)) for c in CLUSTER_SIZES}
    return dict(zip(CLUSTER_SIZES, (int(x) for x in caps)))


def sweep_takes(n, hsz, sms):
    """Whether the backward's sweep takes batch n at width hsz on a card of
    ``sms`` SMs (``sweep_takes`` in ``csrc/lstm_cluster.cuh``): every
    batch to H = 300; past it, only those the sweep before the cluster
    redesign took, whose row tiles (8 rows to H = 360, 4 to 400, 2 to 423)
    of ceil(H/32) blocks fit one wave of one block an SM. Past them its
    clusters hold 2 to 4 rows and run in waves, and the step route takes
    the backward in less time (``scripts/lstm_seq_ab.py``'s route
    timings)."""
    if hsz <= 300:
        return True
    rows = 8 if hsz <= 360 else 4 if hsz <= 400 else 2 if hsz <= 423 else 0
    return n <= rows * (sms // _cdiv(hsz, 32))


def _plan(bwd, n, hsz, caps):
    if min(n, hsz) < 1:
        return -3, None
    caps = _caps(caps)
    if bwd and not sweep_takes(n, hsz, caps[1]):
        return -1, None
    rc = -1
    for idle_pass in (False, True):
        for cluster in _CLUSTER_ORDER:
            units = _round4(_cdiv(hsz, cluster))
            if ((cluster - 1) * units >= hsz) != idle_pass:
                continue
            one = _layout(bwd, cluster, units, 1)
            if one is None:
                continue
            floor = min(_MIN_THREADS, one["threads"])

            def fits(rows):
                plan = _layout(bwd, cluster, units, rows)
                return plan if plan and plan["threads"] >= floor else None

            rmax = next(r for r in range(_MAX_ROWS, 0, -1) if fits(r))
            cap = caps[cluster]
            if cap < 1:
                rc = -2
                continue
            waves = _cdiv(n, rmax * cap)
            rows = _cdiv(n, waves * cap)
            while not fits(rows):
                rows += 1
            plan = fits(rows)
            tiles = _cdiv(n, rows)
            plan.update(tiles=tiles, blocks=tiles * cluster, resident=cap)
            return 0, {k: plan[k] for k in PLAN_FIELDS}
    return rc, None


def lstm_seq_plan(n, hsz, caps):
    """The launch plan of ``lstm_seq_infer`` and ``lstm_seq_fwd`` at batch n
    and width hsz on a card that holds ``caps`` clusters of each size at
    once (a dict over CLUSTER_SIZES, or a sequence in their order), as
    ``csrc/lstm_seq_infer.cu`` computes it (``make_plan<false>``; the entry
    ``lstm_seq_plan``): (code, plan), the plan a dict of ``PLAN_FIELDS``,
    or None with code -1 (no slice of R fits in shared memory), -2 (one
    fits, but the card holds no cluster of its size) or -3 (an empty
    dimension).

    A cluster of ``cluster`` blocks (the first of 8, 16, 4, 2, 1 whose
    slice fits with no rank past hsz, else the first that fits) takes
    ``rows`` batch rows for the whole sequence; each block holds R's
    columns of ``units`` hidden units (a multiple of 4; the cluster covers
    ``k_pad`` = cluster x units >= hsz). ``rows`` is the fewest that spread
    n over the clusters the card holds in as few waves as the largest
    layout allows that fits and keeps 128 threads a block (or as many as
    one row's layout has), more where that many have no such layout;
    ``tiles`` clusters are launched."""
    return _plan(False, n, hsz, caps)


def lstm_seq_bwd_plan(n, hsz, caps):
    """The launch plan of ``lstm_seq_bwd``'s reverse sweep, as
    ``csrc/lstm_seq_bwd.cu`` computes it (``make_plan<true>``; the entry
    ``lstm_seq_bwd_plan``): the same rules as ``lstm_seq_plan`` with the
    sweep's layout (R's rows of ``units`` units, transposed, the sum over
    the 4 k_pad columns of dz split ``splits`` ways), and code -1 also for
    a batch ``sweep_takes`` leaves to the step route (the card's SM count
    taken as ``caps``' clusters of one block)."""
    return _plan(True, n, hsz, caps)


def _query_plan(source, entry, what, args, caps, device):
    out = torch.zeros(len(PLAN_FIELDS), dtype=torch.int32)
    cap_arg = None if caps is None else torch.tensor(
        [_caps(caps)[c] for c in CLUSTER_SIZES], dtype=torch.int32)
    device = torch.device("cuda") if device is None else device
    rc = build.query(source, entry, what, [*args, cap_arg, out], device)
    return rc, (dict(zip(PLAN_FIELDS, (int(x) for x in out)))
                if rc == 0 else None)


def lstm_seq_source_plan(n, hsz, save, caps=None, device=None):
    """The forward's (code, plan) asked of the compiled source for save 0
    (inference) or 1 (training), nothing launched; with ``caps`` None, for
    the clusters this card holds (the plan it launches)."""
    return _query_plan("lstm_seq_infer", "lstm_seq_plan", "lstm_seq plan",
                       [n, hsz, int(save)], caps, device)


def lstm_seq_bwd_source_plan(n, hsz, caps=None, device=None):
    """The sweep's (code, plan) asked of the compiled source; with ``caps``
    None, for the clusters this card holds."""
    return _query_plan("lstm_seq_bwd", "lstm_seq_bwd_plan",
                       "lstm_seq_bwd plan", [n, hsz], caps, device)


def lstm_seq_clusters(bwd=False, device=None):
    """{cluster size: clusters of the forward's (bwd: the sweep's) blocks
    this card holds at once at one block an SM}, as the source counts them
    (``cudaOccupancyMaxActiveClusters``; a size the card refuses counts
    0)."""
    out = torch.zeros(len(CLUSTER_SIZES), dtype=torch.int32)
    source, entry = (("lstm_seq_bwd", "lstm_seq_bwd_clusters") if bwd else
                     ("lstm_seq_infer", "lstm_seq_clusters"))
    device = torch.device("cuda") if device is None else device
    build.query(source, entry, "cluster capacity", [out], device)
    return dict(zip(CLUSTER_SIZES, (int(x) for x in out)))


def _span(lo, hi, end):
    """[lo, hi) below end (empty for a rank or group past it)."""
    return torch.arange(lo, max(lo, min(hi, end)))


def lstm_seq_cells(plan, n, hsz):
    """The cells (ids row * hsz + unit) that each block of a forward or
    sweep ``plan`` finalises, block after block, as the kernels assign
    them: block b is rank b % cluster of row group b // cluster, which
    takes rows [group * rows, (group + 1) * rows) and the rank's units
    [rank * units, (rank + 1) * units) (none for a rank past hsz). A
    LongTensor; each cell of [n, hsz] appears once."""
    units, cluster, rows = plan["units"], plan["cluster"], plan["rows"]
    out = []
    for block in range(plan["blocks"]):
        group, rank = divmod(block, cluster)
        row = _span(group * rows, (group + 1) * rows, n)
        unit = _span(rank * units, (rank + 1) * units, hsz)
        out.append((row[:, None] * hsz + unit[None, :]).reshape(-1))
    return torch.cat(out)


def lstm_seq_rank_columns(plan, hsz, bwd=False):
    """The columns each cluster rank passes to the others each step: h's
    units [rank * units, (rank + 1) * units) below hsz (forward), or dz's
    4 gate columns g * hsz + unit of those units (sweep). A list of
    LongTensors, one a rank."""
    units = plan["units"]
    out = []
    for rank in range(plan["cluster"]):
        unit = _span(rank * units, (rank + 1) * units, hsz)
        out.append((torch.arange(4)[:, None] * hsz + unit[None, :]).reshape(-1)
                   if bwd else unit)
    return out


def lstm_bwd_dr_plan(t, n, hsz, sms):
    """The dR pass's plan (``csrc/lstm_seq_bwd.cu`` ``make_dr_plan``; the
    entry ``lstm_seq_bwd_dr_plan``) for T = t steps at batch n and width
    hsz on ``sms`` SMs: (code, plan), the plan a dict of
    ``DR_PLAN_FIELDS``, or None with code -3.

    dR's 128 x 128 tiles each sum over M = t * n rows; ``splits`` (1, 2, 4
    or 8) blocks of one cluster share a tile, split s summing rows
    [s * chunk, (s + 1) * chunk). The plan takes the splits of least cost,
    counted as waves of two blocks an SM times the 16-row steps of a chunk
    (plus 4 for the cluster's sum), the fewer splits where two tie."""
    if min(t, n, hsz, sms) < 1:
        return -3, None
    tiles = _cdiv(hsz, _DR_TILE) * _cdiv(4 * hsz, _DR_TILE)
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
    smem = 4 * _DR_STAGES * _DR_BK * 2 * _DR_TILE
    return 0, dict(tiles=tiles, splits=splits, chunk=chunk,
                   blocks=tiles * splits, smem_bytes=smem)


def lstm_bwd_dr_source_plan(t, n, hsz, sms, device=None):
    """The dR pass's (code, plan) asked of the compiled source; with
    ``sms`` <= 0 for this card's SM count."""
    out = torch.zeros(len(DR_PLAN_FIELDS), dtype=torch.int32)
    device = torch.device("cuda") if device is None else device
    rc = build.query("lstm_seq_bwd", "lstm_seq_bwd_dr_plan",
                     "lstm_seq_bwd dR plan", [t, n, hsz, sms, out], device)
    return rc, (dict(zip(DR_PLAN_FIELDS, (int(x) for x in out)))
                if rc == 0 else None)


# ---------------------------------------------------------------------------
# kernel bindings
# ---------------------------------------------------------------------------

def _launch(name, entry, what, tensors, t, n, hsz, device):
    """``entry(*tensors, T, N, H, stream)`` of ``csrc/<name>.cu``. The
    route was chosen by shape (``_route().takes_persistent``, the
    source's own checks), so a persistent kernel that still finds no room
    (-1) or no cluster the card holds (-2) is a fault, and raises."""
    build.call(name, entry, what, [*tensors, t, n, hsz], device)


def _check_shapes(what, xw, r, h0, c0):
    if xw.dim() != 3 or min(xw.shape) < 1:
        raise ValueError(f"xw must be [T>=1, N>=1, 4H>=4], got "
                         f"{tuple(xw.shape)}")
    _, n, four_h = xw.shape
    hsz = r.shape[0]
    if four_h != 4 * hsz or tuple(r.shape) != (hsz, 4 * hsz):
        raise ValueError(f"xw {tuple(xw.shape)} and R {tuple(r.shape)} do "
                         f"not agree on H")
    for name, a in (("h0", h0), ("c0", c0)):
        if tuple(a.shape) != (n, hsz):
            raise ValueError(f"{name} must be [{n}, {hsz}], got "
                             f"{tuple(a.shape)}")
    for a in (r, h0, c0):
        if a.device != xw.device:
            raise ValueError(f"{what} inputs lie on different devices")


def _cuda_f32(what, tensors):
    """The tensors, contiguous, after checking they are float32 on CUDA."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    for a in tensors:
        if a.dtype != torch.float32:
            raise NotImplementedError(
                f"the {what} kernel takes float32, got {a.dtype}")
    return [a.contiguous() for a in tensors]


def lstm_seq_infer(xw, r, h0, c0):
    """Full LSTM recurrence without residuals: (hs [T,N,H], hT, cT).

    The inference route: its outputs carry no graph on the GPU, so it
    refuses inputs that require grad while grad mode is on (``lstm_seq``
    is the differentiable route)."""
    _check_shapes("lstm_seq_infer", xw, r, h0, c0)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (xw, r, h0, c0)):
        raise RuntimeError(
            "lstm_seq_infer has no gradient: call lstm_seq for inputs that "
            "require grad, or run under torch.no_grad()/inference_mode()")
    if xw.device.type == "cpu":
        return lstm_seq_infer_reference(xw, r, h0, c0)
    xw, r, h0, c0 = _cuda_f32("lstm_seq_infer", [xw, r, h0, c0])
    t, n, four_h = xw.shape
    hsz = four_h // 4
    if not _route().takes_persistent("lstm_infer", n, hsz, xw.device):
        return _route().lstm_step_infer(xw, r, h0, c0)
    hs = xw.new_empty((t, n, hsz))
    hT = xw.new_empty((n, hsz))
    cT = xw.new_empty((n, hsz))
    _launch("lstm_seq_infer", "lstm_seq_infer_f32", "lstm_seq_infer",
            [xw, r, h0, c0, hs, hT, cT], t, n, hsz, xw.device)
    _count(lstm_seq_infer)
    return hs, hT, cT


def lstm_seq_fwd(xw, r, h0, c0):
    """The training forward: (hs [T,N,H], gates [T,N,4H], cs [T,N,H])."""
    _check_shapes("lstm_seq_fwd", xw, r, h0, c0)
    if xw.device.type == "cpu":
        return lstm_seq_fwd_reference(xw, r, h0, c0)
    xw, r, h0, c0 = _cuda_f32("lstm_seq_fwd", [xw, r, h0, c0])
    t, n, four_h = xw.shape
    hsz = four_h // 4
    if not _route().takes_persistent("lstm_fwd", n, hsz, xw.device):
        return _route().lstm_step_fwd(xw, r, h0, c0)
    hs = xw.new_empty((t, n, hsz))
    gates = xw.new_empty((t, n, four_h))
    cs = xw.new_empty((t, n, hsz))
    _launch("lstm_seq_infer", "lstm_seq_fwd_f32", "lstm_seq_fwd",
            [xw, r, h0, c0, hs, gates, cs], t, n, hsz, xw.device)
    _count(lstm_seq_fwd)
    return hs, gates, cs


def lstm_seq_bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0):
    """The backward through time: (dxw [T,N,4H], dR [H,4H], dh0, dc0)."""
    t, n, hsz = dhs.shape
    want = {"dhT": (n, hsz), "dcT": (n, hsz), "gates": (t, n, 4 * hsz),
            "cs": (t, n, hsz), "hs": (t, n, hsz), "r": (hsz, 4 * hsz),
            "h0": (n, hsz), "c0": (n, hsz)}
    args = dict(dhT=dhT, dcT=dcT, gates=gates, cs=cs, hs=hs, r=r, h0=h0,
                c0=c0)
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"lstm_seq_bwd: {name} must be {list(shape)}, "
                             f"got {list(args[name].shape)}")
        if args[name].device != dhs.device:
            raise ValueError("lstm_seq_bwd inputs lie on different devices")
    if dhs.device.type == "cpu":
        return lstm_seq_bwd_reference(dhs, dhT, dcT, gates, cs, hs, r, h0,
                                      c0)
    ins = _cuda_f32("lstm_seq_bwd",
                    [dhs, dhT, dcT, gates, cs, hs, r, h0, c0])
    if not _route().takes_persistent("lstm_bwd", n, hsz, dhs.device):
        return _route().lstm_step_bwd(*ins)
    dxw = gates.new_empty((t, n, 4 * hsz))
    dr = gates.new_empty((hsz, 4 * hsz))
    dh0 = gates.new_empty((n, hsz))
    dc0 = gates.new_empty((n, hsz))
    _launch("lstm_seq_bwd", "lstm_seq_bwd_f32", "lstm_seq_bwd",
            ins + [dxw, dr, dh0, dc0], t, n, hsz, dhs.device)
    _count(lstm_seq_bwd)
    return dxw, dr, dh0, dc0


for _fn in (lstm_seq_infer, lstm_seq_fwd, lstm_seq_bwd):
    _fn.launches = 0


class _LstmSeq(torch.autograd.Function):
    """(xw, R, h0, c0) -> (hs, hT, cT), with the gradient of all four."""

    @staticmethod
    def forward(ctx, xw, r, h0, c0):
        hs, gates, cs = lstm_seq_fwd(xw, r, h0, c0)
        ctx.save_for_backward(gates, cs, hs, r, h0, c0)
        # copies, so that no output is a view of another
        return hs, hs[-1].clone(), cs[-1].clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dhs, dhT, dcT):
        gates, cs, hs, r, h0, c0 = ctx.saved_tensors
        return lstm_seq_bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0)


def lstm_seq(xw, r, h0, c0):
    """Full LSTM recurrence (hs [T,N,H], hT, cT) that autograd can
    differentiate: ``lstm_seq_fwd`` forward, ``lstm_seq_bwd`` backward (on
    the CPU their plain versions)."""
    _check_shapes("lstm_seq", xw, r, h0, c0)
    return _LstmSeq.apply(xw, r, h0, c0)
