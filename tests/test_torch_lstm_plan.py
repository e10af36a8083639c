"""The LSTM kernels' launch plans (csrc/lstm_seq_infer.cu, rows 1-2, and
csrc/lstm_seq_bwd.cu, row 3), through their Python mirrors in
kernels/lstm.py.

- The forward's and the sweep's plans (``lstm_seq_plan``,
  ``lstm_seq_bwd_plan``): every output cell finalised by one block, the
  cluster ranks passing on h's H units (forward) or dz's 4H columns
  (sweep) once each, shared memory within 227 KiB, the rows spread over the
  clusters the card holds, and every (N, H) that the kernels before the
  cluster redesign took (their launch rules, as chip_smoke.py copies
  them) still taken; past H = 300 the sweep takes no other batch.
- The dR pass's plan (``lstm_bwd_dr_plan``): the splits' chunks cover the
  T*N rows once, and the blocks fill the card's slots at least as evenly as
  one block a tile would.

The cuda-marked tests skip without a GPU; on the card they hold the
sources' plans against the mirrors, the route query against the old
domain, and the kernels against the plain versions at ragged shapes with
repeated bits.
"""

import numpy as np
import pytest
import torch

from chip_smoke import old_lstm_fits
from deeplearning4j_tpu_torch.kernels import lstm

H100_SMS = 132
# clusters of 1, 2, 4, 8, 16 blocks an H100 80GB HBM3 holds at once at one
# block an SM (lstm_seq_clusters on the card)
H100_CAPS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
# other cards: no cluster of 16, few clusters, one SM's worth
OTHER_CAPS = [{1: 132, 2: 66, 4: 32, 8: 16, 16: 0},
              {1: 16, 2: 8, 4: 4, 8: 2, 16: 1},
              {1: 1, 2: 1, 4: 1, 8: 1, 16: 1}]
# (N, H): serving's and training's batches, generation, the large batch, a
# ragged batch and widths, the top of each old domain, narrow widths
PLAN_SHAPES = [(32, 256), (1, 256), (8, 256), (1024, 256), (3, 200),
               (130, 256), (33, 200), (16, 431), (18, 431), (32, 300),
               (8, 423), (40, 389), (1024, 389), (70, 37), (5, 1),
               (64, 13), (17, 340)]
KINDS = ["forward", "sweep"]
# the sweep: PLAN_SHAPES but those past its batches at H > 300 (the step
# route's), and the largest batch it takes in each band of widths past 300
SWEEP_SHAPES = [s for s in PLAN_SHAPES
                if s not in ((16, 431), (18, 431), (1024, 389))] + [
    (104, 320), (96, 352), (88, 360), (44, 384), (40, 400), (20, 416),
    (18, 423)]
PLAN_CASES = ([("forward", n, h) for n, h in PLAN_SHAPES]
              + [("sweep", n, h) for n, h in SWEEP_SHAPES])
DOMAIN_N = (1, 3, 8, 16, 17, 18, 20, 32, 33, 40, 41, 64, 130, 1024)
DOMAIN_H = (1, 4, 13, 37, 64, 200, 256, 300, 301, 336, 337, 340, 389, 390,
            412, 423, 424, 431, 432)
# (T, N, H): the smoke's LSTM shapes, ragged ones, the step route's widths
DR_SHAPES = [(100, 32, 256), (100, 1, 256), (100, 1024, 256), (1, 8, 256),
             (13, 3, 200), (7, 5, 37), (100, 32, 512), (100, 1, 512),
             (100, 64, 1024), (3, 17, 431), (1, 1, 1)]


def _plan(kind, n, h, caps):
    return (lstm.lstm_seq_plan if kind == "forward" else
            lstm.lstm_seq_bwd_plan)(n, h, caps)


def _old_fits(n, h, bwd, sms=H100_SMS):
    """The launch rules of the kernels before the cluster redesign
    (``chip_smoke.old_lstm_fits``), on an H100's 132 SMs by default."""
    return old_lstm_fits(n, h, bwd, sms)


# -- the forward's and the sweep's plans ---------------------------------------

@pytest.mark.parametrize("kind,n,h", PLAN_CASES)
def test_plan_finalises_every_cell_once(kind, n, h):
    rc, plan = _plan(kind, n, h, H100_CAPS)
    assert rc == 0
    cells = lstm.lstm_seq_cells(plan, n, h)
    assert torch.equal(torch.bincount(cells, minlength=n * h),
                       torch.ones(n * h, dtype=torch.long))


@pytest.mark.parametrize("kind,n,h", PLAN_CASES)
def test_plan_ranks_cover_h_or_4h(kind, n, h):
    """Each step every rank passes its units' h (forward: H in all) or
    their four dz columns (sweep: 4H in all) to the others: together the
    ranks cover each column once."""
    _, plan = _plan(kind, n, h, H100_CAPS)
    bwd = kind == "sweep"
    cols = lstm.lstm_seq_rank_columns(plan, h, bwd)
    assert len(cols) == plan["cluster"]
    width = 4 * h if bwd else h
    assert torch.equal(torch.sort(torch.cat(cols)).values,
                       torch.arange(width))
    assert plan["units"] % 4 == 0
    assert plan["k_pad"] == plan["cluster"] * plan["units"] >= h
    # a rank past H only in clusters of 16 where no cluster of 8 fits
    # (narrow H takes fewer blocks)
    if (plan["cluster"] - 1) * plan["units"] >= h:
        assert plan["cluster"] == 16
        assert lstm._layout(bwd, 8, -(-h // 32) * 4, 1) is None


@pytest.mark.parametrize("caps", [H100_CAPS] + OTHER_CAPS)
@pytest.mark.parametrize("kind,n,h", PLAN_CASES)
def test_plan_fits_shared_memory_and_spreads_the_rows(kind, n, h, caps):
    rc, p = _plan(kind, n, h, caps)
    if kind == "sweep" and not lstm.sweep_takes(n, h, caps[1]):
        assert rc == -1   # fewer SMs: fewer batches past H = 300
        return
    if caps[16] == 0 and _plan(kind, n, h, H100_CAPS)[1]["cluster"] == 16:
        assert rc == -2   # only clusters of 16 hold R's slices there
        return
    assert rc == 0
    bwd = kind == "sweep"
    u, rows, tm = p["units"], p["rows"], p["rows_per_thread"]
    rcp = p["row_threads"] * tm
    ncol = u if bwd else 4 * u
    kp = p["splits"] * p["k_per_split"]
    # R's slice, the double-buffered h (dz), the splits' partial sums, the
    # staged outputs, two mbarriers
    assert p["smem_bytes"] == 4 * (kp * ncol + 2 * rcp * (kp + 4)
                                   + p["splits"] * rcp * ncol
                                   + rcp * (4 * u if bwd else u) + 4)
    assert p["smem_bytes"] <= 227 * 1024
    # the reduction (k_pad forward, 4 k_pad sweep) split into ranges of a
    # multiple of 4, none idle
    kd = 4 * p["k_pad"] if bwd else p["k_pad"]
    assert p["k_per_split"] % 4 == 0
    assert (p["splits"] - 1) * p["k_per_split"] < kd <= kp
    assert p["splits"] <= (32 if bwd else 8)
    # threads: column quads x row slots x splits, at most 512 (256 at 8
    # rows a thread); each finalises at most 2 (sweep) or 4 cells
    assert p["threads"] == ncol // 4 * p["row_threads"] * p["splits"]
    assert p["threads"] <= (256 if tm == 8 else 512)
    assert rows * u <= (2 if bwd else 4) * p["threads"]
    assert tm == (8 if rows >= 8 else 4 if rows >= 3 else rows)
    assert rcp >= rows > rcp - tm
    # a block keeps 128 threads, or as many as one row's layout has
    floor = min(128, lstm._layout(bwd, p["cluster"], u, 1)["threads"])
    assert p["threads"] >= floor

    def fits(r):
        plan = lstm._layout(bwd, p["cluster"], u, r)
        return plan is not None and plan["threads"] >= floor

    # the rows spread over the clusters the card holds, in the fewest
    # waves: no layout keeping the floor fits rows for one wave fewer
    assert p["resident"] == caps[p["cluster"]] >= 1
    assert 1 <= rows <= 64 and p["blocks"] == p["tiles"] * p["cluster"]
    assert p["tiles"] == -(-n // rows)
    waves = -(-p["tiles"] // p["resident"])
    fewest = -(-n // (waves * p["resident"]))
    assert rows == fewest or not any(fits(r) for r in range(fewest, rows))
    if waves > 1:
        need = -(-n // ((waves - 1) * p["resident"]))
        assert need > 64 or not fits(need)


def test_plans_at_the_serving_and_training_shapes():
    """(32, 256) on an H100: clusters of 8 blocks of 32 units, 3 rows a
    cluster over 11 of the 15 clusters it holds at once; the forward splits
    k 8 ways (256 threads), the sweep the 1024 columns of dz 32 ways. N =
    1: one cluster. N = 1024: the rows a cluster's shared memory allows,
    in waves."""
    _, f = lstm.lstm_seq_plan(32, 256, H100_CAPS)
    assert (f["cluster"], f["units"], f["rows"], f["tiles"], f["splits"],
            f["threads"], f["blocks"]) == (8, 32, 3, 11, 8, 256, 88)
    _, b = lstm.lstm_seq_bwd_plan(32, 256, H100_CAPS)
    assert (b["cluster"], b["units"], b["rows"], b["tiles"], b["splits"],
            b["k_per_split"], b["threads"]) == (8, 32, 3, 11, 32, 32, 256)
    for kind in KINDS:
        _, p = _plan(kind, 1, 256, H100_CAPS)
        assert (p["cluster"], p["rows"], p["tiles"]) == (8, 1, 1)
        _, p = _plan(kind, 1024, 256, H100_CAPS)
        assert p["tiles"] > p["resident"] and p["rows"] * p["tiles"] >= 1024


def test_plan_keeps_four_warps_a_block():
    """More rows a cluster leave less shared memory for the splits: the
    forward at H = 300 would hold 5 rows in 80 threads (one split), the
    sweep at H = 389 2 rows in 56. The plans take fewer rows and more
    waves instead; narrow widths keep what one row has."""
    _, f = lstm.lstm_seq_plan(64, 300, H100_CAPS)
    assert (f["rows"], f["threads"], f["tiles"]) == (3, 200, 22)
    assert lstm._layout(False, 8, 40, 5)["threads"] == 80
    _, b = lstm.lstm_seq_bwd_plan(19, 389, H100_CAPS)
    assert (b["rows"], b["threads"], b["tiles"]) == (1, 224, 19)
    assert lstm._layout(True, 16, 28, 2)["threads"] == 56
    _, f = lstm.lstm_seq_plan(64, 37, H100_CAPS)
    assert f["threads"] == 36 and f["tiles"] <= f["resident"]


def test_plan_codes():
    """-3 for an empty dimension; -1 where no slice of R fits (the step
    route's widths) or, for the sweep, past the batches it takes; -2 where
    a slice fits but the card holds no cluster of its size; widths past
    336 need clusters of 16."""
    for kind in KINDS:
        assert _plan(kind, 0, 256, H100_CAPS)[0] == -3
        assert _plan(kind, 8, 0, H100_CAPS)[0] == -3
        assert _plan(kind, 32, 512, H100_CAPS)[0] == -1
        assert _plan(kind, 64, 1024, H100_CAPS)[0] == -1
        assert _plan(kind, 1, 256, dict.fromkeys(lstm.CLUSTER_SIZES,
                                                 0))[0] == -2
        h = 431 if kind == "forward" else 423
        _, p = _plan(kind, 8, h, H100_CAPS)
        assert p["cluster"] == 16
        no16 = {**H100_CAPS, 16: 0}
        assert _plan(kind, 8, h, no16)[0] == -2
    # the forward's widest: clusters of 16 blocks of 28 units (H = 448),
    # at any batch; 32 units do not fit
    for n in (1, 19, 1024):
        assert lstm.lstm_seq_plan(n, 448, H100_CAPS)[0] == 0
    assert lstm.lstm_seq_plan(1, 449, H100_CAPS)[0] == -1
    # the sweep's: every batch to H = 300, then the batches the sweep
    # before took, to H = 423 at N <= 18
    for n, h, rc in ((1024, 300, 0), (1024, 301, -1), (104, 320, 0),
                     (105, 320, -1), (1024, 320, -1), (18, 423, 0),
                     (19, 423, -1), (1, 424, -1), (1, 448, -1)):
        assert lstm.lstm_seq_bwd_plan(n, h, H100_CAPS)[0] == rc, (n, h)


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_sweep_takes_past_300_only_what_the_old_sweep_took(sms):
    """Past H = 300 the sweep takes a batch exactly where the sweep before
    its cluster redesign took it on a card of as many SMs (the step route
    is faster elsewhere); to H = 300 every batch. The forward has no such
    rule: it takes every batch to H = 448."""
    caps = {**H100_CAPS, 1: sms}
    for h in range(296, 452, 3):
        for n in (1, 2, 14, 18, 19, 20, 21, 40, 41, 44, 45, 88, 89, 96,
                  97, 104, 105, 1024):
            rc, _ = lstm.lstm_seq_bwd_plan(n, h, caps)
            if h <= 300:
                assert rc == 0, (n, h)
            else:
                assert (rc == 0) == (_old_fits(n, h, True, sms) == 0), (n, h)
            assert (lstm.lstm_seq_plan(n, h, caps)[0] == 0) == (h <= 448)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", DOMAIN_N)
def test_plan_domain_contains_the_old_kernels(kind, n):
    for h in DOMAIN_H:
        old = _old_fits(n, h, kind == "sweep")
        rc, _ = _plan(kind, n, h, H100_CAPS)
        assert rc == 0 or old != 0, f"N={n} H={h}: the old {kind} took it"


def test_old_rules_as_copied():
    """The copied rules: the forward to H = 389 at any N and to 431 at
    N <= 18; the sweep to H = 300 at any N and to 423 at N <= 18."""
    for n in DOMAIN_N:
        assert _old_fits(n, 389, False) == 0 and _old_fits(n, 300, True) == 0
    assert _old_fits(18, 431, False) == 0 and _old_fits(19, 431, False) == -1
    assert _old_fits(1, 432, False) == -1
    assert _old_fits(18, 423, True) == 0 and _old_fits(19, 423, True) == -1
    assert _old_fits(1, 424, True) == -1
    assert _old_fits(1024, 390, False) == -1
    assert _old_fits(1024, 301, True) == -1


# -- the dR pass ---------------------------------------------------------------

@pytest.mark.parametrize("t,n,h", DR_SHAPES)
def test_dr_plan_chunks_cover_the_rows_once(t, n, h):
    rc, p = lstm.lstm_bwd_dr_plan(t, n, h, H100_SMS)
    assert rc == 0
    m = t * n
    assert p["splits"] in (1, 2, 4, 8) and p["chunk"] % 16 == 0
    assert (p["splits"] - 1) * p["chunk"] < m <= p["splits"] * p["chunk"]
    assert p["tiles"] == -(-h // 128) * -(-4 * h // 128)
    assert p["blocks"] == p["tiles"] * p["splits"]
    # six stages of 16 rows of A and B tiles
    assert p["smem_bytes"] == 4 * 6 * 16 * 256 <= 227 * 1024


@pytest.mark.parametrize("t,n,h", DR_SHAPES)
def test_dr_plan_fills_the_card_at_least_as_evenly(t, n, h):
    """Counted as waves of 2 blocks an SM times the 16-row steps a block
    sums, the plan costs no more than one block a tile."""
    _, p = lstm.lstm_bwd_dr_plan(t, n, h, H100_SMS)
    slots = 2 * H100_SMS

    def cost(splits, chunk):
        return (-(-p["tiles"] * splits // slots) * (chunk // 16)
                + (4 if splits > 1 else 0))

    assert cost(p["splits"], p["chunk"]) <= cost(1, -(-t * n // 16) * 16)


def test_dr_plan_at_the_training_and_step_route_shapes():
    """(100, 32, 256): 16 tiles alone would leave 248 of 264 slots idle;
    split in 8 (a cluster of 8) they make 128 blocks of 400 rows. The step
    route's (100, 32, 512): 64 tiles in 4. (100, 64, 1024): 256 tiles
    already fill a wave, so M stays whole."""
    expect = {(100, 32, 256): (16, 8, 400, 128),
              (100, 32, 512): (64, 4, 800, 256),
              (100, 64, 1024): (256, 1, 6400, 256)}
    for (t, n, h), want in expect.items():
        _, p = lstm.lstm_bwd_dr_plan(t, n, h, H100_SMS)
        assert (p["tiles"], p["splits"], p["chunk"], p["blocks"]) == want
    assert lstm.lstm_bwd_dr_plan(0, 32, 256, H100_SMS)[0] == -3
    assert lstm.lstm_bwd_dr_plan(1, 1, 1, 0)[0] == -3


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [None, H100_CAPS] + OTHER_CAPS)
@pytest.mark.parametrize("n,h", PLAN_SHAPES)
def test_cuda_plans_equal_source(cuda, n, h, caps):
    """The sources' plans against the mirrors, for given cluster counts and
    (None) for this card's."""
    fwd_caps = lstm.lstm_seq_clusters(False, cuda) if caps is None else caps
    bwd_caps = lstm.lstm_seq_clusters(True, cuda) if caps is None else caps
    want = lstm.lstm_seq_plan(n, h, fwd_caps)
    for save in (0, 1):
        assert lstm.lstm_seq_source_plan(n, h, save, caps, cuda) == want
    assert lstm.lstm_seq_bwd_source_plan(n, h, caps, cuda) == \
        lstm.lstm_seq_bwd_plan(n, h, bwd_caps)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,h", DR_SHAPES)
def test_cuda_dr_plan_equals_source(cuda, t, n, h):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert lstm.lstm_bwd_dr_source_plan(t, n, h, 0, cuda) == \
        lstm.lstm_bwd_dr_plan(t, n, h, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("n", DOMAIN_N)
def test_cuda_fits_contains_the_old_domain(cuda, n):
    """Every (N, H) that the old rules take launches on this card (an H100:
    the old rules are those of its 132 SMs)."""
    from deeplearning4j_tpu_torch.kernels import build
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for h in DOMAIN_H:
        for save in (0, 1):
            if _old_fits(n, h, False, sms) == 0:
                assert build.query("lstm_seq_infer", "lstm_seq_fits", "fits",
                                   [n, h, save], cuda) == 0, (n, h)
        if _old_fits(n, h, True, sms) == 0:
            assert build.query("lstm_seq_bwd", "lstm_seq_bwd_fits", "fits",
                               [n, h], cuda) == 0, (n, h)


@pytest.mark.cuda
@pytest.mark.parametrize("n", DOMAIN_N)
def test_cuda_sweep_refuses_past_the_old_domain(cuda, n):
    """Past H = 300 the sweep refuses (-1: the step route's) every batch
    the old sweep did not take on this card."""
    from deeplearning4j_tpu_torch.kernels import build
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for h in DOMAIN_H:
        if h > 300 and _old_fits(n, h, True, sms) != 0:
            assert build.query("lstm_seq_bwd", "lstm_seq_bwd_fits", "fits",
                               [n, h], cuda) == -1, (n, h)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,h", [(5, 33, 200), (4, 70, 37), (3, 5, 1),
                                   (3, 130, 256), (6, 16, 431),
                                   (6, 8, 423)])
def test_cuda_ragged_shapes_match_plain_with_repeated_bits(cuda, t, n, h):
    rng = np.random.default_rng(7)
    arrays = [(rng.normal(size=s) * sc).astype(np.float32) for s, sc in (
        ((t, n, 4 * h), 0.3), ((h, 4 * h), 0.1), ((n, h), 0.2),
        ((n, h), 0.2))]
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((t, n, h), (n, h), (n, h))]
    xw, r, h0, c0 = (torch.from_numpy(a).to(cuda) for a in arrays)
    dhs, dhT, dcT = (torch.from_numpy(c).to(cuda) for c in cts)
    with torch.no_grad():
        infer = [lstm.lstm_seq_infer(xw, r, h0, c0) for _ in range(2)]
    fwd = [lstm.lstm_seq_fwd(xw, r, h0, c0) for _ in range(2)]
    hs, gates, cs = fwd[0]
    bwd = [lstm.lstm_seq_bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0)
           for _ in range(2)]
    torch.cuda.synchronize()
    for got, want in ((infer[0], lstm.lstm_seq_infer_reference(xw, r, h0,
                                                                c0)),
                      (fwd[0], lstm.lstm_seq_fwd_reference(xw, r, h0, c0))):
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) < 1e-4
    want = lstm.lstm_seq_bwd_reference(dhs, dhT, dcT, gates, cs, hs, r, h0,
                                       c0)
    # relative to each output's largest element, as chip_smoke.py holds it
    for g, w in zip(bwd[0], want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    for runs in (infer, fwd, bwd):
        assert all(torch.equal(a, b) for a, b in zip(*runs))
