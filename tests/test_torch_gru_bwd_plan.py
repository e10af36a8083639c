"""The GRU backward's launch plans (csrc/gru_seq_bwd.cu), through their
Python mirrors in kernels/gru.py.

- The reverse sweep's plan (``gru_seq_bwd_plan``): every output cell
  finalised by one block, the cluster ranks covering j (3H), shared memory
  within 227 KiB, a lane's sums within 64, the grid following the SM
  count, and every (N, H) that the sweep before its redesign took (its
  launch rules copied below) still taken.
- The dR pass's plan (``gru_bwd_dr_plan``): the splits' chunks cover the
  T*N rows once, and the blocks fill the card's slots at least as evenly
  as one block a tile would.

The dR pass's summation order against the JAX package is in
test_torch_gru_kernel.py. The cuda-marked tests here skip without a GPU;
on the card they hold the source's plans against the mirrors, the kernels
against the plain version at ragged shapes (bits repeated), and the
route query against the old domain.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import gru

H100_SMS = 132
# (N, H, SMs): the training and serving shapes, ragged batches and widths,
# the widths past 1056 that take 20 units a block, the widest the sweep
# before took (1205), other SM counts
PLAN_SHAPES = [(64, 1024, 132), (32, 1024, 132), (1, 1024, 132),
               (48, 1024, 132), (96, 1024, 132), (16, 1024, 132),
               (33, 1000, 132), (130, 37, 132), (17, 1100, 132),
               (256, 1205, 132), (2, 1112, 132), (3, 1, 132), (5, 37, 132),
               (13, 200, 132), (1024, 200, 264), (17, 512, 66),
               (3, 200, 16)]
DOMAIN_N = (1, 3, 16, 17, 33, 64, 65, 130, 256)
DOMAIN_H = (1, 4, 37, 200, 512, 1000, 1024, 1056, 1100, 1152, 1205)
# (T, N, H): the smoke's GRU shapes, ragged ones, the step route's width
DR_SHAPES = [(100, 64, 1024), (100, 32, 1024), (100, 1, 1024),
             (1, 1, 1024), (13, 3, 200), (7, 5, 37), (100, 64, 2048),
             (100, 1, 2048), (5, 33, 1000), (3, 17, 1100), (1, 1, 1)]


def _old_sweep_fits(n, h, sms=H100_SMS):
    """The launch rules of csrc/gru_seq_bwd.cu's sweep before its redesign:
    8 units a block (256 threads), R's [8, 3H] slice in shared memory
    (96 H bytes), ceil(H/8) co-resident blocks, whatever N (the row
    groups adapt). Blocks an SM by shared memory (233472 bytes an SM, 1
    KiB reserved a block) and threads; registers are taken not to limit
    them, which can only widen the domain. 0, -1 or -2 as the source
    returned, -3 for an empty dimension."""
    if min(n, h) < 1:
        return -3
    smem = 96 * h
    if smem > 232448:
        return -1
    per_sm = min(2048 // 256, 233472 // (smem + 1024))
    return 0 if per_sm * sms >= -(-h // 8) else -2


# -- the sweep ----------------------------------------------------------------

@pytest.mark.parametrize("n,h,sms", PLAN_SHAPES)
def test_sweep_plan_finalises_every_cell_once(n, h, sms):
    rc, plan = gru.gru_seq_bwd_plan(n, h, sms)
    assert rc == 0
    cells = gru.gru_seq_bwd_cells(plan, n, h)
    assert torch.equal(torch.bincount(cells, minlength=n * h),
                       torch.ones(n * h, dtype=torch.long))


@pytest.mark.parametrize("n,h,sms", PLAN_SHAPES)
def test_sweep_plan_ranks_cover_j(n, h, sms):
    _, plan = gru.gru_seq_bwd_plan(n, h, sms)
    ranges = gru.gru_seq_bwd_j_ranges(plan, h)
    assert len(ranges) == plan["cluster"] <= 2
    assert ranges[0][0] == 0 and ranges[-1][1] == 3 * h
    for (_, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    assert all(e > b for b, e in ranges)   # no idle rank
    assert plan["j_per_rank"] % 4 == 0


@pytest.mark.parametrize("n,h,sms", PLAN_SHAPES)
def test_sweep_plan_fits_shared_memory_and_the_card(n, h, sms):
    _, p = gru.gru_seq_bwd_plan(n, h, sms)
    rw, units = p["rows_per_warp"], p["units"]
    # R's slice [units][j_per_rank], the ranks' sums [16 warps][rw][units]
    # and their mbarrier
    assert p["smem_bytes"] == 4 * (units * p["j_per_rank"]
                                   + 16 * rw * units) + 16
    assert p["smem_bytes"] <= 227 * 1024
    assert p["blocks"] <= sms and p["threads"] == 512
    assert units in (8, 16, 20) and units % p["cluster"] == 0
    # a lane keeps rw x units sums, at most 64
    assert rw in (1, 2, 4) and rw * units <= 64
    # a row tile is 16 warps' rows; 1 row a warp up to 16 rows, 2 up to 32
    assert rw == (1 if n <= 16 else 2 if n <= 32 else rw)
    assert p["tiles"] * 16 * rw >= n > (p["tiles"] - 1) * 16 * rw
    assert p["blocks"] % (p["cluster"] * p["groups"]) == 0
    assert p["groups"] <= p["tiles"]


def test_sweep_plan_at_the_training_shape():
    """(64, 1024) on an H100: 128 blocks of 16 units in clusters of 2, so
    that each block reads half of each drz row (the kernel before read
    whole rows with 8 units a block), 4 rows a warp in one row tile."""
    _, p = gru.gru_seq_bwd_plan(64, 1024, H100_SMS)
    assert (p["units"], p["cluster"], p["blocks"], p["j_per_rank"],
            p["rows_per_warp"], p["tiles"]) == (16, 2, 128, 1536, 4, 1)
    # past H = 1056, 20 units a block, at most 2 rows a warp
    _, p = gru.gru_seq_bwd_plan(64, 1205, H100_SMS)
    assert (p["units"], p["cluster"], p["blocks"], p["rows_per_warp"],
            p["tiles"]) == (20, 2, 122, 2, 2)


def test_sweep_plan_follows_the_sm_count():
    blocks = {sms: gru.gru_seq_bwd_plan(64, 1024, sms)[1]["blocks"]
              for sms in (132, 264)}
    assert blocks == {132: 128, 264: 256}
    # fewer SMs: wider slices or no cluster, never more blocks than SMs
    for sms in (16, 33, 66, 100, 127, 131):
        rc, plan = gru.gru_seq_bwd_plan(64, 256, sms)
        assert rc == 0 and plan["blocks"] <= sms
    # too few SMs even for slices of 20 units
    assert gru.gru_seq_bwd_plan(64, 256, 8)[0] == -2
    # spare SMs take row tiles of their own
    _, plan = gru.gru_seq_bwd_plan(1024, 200, 264)   # 25 slices x 2 ranks
    assert plan["groups"] == 5 and plan["blocks"] == 250
    assert gru.gru_seq_bwd_plan(0, 8, 132)[0] == -3
    assert gru.gru_seq_bwd_plan(8, 8, 0)[0] == -3
    # the step route's width: no slice of R fits with few enough blocks
    assert gru.gru_seq_bwd_plan(64, 2048, H100_SMS)[0] in (-1, -2)


@pytest.mark.parametrize("n", DOMAIN_N)
@pytest.mark.parametrize("h", DOMAIN_H)
def test_sweep_plan_domain_contains_the_old_kernels(n, h):
    old = _old_sweep_fits(n, h)
    rc, _ = gru.gru_seq_bwd_plan(n, h, H100_SMS)
    assert rc == 0 or old != 0, f"N={n} H={h}: the old sweep took it"


def test_old_sweep_rules_as_copied():
    """The copied rules take H up to 1205 at any N (two blocks an SM by
    shared memory) and no wider."""
    assert all(_old_sweep_fits(n, 1205) == 0 for n in DOMAIN_N)
    assert _old_sweep_fits(64, 1206) == -2
    assert _old_sweep_fits(64, 2421) == -2 and _old_sweep_fits(1, 2422) == -1


# -- the dR pass --------------------------------------------------------------

@pytest.mark.parametrize("t,n,h", DR_SHAPES)
def test_dr_plan_chunks_cover_the_rows_once(t, n, h):
    rc, p = gru.gru_bwd_dr_plan(t, n, h, H100_SMS)
    assert rc == 0
    m = t * n
    assert p["splits"] in (1, 2, 4) and p["chunk"] % 16 == 0
    assert (p["splits"] - 1) * p["chunk"] < m <= p["splits"] * p["chunk"]
    assert p["tiles"] == -(-h // 128) * -(-3 * h // 128)
    assert p["blocks"] == p["tiles"] * p["splits"]
    # six stages of 16 rows of A and B tiles, and drb's partial
    assert p["smem_bytes"] == 4 * (6 * 16 * 256 + 128) <= 227 * 1024


@pytest.mark.parametrize("t,n,h", DR_SHAPES)
def test_dr_plan_fills_the_card_at_least_as_evenly(t, n, h):
    """Counted as waves of 2 blocks an SM times the 16-row steps a block
    sums, the plan costs no more than one block a tile."""
    _, p = gru.gru_bwd_dr_plan(t, n, h, H100_SMS)
    slots = 2 * H100_SMS

    def cost(splits, chunk):
        return (-(-p["tiles"] * splits // slots) * (chunk // 16)
                + (4 if splits > 1 else 0))

    assert cost(p["splits"], p["chunk"]) <= cost(1, -(-t * n // 16) * 16)


def test_dr_plan_at_the_training_and_step_route_shapes():
    """(100, 64, 1024): 192 tiles alone fill 73% of 264 slots; split in 4
    they make 768 blocks, 97% of 3 waves. (100, 64, 2048): 768 tiles
    already fill 97% of 3 waves, so M stays whole."""
    _, p = gru.gru_bwd_dr_plan(100, 64, 1024, H100_SMS)
    assert (p["tiles"], p["splits"], p["chunk"], p["blocks"]) == (
        192, 4, 1600, 768)
    _, p = gru.gru_bwd_dr_plan(100, 64, 2048, H100_SMS)
    assert (p["tiles"], p["splits"], p["chunk"]) == (768, 1, 6400)
    assert gru.gru_bwd_dr_plan(0, 64, 1024, 132)[0] == -3
    assert gru.gru_bwd_dr_plan(1, 1, 1, 0)[0] == -3


def test_dr_model_sums_the_chunks_in_split_order():
    """The CPU model of the dR pass adds each chunk's product to the sum of
    the chunks before it: in float64, where the order costs nothing, it
    equals hprev^T drz, and each split's rows are its own."""
    rng = np.random.default_rng(3)
    t, n, h = 9, 7, 5
    hs, h0, drz = (torch.from_numpy(rng.normal(size=s))
                   for s in ((t, n, h), (n, h), (t, n, 3 * h)))
    plan = dict(splits=4, chunk=16)
    dr, drb = gru.gru_bwd_dr_model(hs, h0, drz, plan)
    hprev = torch.cat([h0[None], hs[:-1]]).reshape(-1, h)
    torch.testing.assert_close(dr, hprev.T @ drz.reshape(-1, 3 * h))
    torch.testing.assert_close(drb, drz.reshape(-1, 3 * h).sum(0))
    # the last split's chunk holds rows 48 .. 62 only
    cut = drz.clone()
    cut.reshape(-1, 3 * h)[48:] = 0
    part, _ = gru.gru_bwd_dr_model(hs, h0, cut, dict(splits=3, chunk=16))
    torch.testing.assert_close(part, gru.gru_bwd_dr_model(
        hs, h0, drz, dict(splits=3, chunk=16))[0])


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bwd_inputs(t, n, h, device, seed=7):
    rng = np.random.default_rng(seed)

    def dev(*shape, scale=1.0):
        return torch.tensor((rng.normal(size=shape) * scale).astype(
            np.float32), device=device)

    xw, r = dev(t, n, 3 * h, scale=0.5), dev(h, 3 * h, scale=h ** -0.5)
    rb, h0 = dev(3 * h, scale=0.1), dev(n, h, scale=0.2)
    hs, ru, rzc, cand = gru.gru_seq_fwd_reference(xw, r, rb, h0)
    return [dev(t, n, h), dev(n, h), ru, rzc, cand, hs, r, h0]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,sms", PLAN_SHAPES)
def test_cuda_sweep_plan_equals_source(cuda, n, h, sms):
    assert gru.gru_seq_bwd_source_plan(n, h, sms, cuda) == \
        gru.gru_seq_bwd_plan(n, h, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,h", DR_SHAPES)
def test_cuda_dr_plan_equals_source(cuda, t, n, h):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert gru.gru_bwd_dr_source_plan(t, n, h, 0, cuda) == \
        gru.gru_bwd_dr_plan(t, n, h, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 96, 130])
@pytest.mark.parametrize("h", [37, 1000, 1100])
def test_cuda_ragged_backward_matches_plain_with_repeated_bits(cuda, n, h):
    from deeplearning4j_tpu_torch.kernels import rnn_step
    assert rnn_step.takes_persistent("gru_bwd", n, h, cuda)
    ins = _bwd_inputs(3, n, h, cuda)
    first, second = (gru.gru_seq_bwd(*ins) for _ in range(2))
    torch.cuda.synchronize()
    want = gru.gru_seq_bwd_reference(*ins)
    # relative to each output's largest element, as chip_smoke.py holds it
    for g, w in zip(first, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("n", DOMAIN_N)
def test_cuda_bwd_fits_contains_the_old_domain(cuda, n):
    """Every (N, H) that the old rules take launches on this card (an H100:
    the old rules are those of its 132 SMs)."""
    from deeplearning4j_tpu_torch.kernels import build
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for h in DOMAIN_H:
        if _old_sweep_fits(n, h, sms) == 0:
            assert build.query("gru_seq_bwd", "gru_seq_bwd_fits", "fits",
                               [n, h], cuda) == 0, (n, h)
