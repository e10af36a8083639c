"""The port's GRU (reset-after) kernels against the JAX package's.

- The plain versions ``gru_seq_infer_reference``, ``gru_seq_fwd_reference``
  and ``gru_seq_bwd_reference`` (what the wrappers run for CPU tensors, and
  what the CUDA kernels are held against on the card) against the JAX
  Pallas kernels in interpret mode: ``_fwd_call`` with and without
  residuals, and the backward reached through ``jax.vjp`` of ``gru_seq``
  with non-zero dhT, as tests/test_kernels.py runs them. Tolerance: 1e-5
  abs/rel on the forward, 2e-5 abs / 1e-4 rel on the gradients (float32 on
  the CPU; dR and drb sum T*N products in another order than the Pallas
  kernel's per-step dot).
- ``torch.autograd.gradcheck`` in float64 on the ``gru_seq`` Function.
- The route: ``gruLayer`` under grad never takes the gradient-less
  ``gru_seq_infer``, and ``gru_seq_infer`` refuses inputs that require
  grad.
- The forward kernel's launch plan, through its Python mirror
  (``gru.gru_seq_plan``): every output cell finalised by one block, the
  cluster ranks covering k, shared memory within 227 KiB, the grid
  following the SM count, and every (N, H) that the kernel before its
  redesign took (its rules copied below) still taken.
- The backward's dR pass in its own order of summation (the T*N rows in
  the plan's chunks, each chunk's partial formed alone, the partials added
  in split order: ``gru.gru_bwd_dr_model``) against dR and drb of the JAX
  VJP, with the plan's splits and with 2 and 4 forced. The backward's
  launch plans themselves are in test_torch_gru_bwd_plan.py.

Inputs come from a numpy seed. The CUDA kernels themselves are held against
the plain versions on the card in the cuda-marked tests here and in
chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.kernels.gru import _fwd_call, gru_seq as jax_seq
from deeplearning4j_tpu_torch.autodiff import ops
from deeplearning4j_tpu_torch.kernels import gru

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
SHAPES = [(5, 8, 128), (1, 8, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and leaves the cores
    to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(t, n, h, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(t, n, 3 * h)) * 0.3
    r = rng.normal(size=(h, 3 * h)) * 0.1
    rb = rng.normal(size=(3 * h,)) * 0.2
    h0 = rng.normal(size=(n, h)) * 0.2
    return [a.astype(dtype) for a in (xw, r, rb, h0)]


def _cotangents(t, n, h, seed):
    rng = np.random.default_rng(seed + 1000)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((t, n, h), (n, h))]


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=name)


@pytest.mark.parametrize("t,n,h", SHAPES)
def test_plain_forward_matches_pallas_residual_forward(t, n, h):
    arrays = _data(t, n, h, seed=t)
    want = _fwd_call(*map(jnp.asarray, arrays), True, save_residuals=True)
    got = gru.gru_seq_fwd_reference(*map(torch.from_numpy, arrays))
    for g, w, name in zip(got, want, ("hs", "ru", "rz_c", "cand")):
        _close(g.numpy(), w, FWD_TOL, name)


@pytest.mark.parametrize("t,n,h", SHAPES)
def test_plain_infer_matches_pallas_infer_forward(t, n, h):
    arrays = _data(t, n, h, seed=20 + t)
    want = _fwd_call(*map(jnp.asarray, arrays), True, save_residuals=False)
    got = gru.gru_seq_infer_reference(*map(torch.from_numpy, arrays))
    for g, w, name in zip(got, want, ("hs", "hT")):
        _close(g.numpy(), w, FWD_TOL, name)


@pytest.mark.parametrize("t,n,h", SHAPES)
def test_plain_backward_matches_pallas_vjp(t, n, h):
    arrays = _data(t, n, h, seed=10 * t + n)
    cts = _cotangents(t, n, h, seed=t)
    (hs, hT), vjp = jax.vjp(lambda *a: jax_seq(*a, True),
                            *map(jnp.asarray, arrays))
    want = vjp(tuple(map(jnp.asarray, cts)))
    xw, r, rb, h0 = map(torch.from_numpy, arrays)
    hs_t, ru, rzc, cand = gru.gru_seq_fwd_reference(xw, r, rb, h0)
    _close(hs_t.numpy(), hs, FWD_TOL, "hs")
    got = gru.gru_seq_bwd_reference(*map(torch.from_numpy, cts), ru, rzc,
                                    cand, hs_t, r, h0)
    for g, w, name in zip(got, want, ("dxw", "dR", "drb", "dh0")):
        _close(g.numpy(), w, GRAD_TOL, name)


def test_function_gradients_match_jax_vjp():
    t, n, h = 3, 8, 128
    arrays = _data(t, n, h, seed=4)
    cts = _cotangents(t, n, h, seed=4)
    outs, vjp = jax.vjp(lambda *a: jax_seq(*a, True),
                        *map(jnp.asarray, arrays))
    want = vjp(tuple(map(jnp.asarray, cts)))
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    got_outs = gru.gru_seq(*ins)
    assert "_GruSeq" in type(got_outs[0].grad_fn).__name__
    for g, w in zip(got_outs, outs):
        _close(g.detach().numpy(), w, FWD_TOL)
    got = torch.autograd.grad(got_outs, ins,
                              [torch.from_numpy(c) for c in cts])
    for g, w, name in zip(got, want, ("dxw", "dR", "drb", "dh0")):
        _close(g.numpy(), w, GRAD_TOL, name)


def test_gradcheck_float64():
    ins = [torch.tensor(a, requires_grad=True)
           for a in _data(3, 2, 3, seed=8, dtype=np.float64)]
    assert torch.autograd.gradcheck(gru.gru_seq, ins, eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    arrays = [torch.from_numpy(a) for a in _data(4, 3, 20, seed=2)]
    cts = [torch.from_numpy(c) for c in _cotangents(4, 3, 20, seed=2)]
    fns = (gru.gru_seq_infer, gru.gru_seq_fwd, gru.gru_seq_bwd)
    before = [f.launches for f in fns]
    for g, w in zip(gru.gru_seq_infer(*arrays),
                    gru.gru_seq_infer_reference(*arrays)):
        assert torch.equal(g, w)
    fwd = gru.gru_seq_fwd(*arrays)
    for g, w in zip(fwd, gru.gru_seq_fwd_reference(*arrays)):
        assert torch.equal(g, w)
    hs, ru, rzc, cand = fwd
    _, r, _, h0 = arrays
    bwd = gru.gru_seq_bwd(*cts, ru, rzc, cand, hs, r, h0)
    for g, w in zip(bwd, gru.gru_seq_bwd_reference(*cts, ru, rzc, cand, hs,
                                                   r, h0)):
        assert torch.equal(g, w)
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("bad", ["dhT", "ru", "cand", "r"])
def test_backward_rejects_mismatched_shapes(bad):
    xw, r, rb, h0 = (torch.from_numpy(a) for a in _data(3, 4, 8))
    hs, ru, rzc, cand = gru.gru_seq_fwd(xw, r, rb, h0)
    dhs, dhT = (torch.from_numpy(c) for c in _cotangents(3, 4, 8, 0))
    if bad == "dhT":
        dhT = dhT[:2]
    elif bad == "ru":
        ru = ru[:, :, :8]
    elif bad == "cand":
        cand = cand[:2]
    else:
        r = r[:4]
    with pytest.raises(ValueError, match=bad):
        gru.gru_seq_bwd(dhs, dhT, ru, rzc, cand, hs, r, h0)


@pytest.mark.parametrize("bad", ["xw", "rb", "h0"])
def test_forward_rejects_mismatched_shapes(bad):
    xw, r, rb, h0 = (torch.from_numpy(a) for a in _data(3, 4, 8))
    if bad == "xw":
        xw = xw[:, :, :20]
    elif bad == "rb":
        rb = rb[:8]
    else:
        h0 = h0[:2]
    for fn in (gru.gru_seq_infer, gru.gru_seq_fwd, gru.gru_seq):
        with pytest.raises(ValueError):
            fn(xw, r, rb, h0)


# -- the backward's dR pass: its order of summation -----------------------------

DR_MODEL_SHAPES = [(7, 5, 37), (13, 3, 200)]


@functools.lru_cache(maxsize=None)
def _dr_case(t, n, h):
    """dR and drb of the JAX package's VJP (interpret mode), and the plain
    sweep's hs, h0 and drz (the candidate column of dxw times r), at one
    shape from a numpy seed."""
    arrays = _data(t, n, h, seed=30 + t)
    cts = _cotangents(t, n, h, seed=t)
    _, vjp = jax.vjp(lambda *a: jax_seq(*a, True), *map(jnp.asarray, arrays))
    _, want_dr, want_drb, _ = vjp(tuple(map(jnp.asarray, cts)))
    xw, r, rb, h0 = map(torch.from_numpy, arrays)
    hs, ru, rzc, cand = gru.gru_seq_fwd_reference(xw, r, rb, h0)
    dxw, *_ = gru.gru_seq_bwd_reference(*map(torch.from_numpy, cts), ru, rzc,
                                        cand, hs, r, h0)
    drz = torch.cat([dxw[..., :2 * h], dxw[..., 2 * h:] * ru[..., :h]], -1)
    return np.asarray(want_dr), np.asarray(want_drb), hs, h0, drz


@pytest.mark.parametrize("splits", [None, 2, 4])
@pytest.mark.parametrize("t,n,h", DR_MODEL_SHAPES)
def test_dr_pass_summation_order_matches_pallas_vjp(t, n, h, splits):
    want_dr, want_drb, hs, h0, drz = _dr_case(t, n, h)
    rc, plan = gru.gru_bwd_dr_plan(t, n, h, H100_SMS)
    assert rc == 0
    if splits is not None:   # chunks of 16 rows, as the plan rounds them
        plan = dict(plan, splits=splits,
                    chunk=-(-t * n // (16 * splits)) * 16)
    assert plan["splits"] * plan["chunk"] >= t * n
    got_dr, got_drb = gru.gru_bwd_dr_model(hs, h0, drz, plan)
    _close(got_dr.numpy(), want_dr, GRAD_TOL, "dR")
    _close(got_drb.numpy(), want_drb, GRAD_TOL, "drb")


# -- the route ----------------------------------------------------------------

def _layer_inputs(requires_grad, n=3, i=5, t=4, h=12):
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=s).astype(np.float32) * 0.3
              for s in ((n, i, t), (i, 3 * h), (h, 3 * h), (6 * h,))]
    return [torch.tensor(a, requires_grad=requires_grad) for a in arrays]


def test_infer_route_refuses_inputs_that_require_grad():
    xw, r, rb, h0 = (torch.tensor(a, requires_grad=True)
                     for a in _data(2, 3, 8))
    with pytest.raises(RuntimeError, match="no gradient"):
        gru.gru_seq_infer(xw, r, rb, h0)
    with torch.no_grad():   # no graph is asked for: the inference route
        gru.gru_seq_infer(xw, r, rb, h0)


def test_gru_layer_under_grad_never_takes_the_infer_route(monkeypatch):
    calls = []

    def infer_spy(*a):
        calls.append("infer")
        return gru.gru_seq_infer(*a)

    monkeypatch.setattr(ops, "gru_seq_infer", infer_spy)
    x, w, r, b = _layer_inputs(requires_grad=True)
    out, hT = ops.gruLayer(x, w, r, b)
    assert calls == []
    assert "_GruSeq" in type(hT.grad_fn).__name__
    grads = torch.autograd.grad(out.sum() + hT.sum(), [x, w, r, b])
    assert all(bool(torch.isfinite(g).all()) and g.abs().sum() > 0
               for g in grads)
    # only the input of a frozen layer needs grad: still the autograd route
    xg = _layer_inputs(requires_grad=False)
    xg[0].requires_grad_(True)
    assert "_GruSeq" in type(ops.gruLayer(*xg)[1].grad_fn).__name__
    assert calls == []
    # inference: no grad mode, or nothing requires grad
    with torch.inference_mode():
        ops.gruLayer(x, w, r, b)
    with torch.no_grad():
        ops.gruLayer(x, w, r, b)
    ops.gruLayer(*_layer_inputs(requires_grad=False))
    assert calls == ["infer"] * 3


def test_gru_layer_takes_the_kernel_route_only_for_reset_after_tanh_f32(
        monkeypatch):
    calls = []
    for name in ("gru_seq", "gru_seq_infer"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=real, _n=name: (
            calls.append(_n), _f(*a))[1])
    x, w, r, b = _layer_inputs(requires_grad=False)
    ops.gruLayer(x, w, r, b)                       # the kernel route
    ops.gruLayer(x, w, r, b[:36])                  # no recurrent bias: rb=0
    ops.gruLayer(x, w, r, b[:36], resetAfter=False)
    ops.gruLayer(x, w, r, b, activation="relu")
    ops.gruLayer(*(a.double() for a in (x, w, r, b)))
    assert calls == ["gru_seq_infer"] * 2


# -- the forward kernel's launch plan -----------------------------------------

PLAN_SHAPES = [(64, 1024, 132), (32, 1024, 132), (1, 1024, 132),
               (1, 1157, 132), (2, 1112, 132), (1024, 1056, 132),
               (130, 200, 132), (1024, 37, 132), (33, 1000, 132),
               (65, 1056, 132), (17, 512, 66), (3, 200, 16), (5, 1, 132),
               (1024, 200, 264)]
DOMAIN_N = (1, 3, 16, 17, 33, 64, 65, 130, 1024)
DOMAIN_H = (1, 37, 200, 512, 1000, 1024, 1056, 1112, 1157)
H100_SMS = 132


def _old_kernel_fits(n, h, sms=H100_SMS):
    """The launch rules of csrc/gru_seq.cu before its redesign: 8 units a
    block (256 threads), R's [24, H] slice plus ROWS rows of h in shared
    memory (ROWS the smallest power of two covering N, at most 16, halved
    while it does not fit), ceil(H/8) co-resident blocks. Blocks an SM by
    shared memory (233472 bytes an SM, 1 KiB reserved a block) and threads;
    registers are taken not to limit them, which can only widen the
    domain. 0, -1 or -2 as the source returned."""
    optin, per_sm_bytes = 232448, 233472

    def smem(rows):
        return (3 * 8 * h + rows * h) * 4

    rows = 1
    while rows < n and rows < 16:
        rows *= 2
    while rows > 1 and smem(rows) > optin:
        rows //= 2
    if smem(rows) > optin:
        return -1
    per_sm = min(8, per_sm_bytes // (smem(rows) + 1024))
    return 0 if per_sm * sms >= -(-h // 8) else -2


@pytest.mark.parametrize("n,h,sms", PLAN_SHAPES)
def test_plan_finalises_every_cell_once(n, h, sms):
    rc, plan = gru.gru_seq_plan(n, h, sms)
    assert rc == 0
    cells = gru.gru_seq_cells(plan, n, h)
    assert torch.equal(torch.bincount(cells, minlength=n * h),
                       torch.ones(n * h, dtype=torch.long))


@pytest.mark.parametrize("n,h,sms", PLAN_SHAPES)
def test_plan_ranks_cover_k(n, h, sms):
    _, plan = gru.gru_seq_plan(n, h, sms)
    ranges = gru.gru_seq_k_ranges(plan, h)
    assert len(ranges) == plan["cluster"]
    assert ranges[0][0] == 0 and ranges[-1][1] == h
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    assert all(e > b for b, e in ranges)   # no idle rank
    assert plan["k_per_rank"] % 4 == 0


@pytest.mark.parametrize("n,h,sms", PLAN_SHAPES)
def test_plan_fits_shared_memory_and_the_card(n, h, sms):
    _, p = gru.gru_seq_plan(n, h, sms)
    rtp = p["row_threads"] * p["rows_per_thread"]
    cols = 3 * p["units"]
    ring = max(p["stages"] * p["row_threads"] * (p["rows_per_thread"] * 64
                                                 + 4),
               p["splits"] * rtp * cols)
    assert p["smem_bytes"] == 4 * (p["k_per_rank"] * cols + ring
                                   + p["cluster"] * 3 * p["share"]) + 16
    assert p["smem_bytes"] <= 227 * 1024
    assert p["blocks"] <= sms and p["threads"] <= 384
    assert p["threads"] == (p["row_threads"] * p["col_threads"]
                            * p["splits"])
    assert rtp >= p["rows"] and p["rows"] <= 64
    assert p["tiles"] * p["rows"] >= n > (p["tiles"] - 1) * p["rows"]
    chunks = -(-p["k_per_rank"] // 64)
    assert p["stages"] == chunks + 1 or 2 <= p["stages"] <= min(chunks, 9)
    assert p["share"] % 4 == 0 and p["share"] * p["cluster"] >= (
        p["rows"] * p["units"])
    assert p["blocks"] % (p["cluster"] * p["groups"]) == 0


def test_plan_follows_the_sm_count():
    blocks = {sms: gru.gru_seq_plan(64, 1024, sms)[1]["blocks"]
              for sms in (132, 264)}
    assert blocks == {132: 128, 264: 256}
    assert gru.gru_seq_plan(64, 1024, 128)[1]["blocks"] == 128
    assert gru.gru_seq_plan(64, 1024, 127)[0] == -2
    # fewer SMs: smaller clusters or wider slices, never more blocks
    for sms in (8, 33, 66, 100, 131):
        rc, plan = gru.gru_seq_plan(64, 256, sms)
        assert rc == 0 and plan["blocks"] <= sms
    # spare SMs take row tiles of their own
    _, plan = gru.gru_seq_plan(1024, 200, 264)   # 25 slices x 2 ranks
    assert plan["groups"] == 5 and plan["blocks"] == 250
    assert gru.gru_seq_plan(0, 8, 132)[0] == -3
    assert gru.gru_seq_plan(8, 8, 0)[0] == -3


@pytest.mark.parametrize("n", DOMAIN_N)
@pytest.mark.parametrize("h", DOMAIN_H)
def test_plan_domain_contains_the_old_kernels(n, h):
    old = _old_kernel_fits(n, h)
    rc, _ = gru.gru_seq_plan(n, h, H100_SMS)
    assert rc == 0 or old != 0, f"N={n} H={h}: the old kernel took it"


def test_old_kernel_rules_as_measured():
    """The copied rules give the widths ROADMAP.md records for the old
    kernel: H up to 1056 at any N, a little more at N = 1 and 2."""
    assert all(_old_kernel_fits(n, 1056) == 0 for n in DOMAIN_N)
    assert _old_kernel_fits(64, 1064) == -2
    assert _old_kernel_fits(1, 1157) == 0 and _old_kernel_fits(1, 1160) == -2


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,h", [(13, 3, 200), (100, 64, 1024),
                                   (1, 1, 1024), (7, 5, 37)])
def test_cuda_kernels_match_plain_versions(cuda, t, n, h):
    arrays = [torch.from_numpy(a).to(cuda) for a in _data(t, n, h, seed=3)]
    cts = [torch.from_numpy(c).to(cuda) for c in _cotangents(t, n, h, 3)]
    fns = (gru.gru_seq_infer, gru.gru_seq_fwd, gru.gru_seq_bwd)
    before = [f.launches for f in fns]
    inf = gru.gru_seq_infer(*arrays)
    fwd = gru.gru_seq_fwd(*arrays)
    xw, r, rb, h0 = arrays
    bwd = gru.gru_seq_bwd(*cts, fwd[1], fwd[2], fwd[3], fwd[0], r, h0)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [b + 1 for b in before]
    # 1e-4: another summation order carried through up to 100 steps
    for g, w in zip(inf, gru.gru_seq_infer_reference(*arrays)):
        assert float((g - w).abs().max()) < 1e-4
    for g, w in zip(fwd, gru.gru_seq_fwd_reference(*arrays)):
        assert float((g - w).abs().max()) < 1e-4
    want = gru.gru_seq_bwd_reference(*cts, fwd[1], fwd[2], fwd[3], fwd[0],
                                     r, h0)
    # gradients relative to each one's largest element (dR sums T*N terms)
    for g, w in zip(bwd, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
def test_cuda_gru_layer_carries_a_gradient(cuda):
    x, w, r, b = (a.detach().to(cuda).requires_grad_()
                  for a in _layer_inputs(requires_grad=False))
    before = gru.gru_seq_infer.launches
    out, _ = ops.gruLayer(x, w, r, b)
    grads = torch.autograd.grad(out.sum(), [x, w, r, b])
    assert gru.gru_seq_infer.launches == before
    cpu = [a.detach().cpu().requires_grad_() for a in (x, w, r, b)]
    want = torch.autograd.grad(ops.gruLayer(*cpu)[0].sum(), cpu)
    for g, wv in zip(grads, want):
        assert float((g.cpu() - wv).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,sms", PLAN_SHAPES)
def test_cuda_plan_equals_source(cuda, n, h, sms):
    for save in (0, 1):
        assert gru.gru_seq_source_plan(n, h, save, sms, cuda) == \
            gru.gru_seq_plan(n, h, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 65, 130])
@pytest.mark.parametrize("h", [37, 200, 1000, 1056])
def test_cuda_ragged_shapes_match_plain_with_repeated_bits(cuda, n, h):
    arrays = [torch.from_numpy(a).to(cuda) for a in _data(3, n, h, seed=6)]
    from deeplearning4j_tpu_torch.kernels import rnn_step
    assert rnn_step.takes_persistent("gru_fwd", n, h, cuda)
    with torch.no_grad():
        inf = [gru.gru_seq_infer(*arrays) for _ in range(2)]
    fwd = [gru.gru_seq_fwd(*arrays) for _ in range(2)]
    torch.cuda.synchronize()
    # 1e-4: another summation order than the plain version's matmul
    for got, want in ((inf[0], gru.gru_seq_infer_reference(*arrays)),
                      (fwd[0], gru.gru_seq_fwd_reference(*arrays))):
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) < 1e-4
    for first, second in ((inf[0], inf[1]), (fwd[0], fwd[1])):
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("n", DOMAIN_N)
def test_cuda_fits_contains_the_old_domain(cuda, n):
    """Every (N, H) that the old rules take launches on this card (an H100:
    the old rules are those of its 132 SMs)."""
    from deeplearning4j_tpu_torch.kernels import build
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for h in DOMAIN_H:
        if _old_kernel_fits(n, h, sms) == 0:
            for save in (0, 1):
                assert build.query("gru_seq", "gru_seq_fits", "fits",
                                   [n, h, save], cuda) == 0, (n, h, save)
