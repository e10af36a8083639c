"""The port's flash attention (``deeplearning4j_tpu_torch.kernels.flash``)
against the JAX package's.

The TPU kernel that ``deeplearning4j_tpu/models/bert.py`` calls
(``jax.experimental.pallas.ops.tpu.flash_attention``) has no interpret
mode, so the plain versions, which the wrappers run for CPU tensors and
which the CUDA kernels are held against on the card, are checked against
that module's own plain ``mha_reference`` (forward, and the m, l
residuals of ``mha_reference_no_custom_vjp``), its VJP by ``jax.vjp``, and
BERT's ``_dense_attention``. Inputs come from numpy seeds; sm_scale is
1/sqrt(D) as BERT calls it.

Tolerances: float32 2e-6 abs / 1e-5 rel on o, m, l and di, 1e-5 abs /
1e-4 rel on the gradients (another summation order); bfloat16 2e-2 abs
on o (values of order 0.1-1; bf16 keeps 8 bits and the two sides round
the scores and p at other places).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jflash

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu_torch.kernels import flash

F32 = dict(rtol=1e-5, atol=2e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 2e-2
SHAPES = [(2, 4, 16, 8), (3, 2, 24, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and leaves the cores
    to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_residuals_match_mha_reference(shape):
    q, k, v = _qkv(shape, 0)
    scale = 1.0 / math.sqrt(shape[-1])
    want = jflash.mha_reference(q, k, v, None, sm_scale=scale)
    w_o, w_l, w_m = jflash.mha_reference_no_custom_vjp(
        q, k, v, sm_scale=scale, save_residuals=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, m, l = flash.flash_fwd(tq, tk, tv, scale)
    assert m.dtype == l.dtype == torch.float32 and m.shape == shape[:3]
    _close(o, want, **F32)
    _close(o, w_o, **F32)
    _close(m, w_m, **F32)
    _close(l, w_l, **F32)
    _close(flash.flash_attention_infer(tq, tk, tv, scale), want, **F32)
    _close(flash.flash_attention_reference(tq, tk, tv, scale), want, **F32)


@pytest.mark.parametrize("shape", SHAPES)
def test_vjp_and_di_match_jax(shape):
    q, k, v = _qkv(shape, 1)
    do = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    scale = 1.0 / math.sqrt(shape[-1])
    out, vjp = jax.vjp(lambda a, b, c: jflash.mha_reference_no_custom_vjp(
        a, b, c, sm_scale=scale), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash.flash_attention(tq, tk, tv, scale)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g, w, **GRAD)
    # the wrappers' pieces, and the reference's own flash VJP rule
    # (mha_reference_bwd takes sm_scale = 1, so q is scaled first)
    with torch.no_grad():
        o, m, l = flash.flash_fwd(tq, tk, tv, scale)
        tdo = torch.from_numpy(do)
        dk, dv, di = flash.flash_bwd_dkv(tq, tk, tv, o, tdo, m, l, scale)
        dq = flash.flash_bwd_dq(tq, tk, tv, tdo, m, l, di, scale)
    _close(di, np.sum(np.asarray(out) * do, axis=-1), **F32)
    qs = q * scale
    _, l1, m1 = jflash.mha_reference_no_custom_vjp(qs, k, v,
                                                   save_residuals=True)
    rq, rk, rv, _ = jflash.mha_reference_bwd(qs, k, v, None, None, out, l1,
                                             m1, do)
    for g, w in ((dq, np.asarray(rq) * scale), (dk, rk), (dv, rv)):
        _close(g, w, **GRAD)
    for g, w in zip(flash.flash_bwd_reference(tq, tk, tv, o, tdo, m, l,
                                              scale), (dq, dk, dv)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_bert_dense_attention(dtype):
    shape = (2, 4, 16, 8)
    q, k, v = _qkv(shape, 3)
    jd = jnp.dtype(dtype)
    want = np.asarray(jbert._dense_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v))), np.float32)
    td = getattr(torch, dtype)
    got = flash.flash_attention_infer(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)),
        1.0 / math.sqrt(shape[-1]))
    assert got.dtype == td
    if dtype == "float32":
        _close(got, want, **F32)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=BF16_ATOL)


def test_bf16_plain_version_rounds_p_before_pv():
    """In bf16, p is rounded to v's dtype before p.v (as the reference's
    kernel does): the plain version equals that arithmetic written out,
    and the gradient of the bf16 path stays within bf16 reach of f32."""
    shape = (1, 2, 24, 64)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(shape, 4))
    scale = 0.125
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = ((p.to(torch.bfloat16).float() @ v.float())
            / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    o, _, _ = flash.flash_fwd(q, k, v, scale)
    torch.testing.assert_close(o, want, rtol=0, atol=0)
    o32 = flash.flash_attention_reference(q.float(), k.float(), v.float(),
                                          scale)
    assert float((o.float() - o32).abs().max()) < BF16_ATOL


def test_wrappers_check_their_inputs():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="differ"):
        flash.flash_attention(q, torch.zeros(1, 2, 9, 64), q, 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        m = torch.zeros(1, 2, 8, 64, device="meta")
        flash.flash_attention_infer(m, m, m, 0.1)
    with pytest.raises(RuntimeError, match="no gradient"):
        r = q.clone().requires_grad_()
        flash.flash_attention_infer(r, r, r, 0.1)
    with pytest.raises(ValueError, match="float32"):
        flash.flash_bwd_dq(q, q, q, q, torch.zeros(1, 2, 8, 1),
                           torch.zeros(1, 2, 8), torch.zeros(1, 2, 8), 0.1)


def test_cuda_less_call_with_no_device_raises():
    """BERT's entry points, given no device, take CUDA and raise without
    it (the kernels' only route is the card)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from deeplearning4j_tpu_torch.models import bert as tbert
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbert.BertTrainer(tbert.BertConfig(vocab_size=97, hidden=32,
                                           num_layers=1, num_heads=4,
                                           ffn=64, max_len=32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 200, 64), (1, 2, 256, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda, shape, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in _qkv(shape, 5))
    do = torch.from_numpy(_qkv(shape, 6)[0]).to(cuda, dtype)
    scale = 1.0 / math.sqrt(shape[-1])
    fns = (flash.flash_fwd, flash.flash_attention_infer,
           flash.flash_bwd_dkv, flash.flash_bwd_dq)
    before = [f.launches for f in fns]
    o, m, l = flash.flash_fwd(q, k, v, scale)
    oi = flash.flash_attention_infer(q, k, v, scale)
    dk, dv, di = flash.flash_bwd_dkv(q, k, v, o, do, m, l, scale)
    dq = flash.flash_bwd_dq(q, k, v, do, m, l, di, scale)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [b + 1 for b in before]
    ro, rm, rl = flash.flash_fwd_reference(q, k, v, scale)
    fwd_tol = 1e-5 if dtype == torch.float32 else 1e-2
    bwd_tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in ((o, ro), (oi, ro), (m, rm), (l, rl)):
        assert float((g.float() - w.float()).abs().max()) <= \
            fwd_tol * float(w.float().abs().max())
    for g, w in zip((dq, dk, dv),
                    flash.flash_bwd_reference(q, k, v, o, do, m, l, scale)):
        assert float((g.float() - w.float()).abs().max()) <= \
            bwd_tol * float(w.float().abs().max())


# ---------------------------------------------------------------------------
# the bf16 tensor-core forward's arithmetic, and the forward's launch plan
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# chip_smoke.py's FLASH_TOL for bfloat16, relative to each output's
# largest element: forward 1e-2, backward 2e-2
BF16_FWD_TOL, BF16_BWD_TOL = 1e-2, 2e-2
# SMs of an H100 SXM; one block's dynamic shared memory on it
H100_SMS, SMEM_LIMIT = 132, 232448


def _tiled_bf16_forward(q, k, v, scale, tile=64):
    """csrc/flash_attn_fwd.cu's bf16 kernel written out in float32 torch:
    s in f32 sums, times scale * log2(e) (base 2); key tiles of ``tile``
    with the running max m2, alpha = 2^(m2_old - m2_new), p = 2^(s - m2)
    rounded to bf16 for p.v at the tile's running max, l summing the
    unrounded p; o = acc / l in bf16 and m stored in natural units."""
    q, k, v = (a.float() for a in (q, k, v))
    t = q.shape[-2]
    scale2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    s_all = (q @ k.transpose(-1, -2)) * scale2
    m2 = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for j0 in range(0, t, tile):
        s = s_all[..., j0:j0 + tile]
        new = torch.maximum(m2, s.amax(-1))
        alpha = torch.exp2(m2 - new)
        p = torch.exp2(s - new[..., None])
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ \
            v[..., j0:j0 + tile, :]
        m2 = new
    o = (acc * (1.0 / l)[..., None]).to(torch.bfloat16)
    return o, m2 * LN2, l


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_qkv(shape, seed):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(shape, seed)]


@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (2, 2, 130, 128),
                                   (1, 3, 64, 64)])
def test_tiled_bf16_arithmetic_matches_the_references(shape):
    """The kernel's tiled arithmetic against the Pallas module's own plain
    mha_reference (float32 on the same bf16 values) and the port's plain
    version, at D = 64 and 128 and ragged T."""
    q, k, v = _bf16_qkv(shape, 7)
    scale = 1.0 / math.sqrt(shape[-1])
    o, m, l = _tiled_bf16_forward(q, k, v, scale)
    jq, jk, jv = (a.float().numpy() for a in (q, k, v))
    want = jflash.mha_reference(jq, jk, jv, None, sm_scale=scale)
    _, w_l, w_m = jflash.mha_reference_no_custom_vjp(
        jq, jk, jv, sm_scale=scale, save_residuals=True)
    assert _rel(o.float(), want) <= BF16_FWD_TOL
    assert _rel(m, w_m) <= 1e-5 and _rel(l, w_l) <= 1e-5
    ro, rm, rl = flash.flash_fwd_reference(q, k, v, scale)
    assert _rel(o.float(), ro.float()) <= BF16_FWD_TOL
    assert _rel(m, rm) <= 1e-5 and _rel(l, rl) <= 1e-5


def test_tiled_bf16_arithmetic_matches_bert_dense_attention():
    shape = (2, 4, 96, 64)
    q, k, v = _bf16_qkv(shape, 8)
    want = np.asarray(jbert._dense_attention(
        *(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (q, k, v))),
        np.float32)
    o, _, _ = _tiled_bf16_forward(q, k, v, 1.0 / math.sqrt(shape[-1]))
    np.testing.assert_allclose(o.float().numpy(), want, rtol=0,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (1, 2, 72, 128)])
def test_tiled_m_and_l_give_the_reference_gradients(shape):
    """m (stored in natural units) and l of the tiled arithmetic, fed to
    the backward's plain version, give the gradients of the reference's
    VJP (jax.vjp of mha_reference in float32 on the same bf16 values)."""
    q, k, v = _bf16_qkv(shape, 9)
    do = torch.from_numpy(_qkv(shape, 10)[0]).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(shape[-1])
    o, m, l = _tiled_bf16_forward(q, k, v, scale)
    got = flash.flash_bwd_reference(q, k, v, o, do, m, l, scale)
    jq, jk, jv = (a.float().numpy() for a in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: jflash.mha_reference_no_custom_vjp(
        a, b, c, sm_scale=scale), jq, jk, jv)
    want = vjp(jnp.asarray(do.float().numpy()))
    for g, w in zip(got, want):
        assert _rel(g.float(), w) <= BF16_BWD_TOL
    ro, rm, rl = flash.flash_fwd_reference(q, k, v, scale)
    for g, w in zip(got, flash.flash_bwd_reference(q, k, v, ro, do, rm, rl,
                                                   scale)):
        assert _rel(g.float(), w.float()) <= BF16_BWD_TOL


def _flash_shapes():
    import chip_smoke
    return chip_smoke.FLASH_SHAPES


@pytest.mark.parametrize("shape", _flash_shapes())
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_plan_fits_and_covers_each_row_once(shape, dtype):
    """At every shape chip_smoke.py drives: the block's shared memory fits
    an H100, and the grid (b*h, query tiles) covers every row of q once."""
    b, h, t, d = shape
    plan = flash.fwd_plan(b * h, t, d, dtype)
    assert set(plan) == set(flash.PLAN_FIELDS)
    assert 0 < plan["smem_bytes"] <= SMEM_LIMIT
    assert plan["threads"] <= 1024 and plan["threads"] % 32 == 0
    assert plan["grid_x"] == b * h
    rows = plan["rows"]
    covered = [q0 + r for q0 in range(0, plan["grid_y"] * rows, rows)
               for r in range(rows) if q0 + r < t]
    assert covered == list(range(t))
    assert (plan["grid_y"] - 1) * rows < t
    if dtype == torch.bfloat16:
        assert plan["rows"] == plan["threads"] // 2   # 64 a warpgroup
        assert plan["stages"] >= 2


def test_forward_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        flash.fwd_plan(2, 64, 96, torch.bfloat16)
    with pytest.raises(ValueError):
        flash.fwd_plan(0, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError):
        flash.fwd_plan(2, 64, 64, torch.float16)
    with pytest.raises(ValueError, match="head size"):
        flash._cuda_args("flash_fwd", (1, 2, 8, 96),
                         [torch.zeros(1, 2, 8, 96)])
    with pytest.raises(ValueError, match="dtype"):
        flash._cuda_args("flash_fwd", (1, 2, 8, 64),
                         [torch.zeros(1, 2, 8, 64, dtype=torch.float16)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_source_plan_matches_its_mirror(cuda, dtype):
    for b, h, t, d in _flash_shapes():
        assert flash.fwd_source_plan(b * h, t, d, dtype) == \
            flash.fwd_plan(b * h, t, d, dtype)


# ---------------------------------------------------------------------------
# the bf16 tensor-core backward's arithmetic, and the backward's launch plan
# ---------------------------------------------------------------------------


# the tiled backward against the port's plain version, relative to each
# gradient's largest element: a few bf16 ulps (2^-8 relative each) where
# p or ds round the other way
TILED_BWD_TOL = 5e-3


def _tiled_bf16_backward(q, k, v, do, m, l, di, scale, tile=64):
    """csrc/flash_attn_bwd.cu's bf16 kernels written out in float32 torch,
    to f32 rounding (the card sums each tile's products in its own order
    and fuses s * scale2 - m2 into one fma): p = 2^(s scale log2(e) -
    m log2(e)) (1/l) from m in natural units, ds = (dp - di) p scale. dk and
    dv sum tiles of ``tile`` queries in order, p^T and ds^T rounded to bf16
    per tile; dq sums tiles of ``tile`` keys in order, ds rounded to bf16
    per tile. dq, dk and dv are rounded to bf16 once, at the end."""
    q, k, v, do = (a.float() for a in (q, k, v, do))
    t = q.shape[-2]
    scale2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    m2 = m * torch.tensor(LOG2E, dtype=torch.float32)
    li = 1.0 / l

    def bf(x):
        return x.to(torch.bfloat16).float()

    dk, dv, dq = (torch.zeros(q.shape) for _ in range(3))
    for j0 in range(0, t, tile):   # the dkv kernel's query tiles
        j = slice(j0, j0 + tile)
        st = k @ q[..., j, :].transpose(-1, -2)     # [keys, queries]
        dpt = v @ do[..., j, :].transpose(-1, -2)
        pt = torch.exp2(st * scale2 - m2[..., None, j]) * li[..., None, j]
        dst = (dpt - di[..., None, j]) * pt * scale
        dv = dv + bf(pt) @ do[..., j, :]
        dk = dk + bf(dst) @ q[..., j, :]
    for j0 in range(0, t, tile):   # the dq kernel's key tiles
        j = slice(j0, j0 + tile)
        s = q @ k[..., j, :].transpose(-1, -2)      # [queries, keys]
        dp = do @ v[..., j, :].transpose(-1, -2)
        p = torch.exp2(s * scale2 - m2[..., None]) * li[..., None]
        ds = (dp - di[..., None]) * p * scale
        dq = dq + bf(ds) @ k[..., j, :]
    return tuple(a.to(torch.bfloat16) for a in (dq, dk, dv))


@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (2, 2, 130, 128),
                                   (1, 3, 64, 64)])
def test_tiled_bf16_backward_matches_the_references(shape):
    """The backward kernels' tiled arithmetic, fed by the tiled forward's
    o, m and l as on the card, against the Pallas module's reference VJP
    (jax.vjp of mha_reference_no_custom_vjp, float32 on the same bf16
    values: it rounds neither p nor ds, so the gap is bf16 rounding;
    chip_smoke.py's bf16 backward gate, 2e-2 of each gradient's largest
    element) and the port's flash_bwd_reference (which rounds p and ds to
    bf16 too, from exp of s scale - m rather than exp2, so an element's
    rounding flips by one bf16 ulp at most: TILED_BWD_TOL), at D = 64 and
    128 and ragged T."""
    q, k, v = _bf16_qkv(shape, 11)
    do = torch.from_numpy(_qkv(shape, 12)[0]).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(shape[-1])
    o, m, l = _tiled_bf16_forward(q, k, v, scale)
    got = _tiled_bf16_backward(q, k, v, do, m, l,
                               flash.flash_di_reference(o, do), scale)
    jq, jk, jv = (a.float().numpy() for a in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: jflash.mha_reference_no_custom_vjp(
        a, b, c, sm_scale=scale), jq, jk, jv)
    want = vjp(jnp.asarray(do.float().numpy()))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float(), w) <= BF16_BWD_TOL
    for g, w in zip(got, flash.flash_bwd_reference(q, k, v, o, do, m, l,
                                                   scale)):
        assert _rel(g.float(), w.float()) <= TILED_BWD_TOL


@pytest.mark.parametrize("shape", _flash_shapes())
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["dkv", "dq"])
def test_backward_plan_fits_and_covers_each_row_once(shape, dtype, which):
    """At every shape chip_smoke.py drives: the block's shared memory fits
    an H100, and the grid (b*h, tiles of the block's own rows) covers
    every key row (dkv) or query row (dq) once."""
    b, h, t, d = shape
    plan = flash.bwd_plan(which, b * h, t, d, dtype)
    assert set(plan) == set(flash.PLAN_FIELDS)
    assert 0 < plan["smem_bytes"] <= SMEM_LIMIT
    assert plan["threads"] <= 1024 and plan["threads"] % 32 == 0
    assert plan["grid_x"] == b * h
    rows = plan["rows"]
    covered = [r0 + r for r0 in range(0, plan["grid_y"] * rows, rows)
               for r in range(rows) if r0 + r < t]
    assert covered == list(range(t))
    assert (plan["grid_y"] - 1) * rows < t
    if dtype == torch.bfloat16:
        assert plan["rows"] == plan["threads"] // 2   # 64 a warpgroup
        assert plan["stages"] >= 2


def test_backward_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        flash.bwd_plan("dkv", 2, 64, 96, torch.bfloat16)
    with pytest.raises(ValueError):
        flash.bwd_plan("dq", 0, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError):
        flash.bwd_plan("dq", 2, 0, 64, torch.float32)
    with pytest.raises(ValueError):
        flash.bwd_plan("dkv", 2, 64, 64, torch.float16)
    with pytest.raises(ValueError):
        flash.bwd_plan("dqkv", 2, 64, 64, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_source_plan_matches_its_mirror(cuda, dtype):
    for b, h, t, d in _flash_shapes():
        for which in flash.BWD_WHICH:
            assert flash.bwd_source_plan(which, b * h, t, d, dtype) == \
                flash.bwd_plan(which, b * h, t, d, dtype)
