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
