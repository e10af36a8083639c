"""The port's LSTM training forward and backward against the JAX package's.

- The plain versions ``lstm_seq_fwd_reference``/``lstm_seq_bwd_reference``
  (what the wrappers run for CPU tensors, and what the CUDA kernels are held
  against on the card) against the JAX Pallas kernels in interpret mode:
  the residual-saving forward ``_fwd_call`` and the backward reached through
  ``jax.vjp`` of ``lstm_seq``, with non-zero dhT and dcT, as
  tests/test_kernels.py runs them. Tolerance: 1e-5 abs/rel on the forward,
  2e-5 abs / 1e-4 rel on the gradients (float32 on the CPU; dR sums T*N
  products in another order than the Pallas kernel's per-step dot).
- ``torch.autograd.gradcheck`` in float64 on the ``lstm_seq`` Function.
- The repair of the inference route: ``lstmLayer`` under grad never takes
  the gradient-less ``lstm_seq_infer``, and ``lstm_seq_infer`` refuses
  inputs that require grad.

Inputs come from a numpy seed. The CUDA kernels themselves are held against
the plain versions on the card in the cuda-marked tests here and in
chip_smoke.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.autodiff.ops import OPS as JAX_OPS
from deeplearning4j_tpu.kernels.lstm import _fwd_call, lstm_seq as jax_seq
from deeplearning4j_tpu_torch.autodiff import ops
from deeplearning4j_tpu_torch.kernels import lstm

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)


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
    xw = rng.normal(size=(t, n, 4 * h)) * 0.3
    r = rng.normal(size=(h, 4 * h)) * 0.1
    h0 = rng.normal(size=(n, h)) * 0.2
    c0 = rng.normal(size=(n, h)) * 0.2
    return [a.astype(dtype) for a in (xw, r, h0, c0)]


def _cotangents(t, n, h, seed):
    rng = np.random.default_rng(seed + 1000)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((t, n, h), (n, h), (n, h))]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("t,n,h", [(5, 8, 128), (1, 8, 128)])
def test_plain_forward_matches_pallas_residual_forward(t, n, h):
    arrays = _data(t, n, h, seed=t)
    want = _fwd_call(*map(jnp.asarray, arrays), True, save_residuals=True)
    got = lstm.lstm_seq_fwd_reference(*map(torch.from_numpy, arrays))
    for g, w in zip(got, want):   # hs, gates, cs
        _close(g.numpy(), w, FWD_TOL)


@pytest.mark.parametrize("t,n,h", [(4, 8, 128), (1, 8, 128), (6, 16, 128)])
def test_plain_backward_matches_pallas_vjp(t, n, h):
    arrays = _data(t, n, h, seed=10 * t + n)
    cts = _cotangents(t, n, h, seed=t)
    (hs, hT, cT), vjp = jax.vjp(lambda *a: jax_seq(*a, True),
                                *map(jnp.asarray, arrays))
    want = vjp(tuple(map(jnp.asarray, cts)))
    xw, r, h0, c0 = map(torch.from_numpy, arrays)
    hs_t, gates, cs = lstm.lstm_seq_fwd_reference(xw, r, h0, c0)
    _close(hs_t.numpy(), hs, FWD_TOL)
    got = lstm.lstm_seq_bwd_reference(*map(torch.from_numpy, cts), gates,
                                      cs, hs_t, r, h0, c0)
    for g, w, name in zip(got, want, ("dxw", "dR", "dh0", "dc0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_function_gradients_match_jax_vjp():
    t, n, h = 3, 8, 128
    arrays = _data(t, n, h, seed=4)
    cts = _cotangents(t, n, h, seed=4)
    outs, vjp = jax.vjp(lambda *a: jax_seq(*a, True),
                        *map(jnp.asarray, arrays))
    want = vjp(tuple(map(jnp.asarray, cts)))
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    got_outs = lstm.lstm_seq(*ins)
    assert "_LstmSeq" in type(got_outs[0].grad_fn).__name__
    for g, w in zip(got_outs, outs):
        _close(g.detach().numpy(), w, FWD_TOL)
    got = torch.autograd.grad(got_outs, ins,
                              [torch.from_numpy(c) for c in cts])
    for g, w, name in zip(got, want, ("dxw", "dR", "dh0", "dc0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_gradcheck_float64():
    ins = [torch.tensor(a, requires_grad=True)
           for a in _data(3, 2, 3, seed=8, dtype=np.float64)]
    assert torch.autograd.gradcheck(lstm.lstm_seq, ins, eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    arrays = [torch.from_numpy(a) for a in _data(4, 3, 20, seed=2)]
    cts = [torch.from_numpy(c) for c in _cotangents(4, 3, 20, seed=2)]
    before = (lstm.lstm_seq_fwd.launches, lstm.lstm_seq_bwd.launches)
    fwd = lstm.lstm_seq_fwd(*arrays)
    for g, w in zip(fwd, lstm.lstm_seq_fwd_reference(*arrays)):
        assert torch.equal(g, w)
    hs, gates, cs = fwd
    xw, r, h0, c0 = arrays
    bwd = lstm.lstm_seq_bwd(*cts, gates, cs, hs, r, h0, c0)
    for g, w in zip(bwd, lstm.lstm_seq_bwd_reference(*cts, gates, cs, hs, r,
                                                     h0, c0)):
        assert torch.equal(g, w)
    assert (lstm.lstm_seq_fwd.launches, lstm.lstm_seq_bwd.launches) == before


@pytest.mark.parametrize("bad", ["dhT", "gates", "r"])
def test_backward_rejects_mismatched_shapes(bad):
    xw, r, h0, c0 = (torch.from_numpy(a) for a in _data(3, 4, 8))
    hs, gates, cs = lstm.lstm_seq_fwd(xw, r, h0, c0)
    dhs, dhT, dcT = (torch.from_numpy(c) for c in _cotangents(3, 4, 8, 0))
    if bad == "dhT":
        dhT = dhT[:2]
    elif bad == "gates":
        gates = gates[:, :, :16]
    else:
        r = r[:4]
    with pytest.raises(ValueError, match=bad):
        lstm.lstm_seq_bwd(dhs, dhT, dcT, gates, cs, hs, r, h0, c0)


# -- the repaired inference route -------------------------------------------

def _layer_inputs(requires_grad):
    n, i, t, h = 3, 5, 4, 12
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=s).astype(np.float32) * 0.3
              for s in ((n, i, t), (i, 4 * h), (h, 4 * h), (4 * h,))]
    return [torch.tensor(a, requires_grad=requires_grad) for a in arrays]


def test_infer_route_refuses_inputs_that_require_grad():
    xw, r, h0, c0 = (torch.tensor(a, requires_grad=True)
                     for a in _data(2, 3, 8))
    with pytest.raises(RuntimeError, match="no gradient"):
        lstm.lstm_seq_infer(xw, r, h0, c0)
    with torch.no_grad():   # no graph is asked for: the inference route
        lstm.lstm_seq_infer(xw, r, h0, c0)


def test_lstm_layer_under_grad_never_takes_the_infer_route(monkeypatch):
    calls = []

    def infer_spy(*a):
        calls.append("infer")
        return lstm.lstm_seq_infer(*a)

    monkeypatch.setattr(ops, "lstm_seq_infer", infer_spy)
    x, w, r, b = _layer_inputs(requires_grad=True)
    out, hT, cT = ops.lstmLayer(x, w, r, b, forgetBias=1.0)
    assert calls == []
    assert "_LstmSeq" in type(hT.grad_fn).__name__
    grads = torch.autograd.grad(out.sum() + cT.sum(), [x, w, r, b])
    assert all(bool(torch.isfinite(g).all()) and g.abs().sum() > 0
               for g in grads)
    # only the input of a frozen layer needs grad: still the autograd route
    xg = _layer_inputs(requires_grad=False)
    xg[0].requires_grad_(True)
    assert "_LstmSeq" in type(ops.lstmLayer(*xg)[1].grad_fn).__name__
    assert calls == []
    # inference: no grad mode, or nothing requires grad
    with torch.inference_mode():
        ops.lstmLayer(x, w, r, b)
    with torch.no_grad():
        ops.lstmLayer(x, w, r, b)
    ops.lstmLayer(*_layer_inputs(requires_grad=False))
    assert calls == ["infer"] * 3


def test_lstm_layer_gradients_match_jax():
    n, i, t, h = 3, 7, 5, 16
    rng = np.random.default_rng(17)
    arrays = [rng.normal(size=s).astype(np.float32) * 0.3
              for s in ((n, i, t), (i, 4 * h), (h, 4 * h), (4 * h,),
                        (n, h), (n, h))]
    probe = rng.normal(size=(n, h, t)).astype(np.float32)

    def jax_loss(x, w, r, b, h0, c0):
        out, hT, cT = JAX_OPS["lstmLayer"](x, w, r, b, h0=h0, c0=c0,
                                           forgetBias=0.7)
        return jnp.sum(out * probe) + jnp.sum(hT * hT) + jnp.sum(cT)

    want = jax.grad(jax_loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, arrays))
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    out, hT, cT = ops.lstmLayer(*ins[:4], h0=ins[4], c0=ins[5],
                                forgetBias=0.7)
    loss = (out * torch.from_numpy(probe)).sum() + (hT * hT).sum() + cT.sum()
    got = torch.autograd.grad(loss, ins)
    for g, w, name in zip(got, want, ("x", "W", "R", "b", "h0", "c0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,h", [(13, 3, 200), (100, 32, 256),
                                   (1, 8, 256)])
def test_cuda_kernels_match_plain_versions(cuda, t, n, h):
    arrays = [torch.from_numpy(a).to(cuda) for a in _data(t, n, h, seed=3)]
    cts = [torch.from_numpy(c).to(cuda) for c in _cotangents(t, n, h, 3)]
    before = (lstm.lstm_seq_fwd.launches, lstm.lstm_seq_bwd.launches)
    fwd = lstm.lstm_seq_fwd(*arrays)
    bwd = lstm.lstm_seq_bwd(*cts, fwd[1], fwd[2], fwd[0], *arrays[1:])
    torch.cuda.synchronize()
    assert (lstm.lstm_seq_fwd.launches, lstm.lstm_seq_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_fwd = lstm.lstm_seq_fwd_reference(*arrays)
    want_bwd = lstm.lstm_seq_bwd_reference(*cts, fwd[1], fwd[2], fwd[0],
                                           *arrays[1:])
    # 1e-4: another summation order carried through up to 100 steps
    for g, w in zip(fwd, want_fwd):
        assert float((g - w).abs().max()) < 1e-4
    # gradients relative to each one's largest element (dR sums T*N terms)
    for g, w in zip(bwd, want_bwd):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
def test_cuda_lstm_layer_carries_a_gradient(cuda):
    x, w, r, b = (a.detach().to(cuda).requires_grad_()
                  for a in _layer_inputs(requires_grad=False))
    before = lstm.lstm_seq_infer.launches
    out, _, _ = ops.lstmLayer(x, w, r, b, forgetBias=1.0)
    grads = torch.autograd.grad(out.sum(), [x, w, r, b])
    assert lstm.lstm_seq_infer.launches == before
    cpu = [a.detach().cpu().requires_grad_() for a in (x, w, r, b)]
    want = torch.autograd.grad(ops.lstmLayer(*cpu, forgetBias=1.0)[0].sum(),
                               cpu)
    for g, wv in zip(grads, want):
        assert float((g.cpu() - wv).abs().max()) < 1e-4
