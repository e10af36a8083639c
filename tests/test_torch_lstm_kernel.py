"""The port's LSTM recurrence against the JAX package's.

The plain version ``lstm_seq_infer_reference`` (what the wrapper runs for
CPU tensors) is held against the JAX Pallas kernel ``lstm_seq`` in
interpret mode, as tests/test_kernels.py runs it, and the port's
``lstmLayer`` against the JAX ``lstmLayer`` (its lax.scan path on the CPU)
at an unaligned shape with a non-zero forgetBias. Inputs come from a numpy
seed. Tolerance: 1e-5 abs/rel, float32 on the CPU (the two frameworks sum
h.R in different orders). The CUDA kernel itself is held against the
plain version on the card, in the cuda-marked test here and in
chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.autodiff.ops import OPS as JAX_OPS
from deeplearning4j_tpu.kernels.lstm import lstm_seq
from deeplearning4j_tpu_torch.autodiff.ops import lstmCell, lstmLayer
from deeplearning4j_tpu_torch.kernels.lstm import (
    lstm_seq_infer, lstm_seq_infer_reference)

RTOL, ATOL = 1e-5, 1e-5


def _data(t, n, h, seed=0):
    rng = np.random.default_rng(seed)
    xw = (rng.normal(size=(t, n, 4 * h)) * 0.3).astype(np.float32)
    r = (rng.normal(size=(h, 4 * h)) * 0.1).astype(np.float32)
    h0 = (rng.normal(size=(n, h)) * 0.2).astype(np.float32)
    c0 = (rng.normal(size=(n, h)) * 0.2).astype(np.float32)
    return xw, r, h0, c0


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t,n,h", [(5, 8, 128), (1, 8, 128), (7, 16, 128)])
def test_plain_version_matches_pallas_interpret(t, n, h):
    arrays = _data(t, n, h, seed=t * 100 + n)
    want = lstm_seq(*map(jnp.asarray, arrays), True)
    got = lstm_seq_infer_reference(*map(torch.from_numpy, arrays))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    arrays = [torch.from_numpy(a) for a in _data(4, 3, 40, seed=1)]
    before = lstm_seq_infer.launches
    got = lstm_seq_infer(*arrays)
    want = lstm_seq_infer_reference(*arrays)
    assert lstm_seq_infer.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad", ["h", "h0", "c0", "rank"])
def test_wrapper_rejects_mismatched_shapes(bad):
    xw, r, h0, c0 = (torch.from_numpy(a) for a in _data(3, 4, 8))
    if bad == "h":
        r = r[:, :16]
    elif bad == "h0":
        h0 = h0[:3]
    elif bad == "c0":
        c0 = c0[:, :4]
    else:
        xw = xw[0]
    with pytest.raises(ValueError):
        lstm_seq_infer(xw, r, h0, c0)


@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_layer_matches_jax_scan_unaligned(with_state):
    n, i, t, h = 3, 7, 6, 40
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, i, t)).astype(np.float32)
    w = (rng.normal(size=(i, 4 * h)) * 0.3).astype(np.float32)
    r = (rng.normal(size=(h, 4 * h)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32)
    state = {}
    if with_state:
        state = {"h0": (rng.normal(size=(n, h)) * 0.3).astype(np.float32),
                 "c0": (rng.normal(size=(n, h)) * 0.3).astype(np.float32)}
    want = JAX_OPS["lstmLayer"](
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(r), jnp.asarray(b),
        forgetBias=0.7, **{k: jnp.asarray(v) for k, v in state.items()})
    got = lstmLayer(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(r),
        torch.from_numpy(b), forgetBias=0.7,
        **{k: torch.from_numpy(v) for k, v in state.items()})
    assert got[0].shape == (n, h, t)
    for g, wv in zip(got, want):
        _close(g.numpy(), wv)


def test_lstm_layer_last_step_only_and_cell():
    n, i, t, h = 2, 5, 4, 12
    rng = np.random.default_rng(11)
    x, w, r, b = (rng.normal(size=s).astype(np.float32) * 0.3 for s in
                  ((n, i, t), (i, 4 * h), (h, 4 * h), (4 * h,)))
    args = [jnp.asarray(a) for a in (x, w, r, b)]
    targs = [torch.from_numpy(a) for a in (x, w, r, b)]
    want = JAX_OPS["lstmLayer"](*args, forgetBias=1.0,
                                returnFullSequence=False)
    got = lstmLayer(*targs, forgetBias=1.0, returnFullSequence=False)
    for g, wv in zip(got, want):
        _close(g.numpy(), wv)
    h0 = np.zeros((n, h), np.float32)
    want_cell = JAX_OPS["lstmCell"](args[0][:, :, 0], jnp.asarray(h0),
                                    jnp.asarray(h0), args[1], args[2],
                                    args[3], forgetBias=1.0)
    got_cell = lstmCell(targs[0][:, :, 0], torch.from_numpy(h0),
                        torch.from_numpy(h0), targs[1], targs[2], targs[3],
                        forgetBias=1.0)
    for g, wv in zip(got_cell, want_cell):
        _close(g.numpy(), wv)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,h", [(13, 3, 200), (100, 8, 256)])
def test_cuda_kernel_matches_plain_version(t, n, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    arrays = [torch.from_numpy(a).cuda() for a in _data(t, n, h, seed=3)]
    before = lstm_seq_infer.launches
    got = lstm_seq_infer(*arrays)
    torch.cuda.synchronize()
    assert lstm_seq_infer.launches == before + 1
    want = lstm_seq_infer_reference(*arrays)
    for g, w in zip(got, want):
        # 1e-4: another summation order carried through up to 100 steps
        assert float((g - w).abs().max()) < 1e-4
