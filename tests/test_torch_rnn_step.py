"""Repairs of three faults of the port against the JAX package.

- Embedding ids outside [0, nIn): the port's ``take_rows`` (EmbeddingLayer,
  EmbeddingSequenceLayer and BERT's embed) against the JAX layers' own
  gather, with ids [0, 5, -1, -7] into a 4-row table and float ids
  (truncated toward zero): a negative id wraps once, then the id is
  clamped. Exact equality (a gather copies rows); on the card (cuda
  marker) the same rows as on the CPU, with no device-side assert.
- The LSTM and GRU widths the persistent kernels refuse: the route is
  chosen by shape before any launch (``kernels/rnn_step.py``
  ``takes_persistent`` asks each persistent source's ``*_fits`` entry,
  the launch's own checks with nothing launched). On the CPU: each kind
  asks its own source and entry, and the answer's codes map to the route.
  On the card (cuda marker): the LSTM at H = 512 and 1024 and the GRU at
  H = 2048 take the step route, and the widths the persistent kernels
  took before keep them. The step kernels themselves run only on the
  card: the cuda-marked tests here and ``chip_smoke.py`` hold them
  against the plain versions (1e-4 forward, 1e-4 of each output's
  largest element backward).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu_torch.kernels import gru, lstm, rnn_step
from deeplearning4j_tpu_torch.nn.conf import layers as port_layers
from deeplearning4j_tpu_torch.nn.conf.layers import take_rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and leaves the cores
    to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


W = np.arange(12, dtype=np.float32).reshape(4, 3)
IDS = [np.array([0, 5, -1, -7]), np.array([2.7, -1.2, 5.9, -4.0, -0.5])]


@pytest.mark.parametrize("ids", IDS)
def test_take_rows_follows_the_jax_index_rule(ids):
    want = np.asarray(jnp.asarray(W)[jnp.asarray(ids).astype(jnp.int32)])
    got = take_rows(torch.from_numpy(W), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    if ids.dtype.kind == "i":
        np.testing.assert_array_equal(got.numpy(), W[[0, 3, 3, 0]])


@pytest.mark.parametrize("ids", IDS)
@pytest.mark.parametrize("kind", ["EmbeddingLayer",
                                  "EmbeddingSequenceLayer"])
def test_embedding_layers_match_jax_out_of_range(kind, ids):
    jl = getattr(jax_layers, kind)(nIn=4, nOut=3)
    tl = getattr(port_layers, kind)(nIn=4, nOut=3)
    x = ids.astype(np.float32).reshape(1, -1) if kind.endswith(
        "SequenceLayer") else ids.astype(np.float32).reshape(-1, 1)
    want, _ = jl.apply({"W": jnp.asarray(W)}, (), jnp.asarray(x), False,
                       None)
    got, _ = tl.apply({"W": torch.from_numpy(W)}, (), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (kind, source, entry, arguments after N and H) of every route query
ROUTE_QUERIES = [
    ("lstm_infer", "lstm_seq_infer", "lstm_seq_fits", [0]),
    ("lstm_fwd", "lstm_seq_infer", "lstm_seq_fits", [1]),
    ("lstm_bwd", "lstm_seq_bwd", "lstm_seq_bwd_fits", []),
    ("gru_infer", "gru_seq", "gru_seq_fits", [0]),
    ("gru_fwd", "gru_seq", "gru_seq_fits", [1]),
    ("gru_bwd", "gru_seq_bwd", "gru_seq_bwd_fits", []),
]


@pytest.fixture
def asked(monkeypatch):
    """``build.query`` replaced by a recorder that answers ``asked.rc``."""
    class Calls(list):
        rc = 0

    calls = Calls()

    def query(name, entry, what, args, device):
        calls.append((name, entry, list(args), device))
        return calls.rc

    monkeypatch.setattr(rnn_step.build, "query", query)
    rnn_step._fits.cache_clear()
    yield calls
    rnn_step._fits.cache_clear()


@pytest.mark.parametrize("kind,source,entry,flags", ROUTE_QUERIES)
def test_route_asks_the_persistent_source(asked, kind, source, entry,
                                          flags):
    dev = torch.device("cuda", 0)
    for rc, persistent in ((0, True), (-1, False), (-2, False)):
        rnn_step._fits.cache_clear()
        asked.rc = rc
        assert rnn_step.takes_persistent(kind, 32, 512, dev) is persistent
    assert asked == [(source, entry, [32, 512, *flags], dev)] * 3
    # asked once per shape and card: the answer is kept
    rnn_step.takes_persistent(kind, 32, 512, dev)
    assert len(asked) == 3


def test_route_refuses_unknown_kinds_and_codes(asked):
    with pytest.raises(ValueError):
        rnn_step.takes_persistent("conv", 1, 1, torch.device("cuda", 0))
    asked.rc = -3
    with pytest.raises(RuntimeError):
        rnn_step.takes_persistent("gru_fwd", 0, 8, torch.device("cuda", 0))


def _lstm_data(t, n, h, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))
            for s, sc in (((t, n, 4 * h), 0.3), ((h, 4 * h), 0.1),
                          ((n, h), 0.2), ((n, h), 0.2))]


def _gru_data(t, n, h, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))
            for s, sc in (((t, n, 3 * h), 0.3), ((h, 3 * h), 0.1),
                          ((3 * h,), 0.2), ((n, h), 0.2))]


def test_step_wrappers_take_the_plain_versions_on_the_cpu():
    xw, r, h0, c0 = _lstm_data(3, 2, 8, 0)
    before = [f.launches for f in (rnn_step.lstm_step_infer,
                                   rnn_step.gru_step_infer)]
    for g, w in zip(rnn_step.lstm_step_infer(xw, r, h0, c0),
                    lstm.lstm_seq_infer_reference(xw, r, h0, c0)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    fwd = rnn_step.lstm_step_fwd(xw, r, h0, c0)
    dhs = torch.ones(3, 2, 8)
    for g, w in zip(rnn_step.lstm_step_bwd(dhs, h0, c0, fwd[1], fwd[2],
                                           fwd[0], r, h0, c0),
                    lstm.lstm_seq_bwd_reference(dhs, h0, c0, fwd[1], fwd[2],
                                                fwd[0], r, h0, c0)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    xw, r, rb, h0 = _gru_data(3, 2, 8, 1)
    for g, w in zip(rnn_step.gru_step_infer(xw, r, rb, h0),
                    gru.gru_seq_infer_reference(xw, r, rb, h0)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # the CPU runs no kernel, so nothing is counted
    assert before == [f.launches for f in (rnn_step.lstm_step_infer,
                                           rnn_step.gru_step_infer)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,h,persistent", [
    ("lstm_infer", 32, 256, True),   # the char-RNN's shapes stay
    ("lstm_fwd", 32, 256, True),
    ("lstm_bwd", 32, 256, True),
    ("lstm_fwd", 1024, 256, True),
    ("lstm_bwd", 1024, 256, True),
    ("lstm_infer", 1, 512, False),   # TextGenerationLSTM(hidden=512)
    ("lstm_fwd", 32, 512, False),
    ("lstm_bwd", 32, 512, False),
    ("lstm_fwd", 64, 1024, False),
    ("lstm_bwd", 64, 1024, False),
    ("lstm_bwd", 1024, 320, False),  # the backward's limit falls with N
    ("gru_fwd", 64, 1024, True),     # the GRU char-RNN's shapes stay
    ("gru_bwd", 64, 1024, True),
    ("gru_infer", 1, 1024, True),
    ("gru_infer", 1, 2048, False),   # GRU(2048)
    ("gru_fwd", 64, 2048, False),
    ("gru_bwd", 64, 2048, False),
])
def test_cuda_route_by_shape(cuda, kind, n, h, persistent):
    assert rnn_step.takes_persistent(kind, n, h, cuda) is persistent


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["EmbeddingLayer",
                                  "EmbeddingSequenceLayer"])
def test_cuda_embedding_ids_out_of_range(cuda, kind):
    tl = getattr(port_layers, kind)(nIn=4, nOut=3)
    x = IDS[0].astype(np.float32).reshape(1, -1) if kind.endswith(
        "SequenceLayer") else IDS[0].astype(np.float32).reshape(-1, 1)
    w = torch.from_numpy(W)
    got, _ = tl.apply({"W": w.to(cuda)}, (), torch.from_numpy(x).to(cuda))
    want, _ = tl.apply({"W": w}, (), torch.from_numpy(x))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,h", [(7, 5, 512), (5, 64, 1024)])
def test_cuda_lstm_step_route_matches_plain(cuda, t, n, h):
    xw, r, h0, c0 = (a.to(cuda) for a in _lstm_data(t, n, h, 2))
    before = lstm.lstm_seq_fwd.launches, rnn_step.lstm_step_fwd.launches
    hs, gates, cs = lstm.lstm_seq_fwd(xw, r, h0, c0)
    assert (lstm.lstm_seq_fwd.launches, rnn_step.lstm_step_fwd.launches) \
        == (before[0], before[1] + 1)
    for g, w in zip((hs, gates, cs),
                    lstm.lstm_seq_fwd_reference(xw, r, h0, c0)):
        assert float((g - w).abs().max()) < 1e-4
    dhs = torch.ones_like(hs)
    got = lstm.lstm_seq_bwd(dhs, h0, c0, gates, cs, hs, r, h0, c0)
    want = lstm.lstm_seq_bwd_reference(dhs, h0, c0, gates, cs, hs, r, h0,
                                       c0)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
def test_cuda_gru_step_route_matches_plain(cuda):
    xw, r, rb, h0 = (a.to(cuda) for a in _gru_data(5, 8, 2048, 3))
    hs, ru, rzc, cand = gru.gru_seq_fwd(xw, r, rb, h0)
    for g, w in zip((hs, ru, rzc, cand),
                    gru.gru_seq_fwd_reference(xw, r, rb, h0)):
        assert float((g - w).abs().max()) < 1e-4
    dhs = torch.ones_like(hs)
    got = gru.gru_seq_bwd(dhs, h0, ru, rzc, cand, hs, r, h0)
    want = gru.gru_seq_bwd_reference(dhs, h0, ru, rzc, cand, hs, r, h0)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
