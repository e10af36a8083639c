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
  largest element backward), also past one row tile (N = 65, 130), at a
  width that is not a multiple of the units (520) or of 4 (33, 130) and
  at N = 1, with the backward's bits repeated.
- The step kernels' launch plan: ``kernels/rnn_step.py`` ``step_plan``
  mirrors the source's ``rnn_step_plan`` (asked on the card); on the CPU,
  over a grid of (N, H) at 132 SMs, the plan's threads cover its tile,
  its cluster ranks cover the reduction, two blocks fit an SM's shared
  memory, and ``step_cells`` (which block finalises which cell) covers
  every (n, j) cell exactly once.
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
    ("lstm_bwd", 18, 423, True),
    ("lstm_bwd", 19, 423, False),
    ("lstm_bwd", 1024, 431, False),
    ("lstm_infer", 1024, 431, True),  # the forward's does not, to 448
    ("lstm_fwd", 1024, 448, True),
    ("lstm_fwd", 1, 449, False),
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


PLAN_NS = [1, 5, 64, 65, 130]
PLAN_HS = [33, 512, 520, 1024, 2048]
SMS = 132
SMEM_PER_SM = 233472   # bytes of shared memory an H100 SM gives its blocks


@pytest.mark.parametrize("hsz", PLAN_HS)
@pytest.mark.parametrize("n", PLAN_NS)
@pytest.mark.parametrize("kind", rnn_step.STEP_KINDS)
@pytest.mark.parametrize("cell", rnn_step.STEP_CELLS)
def test_step_plan_covers_every_cell_once(cell, kind, n, hsz):
    plan = rnn_step.step_plan(cell, kind, n, hsz, SMS)
    g = 4 if cell == "lstm" else 3
    k = g * hsz if kind == "bwd" else hsz
    cols = plan["units"] * (1 if kind == "bwd" else g)
    assert plan["blocks"] == -(-hsz // plan["units"]) * plan["cluster"]
    assert plan["blocks"] <= SMS and plan["cluster"] in (1, 2, 4)
    # the ranks' k ranges cover the reduction, in whole chunks of 64
    assert plan["k_per_rank"] % 64 == 0
    assert plan["cluster"] * plan["k_per_rank"] >= k
    assert (plan["cluster"] - 1) * plan["k_per_rank"] < k
    # row tiles of at most 64 cover the batch; the threads cover a tile
    assert plan["rows"] <= 64 and plan["tiles"] * plan["rows"] >= n
    assert (plan["tiles"] - 1) * plan["rows"] < n
    assert plan["row_threads"] * plan["rows_per_thread"] >= plan["rows"]
    assert plan["col_threads"] * 4 == cols
    assert plan["threads"] == (plan["row_threads"] * plan["col_threads"]
                               * plan["splits"]) <= (
        256 if kind == "bwd" else 384)
    assert 16 % plan["splits"] == 0 and plan["stages"] in (2, 3)
    # a block fits an SM (1 KB reserved per block); two stages only where
    # they let two blocks of at most 256 threads share one
    assert plan["smem_bytes"] + 1024 <= SMEM_PER_SM
    if plan["stages"] == 2:
        assert plan["threads"] <= 256
        assert 2 * (plan["smem_bytes"] + 1024) <= SMEM_PER_SM
    cells = rnn_step.step_cells(plan, n, hsz).flatten()
    cells = cells[cells >= 0]
    assert torch.equal(torch.bincount(cells, minlength=n * hsz),
                       torch.ones(n * hsz, dtype=torch.long))


@pytest.mark.parametrize("cell,kind,n,hsz,units,cluster", [
    ("gru", "infer", 64, 2048, 32, 2),    # R once a step, 128 blocks
    ("gru", "fwd", 1, 2048, 32, 2),
    ("gru", "bwd", 64, 2048, 64, 4),
    ("lstm", "infer", 32, 512, 16, 4),
    ("lstm", "bwd", 32, 512, 16, 4),
    ("lstm", "fwd", 64, 1024, 16, 2),    # the smaller cluster
    ("lstm", "bwd", 64, 1024, 32, 4),
])
def test_step_plan_fills_the_card_at_the_report_shapes(cell, kind, n, hsz,
                                                       units, cluster):
    plan = rnn_step.step_plan(cell, kind, n, hsz, SMS)
    assert (plan["units"], plan["cluster"], plan["blocks"]) == (
        units, cluster, 128)
    assert plan["tiles"] == 1 and plan["rows"] == n


def test_step_plan_follows_the_sm_count():
    small = rnn_step.step_plan("gru", "fwd", 64, 2048, 66)
    assert small["blocks"] <= 66
    wide = rnn_step.step_plan("gru", "fwd", 64, 8192, SMS)   # > one wave
    assert (wide["units"], wide["cluster"], wide["blocks"]) == (32, 1, 256)


@pytest.mark.parametrize("args", [("rnn", "fwd", 1, 8, 132),
                                  ("gru", "train", 1, 8, 132),
                                  ("lstm", "fwd", 0, 8, 132),
                                  ("lstm", "bwd", 1, 0, 132),
                                  ("gru", "infer", 1, 8, 0)])
def test_step_plan_refuses_what_the_source_refuses(args):
    with pytest.raises(ValueError):
        rnn_step.step_plan(*args)


def test_step_source_plan_asks_the_source(asked):
    dev = torch.device("cuda", 0)
    got = rnn_step.step_source_plan("gru", "bwd", 64, 2048, 132, dev)
    (name, entry, args, device), = asked
    assert (name, entry, args[:5], device) == (
        "rnn_step", "rnn_step_plan", [1, 2, 64, 2048, 132], dev)
    assert args[5].dtype == torch.int32 and args[5].numel() == len(
        rnn_step.PLAN_FIELDS)
    assert got == dict.fromkeys(rnn_step.PLAN_FIELDS, 0)
    asked.rc = -3
    with pytest.raises(ValueError):
        rnn_step.step_source_plan("gru", "bwd", 0, 2048, 132, dev)


# (cell, T, N, H): more than one row tile, a width that is not a multiple
# of the units or of 4, N = 1 at H = 2048
EDGE_SHAPES = [("lstm", 6, 65, 520), ("gru", 6, 65, 520),
               ("lstm", 5, 130, 512), ("gru", 5, 130, 520),
               ("lstm", 4, 1, 2048), ("gru", 4, 1, 2048),
               ("lstm", 7, 5, 33), ("gru", 7, 3, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,t,n,h", EDGE_SHAPES)
def test_cuda_step_kernels_at_the_edges(cuda, cell, t, n, h):
    mod = lstm if cell == "lstm" else gru
    if cell == "lstm":
        xw, r, h0, c0 = (a.to(cuda) for a in _lstm_data(t, n, h, 4))
        state = (h0, c0)
    else:
        xw, r, rb, h0 = (a.to(cuda) for a in _gru_data(t, n, h, 5))
        state = (rb, h0)
    infer, fwd, bwd = (getattr(rnn_step, f"{cell}_step_{k}")
                       for k in ("infer", "fwd", "bwd"))
    with torch.no_grad():
        got = infer(xw, r, *state)
    for g, w in zip(got, getattr(mod, f"{cell}_seq_infer_reference")(
            xw, r, *state)):
        assert float((g - w).abs().max()) < 1e-4
    out = fwd(xw, r, *state)
    for g, w in zip(out, getattr(mod, f"{cell}_seq_fwd_reference")(
            xw, r, *state)):
        assert float((g - w).abs().max()) < 1e-4
    dhs = torch.linspace(-1, 1, out[0].numel(), device=cuda).reshape(
        out[0].shape)
    args = (dhs, h0, c0, out[1], out[2], out[0], r, h0, c0) if \
        cell == "lstm" else (dhs, h0, *out[1:], out[0], r, h0)
    got = bwd(*args)
    again = bwd(*args)
    for g, w in zip(got, getattr(mod, f"{cell}_seq_bwd_reference")(*args)):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("cell,t,n,h", EDGE_SHAPES)
def test_cuda_step_plan_matches_the_source(cuda, cell, t, n, h):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kind in rnn_step.STEP_KINDS:
        assert rnn_step.step_source_plan(cell, kind, n, h, sms, cuda) == \
            rnn_step.step_plan(cell, kind, n, h, sms)
