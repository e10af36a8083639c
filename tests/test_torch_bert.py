"""The port's BERT (``deeplearning4j_tpu_torch.models.bert``) against the
JAX package's ``deeplearning4j_tpu.models.bert``.

The JAX package draws the parameters; ``bert_params_from_numpy`` carries
them into the port, and both run the same token batches (numpy seeds) on
the CPU at a small size: vocab 97, hidden 32, 2 layers, 4 heads, ffn 64,
T in {16, 24}, B in {2, 3}, float32 compute unless named.

Tolerances (float32 on the CPU; the two frameworks sum in other orders):
- activations, losses: 2e-5 abs / 1e-5 rel (``F32``);
- gradients: 1e-5 abs / 1e-4 rel (``GRAD``);
- three Adam steps: losses 1e-5 rel, moments 1e-5 of each tensor's
  largest, weights 1% of lr * steps (Adam moves a weight by about lr a
  step, and m / sqrt(v) amplifies the rounding of a small gradient);
- bfloat16 compute: 5e-2 abs on the LayerNormed hidden states (values of
  order 1; bf16 keeps 8 bits, and the two frameworks round the matmuls,
  GELU and softmax at other places).

Also: the embedding's out-of-range ids, the ``_attention`` routing table,
dropout's keep rate and scale (statistically), ``mlm_gather`` and
``synthetic_mlm_batch`` equality, and BERT served through ``FnServable``
and ``InferenceSession(device="cpu")``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.parallel import MeshConfig
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.serving import (
    BucketLadder, FnServable, InferenceSession)
from deeplearning4j_tpu_torch.utils.convert import (
    bert_params_from_numpy, bert_params_to_numpy)

SMALL = dict(vocab_size=97, hidden=32, num_layers=2, num_heads=4, ffn=64,
             max_len=32, compute_dtype="float32")
F32 = dict(rtol=1e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and leaves the cores
    to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(**kw):
    opts = {**SMALL, **kw}
    return jbert.BertConfig(**opts), tbert.BertConfig(**opts)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _cfgs()
    tree = _np_tree(jbert.init_params(jcfg, jax.random.key(3)))
    # LayerNorm gains and biases away from 1 and 0, so they are exercised
    rng = np.random.default_rng(5)
    for ln in [tree["emb_ln"]] + [lp[k] for lp in tree["layers"]
                                  for k in ("ln1", "ln2")]:
        ln["g"] = (1 + 0.1 * rng.normal(size=ln["g"].shape)).astype(
            np.float32)
        ln["b"] = (0.1 * rng.normal(size=ln["b"].shape)).astype(np.float32)
    tree["mlm_bias"] = (0.1 * rng.normal(size=tree["mlm_bias"].shape)
                        ).astype(np.float32)
    return tree


def _tokens(b, t, seed, vocab=97):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _t(a, dtype=torch.long):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def test_init_params_on_the_named_cpu_has_the_reference_tree():
    jcfg, tcfg = _cfgs()
    want = _np_tree(jbert.init_params(jcfg, jax.random.key(0)))
    got = tbert.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    leaves = tbert.param_leaves(got)
    assert [tuple(p.shape) for p in leaves] == [
        a.shape for a in jax.tree_util.tree_leaves(want)]
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in leaves)
    # the reference's draws: normal * 0.02 weights, zero biases, unit gains
    assert abs(float(got["tok_emb"].std()) - 0.02) < 2e-3
    assert not got["layers"][0]["qkv_b"].any()
    assert bool((got["emb_ln"]["g"] == 1).all())


def test_params_round_trip(params):
    port = bert_params_from_numpy(params, "cpu")
    back = bert_params_to_numpy(port)
    flat_a = jax.tree_util.tree_leaves(params)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b) == len(tbert.param_leaves(port))
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        bert_params_from_numpy({"tok_emb": params["tok_emb"]}, "cpu")


def test_embed_matches_jax_with_out_of_range_ids(params):
    jcfg, tcfg = _cfgs()
    tokens = _tokens(2, 16, 0)
    tokens[0, :4] = [0, 97 + 5, -1, -200]   # past the end, negative
    types = np.random.default_rng(1).integers(0, 2, (2, 16)).astype(np.int32)
    types[1, :3] = [2, -1, -3]
    want = jbert.embed(_j(params), jcfg, jnp.asarray(tokens), jnp.asarray(types))
    got = tbert.embed(bert_params_from_numpy(params, "cpu"), tcfg,
                      _t(tokens), _t(types))
    _close(got, want, **F32)


@pytest.mark.parametrize("b,t", [(2, 16), (3, 24)])
def test_encoder_layer_matches_jax(params, b, t):
    jcfg, tcfg = _cfgs(attention_impl="dense")
    x = np.random.default_rng(b * t).normal(size=(b, t, 32)).astype(
        np.float32)
    want, _ = jbert.encoder_layer(_j(params)["layers"][0], jnp.asarray(x), jcfg)
    port = bert_params_from_numpy(params, "cpu")
    got, _ = tbert.encoder_layer(port["layers"][0], torch.from_numpy(x),
                                 tcfg)
    _close(got, want, **F32)


@pytest.mark.parametrize("impl", ["dense", "flash", "dpa"])
@pytest.mark.parametrize("b,t", [(2, 16), (3, 24)])
def test_forward_matches_jax(params, impl, b, t):
    """The port's attention routes (flash: the kernel's plain version on
    the CPU) against the reference's dense path."""
    jcfg, tcfg = _cfgs(attention_impl="dense")
    tcfg.attention_impl = impl
    tokens = _tokens(b, t, b + t)
    want = jbert.forward(_j(params), jcfg, jnp.asarray(tokens))
    got = tbert.forward(bert_params_from_numpy(params, "cpu"), tcfg,
                        _t(tokens))
    assert got.shape == (b, t, 32) and got.dtype == torch.float32
    _close(got, want, **F32)


def test_bf16_forward_matches_jax(params):
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16", attention_impl="dense")
    tokens = _tokens(2, 16, 7)
    want = np.asarray(jbert.forward(_j(params), jcfg, jnp.asarray(tokens)),
                      np.float32)
    port = bert_params_from_numpy(params, "cpu")
    for impl in ("dense", "flash"):
        tcfg.attention_impl = impl
        got = tbert.forward(port, tcfg, _t(tokens))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=BF16_ATOL)


def _mlm_inputs(b, t, seed):
    jcfg, _ = _cfgs()
    tokens, labels = jbert.synthetic_mlm_batch(jcfg, b, t, seed=seed)
    pos, lab, w = jbert.mlm_gather(labels,
                                   max_preds=jbert.mlm_max_preds(t))
    w[0, -1] = 0.0   # a padded slot
    return tokens, labels, pos, lab, w


def test_mlm_losses_match_jax(params):
    jcfg, tcfg = _cfgs()
    tokens, labels, pos, lab, w = _mlm_inputs(3, 24, 11)
    port = bert_params_from_numpy(params, "cpu")
    want = jbert.mlm_loss(_j(params), jcfg, jnp.asarray(tokens),
                          jnp.asarray(labels), deterministic=True)
    got = tbert.mlm_loss(port, tcfg, _t(tokens), _t(labels),
                         deterministic=True)
    _close(got, want, **F32)
    want = jbert.mlm_loss_masked(_j(params), jcfg, jnp.asarray(tokens),
                                 jnp.asarray(pos), jnp.asarray(lab),
                                 jnp.asarray(w), deterministic=True)
    got = tbert.mlm_loss_masked(port, tcfg, _t(tokens), _t(pos), _t(lab),
                                _t(w, torch.float32), deterministic=True)
    _close(got, want, **F32)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_gradients_match_jax(params, impl):
    """jax.grad of the masked-LM loss against autograd, every parameter
    (the tied tok_emb sums the gather's part and the LM head's)."""
    jcfg, tcfg = _cfgs(attention_impl=impl)
    jcfg.attention_impl = "dense"
    tokens, _, pos, lab, w = _mlm_inputs(2, 16, 13)
    want = jax.grad(jbert.mlm_loss_masked)(
        _j(params), jcfg,
        jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(lab),
        jnp.asarray(w), deterministic=True)
    port = bert_params_from_numpy(params, "cpu")
    leaves = tbert.param_leaves(port)
    for p in leaves:
        p.requires_grad_(True)
    loss = tbert.mlm_loss_masked(port, tcfg, _t(tokens), _t(pos), _t(lab),
                                 _t(w, torch.float32), deterministic=True)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    want_leaves = tbert.param_leaves(_np_tree(want))
    assert len(want_leaves) == len(grads)
    for g, wv in zip(grads, want_leaves):
        _close(g, wv, **GRAD)


def test_trainer_three_steps_match_jax():
    """BertTrainer, 3 Adam steps with dropout 0 from the same weights."""
    jcfg, tcfg = _cfgs(dropout=0.0, attention_impl="dense")
    tcfg.attention_impl = "flash"
    mesh = MeshConfig(data=1, devices=jax.devices()[:1]).build()
    jt = jbert.BertTrainer(jcfg, mesh, lr=1e-3, seed=0)
    tt = tbert.BertTrainer(tcfg, lr=1e-3, device="cpu",
                           params=bert_params_from_numpy(
                               _np_tree(jt.params), "cpu"))
    tokens, labels = jbert.synthetic_mlm_batch(jcfg, 2, 16, seed=17)
    for step in range(3):
        want = float(jt.train_step(tokens, labels))
        got = float(tt.train_step(tokens, labels))
        assert abs(got - want) <= 1e-5 * abs(want), (step, got, want)
    jleaves = tbert.param_leaves(_np_tree(jt.params))
    for p, wv in zip(tt._leaves, jleaves):
        np.testing.assert_allclose(p.numpy(), wv, rtol=0, atol=1e-2 * 1e-3 * 3)
    for key in ("m", "v"):
        for mv, wv in zip(tt.opt[key],
                          tbert.param_leaves(_np_tree(jt.opt[key]))):
            scale = max(float(np.abs(wv).max()), 1e-30)
            np.testing.assert_allclose(mv.numpy(), wv, rtol=0,
                                       atol=1e-5 * scale)
    losses = tt.train_steps(np.stack([tokens] * 2), np.stack([labels] * 2))
    assert losses.shape == (2,) and torch.isfinite(losses).all()


def test_mlm_gather_and_synthetic_batch_equal():
    jcfg, tcfg = _cfgs()
    for b, t, seed in ((2, 16, 0), (3, 24, 4)):
        want = jbert.synthetic_mlm_batch(jcfg, b, t, seed=seed)
        got = tbert.synthetic_mlm_batch(tcfg, b, t, seed=seed)
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g, wv)
            assert g.dtype == wv.dtype
        for mp in (None, jbert.mlm_max_preds(t), 2):
            for g, wv in zip(tbert.mlm_gather(want[1], mp),
                             jbert.mlm_gather(want[1], mp)):
                np.testing.assert_array_equal(g, wv)
    assert tbert.mlm_max_preds(512) == jbert.mlm_max_preds(512) == 77


@pytest.mark.parametrize("impl,t,device,route", [
    ("auto", 512, "cuda", "dense"),
    ("auto", 1024, "cuda", "dense"),
    ("auto", 2048, "cuda", "flash"),
    ("auto", 1100, "cuda", "dense"),    # not a multiple of 128
    ("auto", 2048, "cpu", "dense"),
    ("flash", 512, "cuda", "flash"),
    ("flash", 24, "cpu", "flash"),
    ("dpa", 512, "cuda", "dpa"),
    ("dense", 4096, "cuda", "dense"),
])
def test_attention_routing_table(impl, t, device, route):
    assert tbert.attention_route(tbert.BertConfig(attention_impl=impl), t,
                                 device) == route


def test_dropout_keep_rate_and_scale():
    """The reference's bits cannot be reproduced; its keep rate
    (round((1 - p) 65536) / 65536) and 1/(1 - p) scale can."""
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(400_000)
    for rate in (0.1, 0.5):
        y = tbert._dropout(x, rate, gen)
        kept = y != 0
        keep = round((1 - rate) * 65536) / 65536
        sd = math.sqrt(keep * (1 - keep) / x.numel())
        assert abs(kept.float().mean().item() - keep) < 5 * sd
        torch.testing.assert_close(y[kept], torch.full_like(
            y[kept], 1 / (1 - rate)))


def test_fn_servable_serves_bert_through_session(params):
    """BERT's forward served from [N, T] token ids held as floats, over a
    batch-only ladder: padded rows never move real ones."""
    jcfg, tcfg = _cfgs(attention_impl="flash")
    jcfg.attention_impl = "dense"
    port = bert_params_from_numpy(params, "cpu")

    def encode(x):
        return tbert.forward(port, tcfg, x.long()).float()

    servable = FnServable(encode, (16,), device="cpu")
    requests = [_tokens(n, 16, 30 + n).astype(np.float32)
                for n in (1, 3, 2, 5)]
    want = np.asarray(jbert.forward(_j(params), jcfg, jnp.asarray(
        np.concatenate(requests), jnp.int32)))
    with InferenceSession(device="cpu", max_latency=0.01) as session:
        session.register("bert", servable, ladder=BucketLadder((1, 2, 4)),
                         warmup=True)
        assert session.ready()
        row = 0
        for x in requests:
            got = session.predict("bert", x)
            assert got.shape == (x.shape[0], 16, 32)
            _close(got, want[row:row + x.shape[0]], **F32)
            row += x.shape[0]


def test_entry_points_need_cuda_or_the_cpu_named():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbert.BertTrainer(tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbert.init_params(tcfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FnServable(lambda x: x, (16,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbert.init_params(tbert.BertConfig(n_experts=2),
                          torch.Generator())
