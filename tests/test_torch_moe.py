"""The port's Mixture-of-Experts against the JAX package's, on the CPU.

- ``parallel/moe.py``: ``moe_apply``'s output, aux loss and gradients (the
  params and x) against ``jax.grad`` of the reference at N = 64, H = 16,
  F = 32, E = 4, k = 1 and 2, at a capacity factor that drops tokens and
  one that drops none, to 1e-5 of each array's largest element (but
  k = 1's dgate_w: with one choice the weight p / p has an exactly-zero
  gradient that float32 leaves as noise, ~2-4e-5 of dgate_w's largest,
  in both packages; so the port's distance from the float64 gradient is
  held to at most twice the reference's, never tighter than 1e-5); exact
  ties routed as ``jax.lax.top_k`` routes them; gating in float32 for a
  float32 or bf16 gate and in float64 for a float64 tree;
  ``moe_param_specs``;
  ``MoELayerTrainer`` on a data=2 x expert=4 mesh against the reference's
  (the loss curve to the reference's own rtol=2e-3, atol=2e-4).
- ``MoELayer``: JSON both ways, output and gradients, fit from the same
  state with the aux loss in the objective (losses to 1e-5 relative,
  params and updater state to 1e-4), ``_aux_loss`` set only in training,
  zips in both directions, ``params_from_numpy`` and
  ``opt_states_*``, ``paramTable``/``numParams``/``summary``.
- BERT with MoE layers (vocab 64, hidden 16, 2 layers, 2 heads, ffn 32,
  E = 4): ``forward_with_aux``, both MLM losses and the gradients against
  the reference; three ``BertTrainer`` steps against the reference's on a
  one-device mesh and on a data=2 x expert=2 mesh; the gate params train.
- ``cuda`` cases hold ``moe_apply`` and a MoE ``BertTrainer`` step on the
  card against their CPU twins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as J
from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.optimize import updaters as JU
from deeplearning4j_tpu.parallel import moe as jmoe
from deeplearning4j_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from deeplearning4j_tpu.utils.serializer import (
    ModelSerializer as JaxSerializer)
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.nn.conf.layers_extra import MoELayer
from deeplearning4j_tpu_torch.parallel import moe as tmoe
from deeplearning4j_tpu_torch.parallel.mesh import MeshConfig
from deeplearning4j_tpu_torch.utils import ModelSerializer
from deeplearning4j_tpu_torch.utils.convert import (
    bert_params_from_numpy, opt_states_from_numpy, opt_states_to_numpy,
    params_from_numpy)
from torch_parity import (
    FN_RTOL, TRAIN_RTOL, as_torch, check_layer, close, compare_trees,
    leaves, net_pair, sync, to_np)

cuda = pytest.mark.cuda
N, H, F, E = 64, 16, 32, 4
CURVE = dict(rtol=2e-3, atol=2e-4)   # the reference's multi-step rule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _params(seed=0, e=E):
    return to_np(jmoe.moe_init(jax.random.key(seed), H, F, e))


def _x(seed=0, n=N):
    return np.random.default_rng(seed).normal(size=(n, H)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _gate_grad_f64(params, x, r, k, cf):
    """dgate_w of sum(y * r) + 3 aux with the whole function in float64
    (the port's pieces, gating included)."""
    d = torch.float64
    tp = {kk: torch.tensor(v, dtype=d, requires_grad=True)
          for kk, v in params.items()}
    tx = torch.tensor(x, dtype=d)
    route = tmoe.moe_route(tp["gate_w"], tx, k, cf)
    y = tmoe.moe_experts(tp, *tmoe.moe_dispatch(route, E, d), tx)
    loss = (y * torch.tensor(r, dtype=d)).sum() + 3.0 * route.aux
    return torch.autograd.grad(loss, tp["gate_w"])[0].numpy()


@pytest.mark.parametrize("k,cf,drops", [(1, 0.5, True), (2, 0.5, True),
                                        (1, 4.0, False), (2, 4.0, False)])
def test_moe_apply_matches_jax_grad(k, cf, drops):
    """Output, aux and the gradients of sum(y * r) + 3 aux with respect to
    every param and x."""
    params, x = _params(1), _x(2)
    r = np.random.default_rng(3).normal(size=(N, H)).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, k=k, capacity_factor=cf)
        return jnp.sum(y * r) + 3.0 * aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = {kk: v.requires_grad_() for kk, v in as_torch(params).items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, taux = tmoe.moe_apply(tp, tx, k=k, capacity_factor=cf)
    grads = torch.autograd.grad((ty * torch.tensor(r)).sum() + 3.0 * taux,
                                list(tp.values()) + [tx])
    close(to_np(ty), np.asarray(jy), FN_RTOL, "y")
    close(float(taux.detach()), float(jaux), FN_RTOL, "aux")
    for (name, _), g in zip(tp.items(), grads[:-1]):
        if k == 1 and name == "gate_w":
            continue
        close(to_np(g), np.asarray(jgp[name]), FN_RTOL, f"d{name}")
    close(to_np(grads[-1]), np.asarray(jgx), FN_RTOL, "dx")
    if k == 1:
        # with one choice the renormalised weight is p / p = 1, whose
        # gradient is 0 in exact arithmetic and float32 rounding noise in
        # both packages (measured ~2-4e-5 of dgate_w's largest element
        # from the float64 value in each); so dgate_w is held to that
        # value: the port's distance at most twice the reference's, never
        # tighter than 1e-5
        exact = _gate_grad_f64(params, x, r, k, cf)
        scale = np.abs(exact).max()
        port_err = np.abs(to_np(grads[0]) - exact).max() / scale
        ref_err = np.abs(np.asarray(jgp["gate_w"]) - exact).max() / scale
        assert port_err <= max(2 * ref_err, FN_RTOL), (port_err, ref_err)
    route = tmoe.moe_route(tp["gate_w"], tx, k, cf)
    assert route.capacity == int(np.ceil(k * N / E * cf))
    assert (int(route.dropped) > 0) == drops


@pytest.mark.parametrize("gate,probs", [("float32", "float32"),
                                        ("bfloat16", "float32"),
                                        ("float64", "float64")])
def test_gating_dtype_follows_gate_w(gate, probs):
    """Gating runs in float32 for a float32 or bf16 gate_w (the reference's
    astype(float32)) and in float64 for a float64 tree; the outputs and
    aux agree with the reference's on the same gate values."""
    params, x = _params(6), _x(7)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    if gate == "bfloat16":   # (a float64 tree is float32 in JAX without x64)
        jp["gate_w"] = jp["gate_w"].astype(jnp.bfloat16)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), k=2, capacity_factor=1.0)
    dt = torch.float64 if gate == "float64" else torch.float32
    tp = {kk: torch.tensor(v, dtype=dt) for kk, v in params.items()}
    tp["gate_w"] = tp["gate_w"].to(getattr(torch, gate))
    tx = torch.tensor(x, dtype=dt)
    assert tmoe.moe_route(tp["gate_w"], tx).probs.dtype == getattr(
        torch, probs)
    ty, taux = tmoe.moe_apply(tp, tx, k=2, capacity_factor=1.0)
    assert ty.dtype == dt
    close(ty.float().numpy(), np.asarray(jy), FN_RTOL, gate)
    close(float(taux), float(jaux), FN_RTOL, f"{gate} aux")


@pytest.mark.parametrize("tie", ["uniform", "paired"])
def test_ties_route_as_jax_top_k(tie):
    """Equal probabilities go to the lower expert index first, as
    jax.lax.top_k orders them: a zero gate (every expert tied) and a gate
    whose columns repeat in pairs."""
    params, x = _params(4), _x(5)
    if tie == "uniform":
        params["gate_w"] = np.zeros_like(params["gate_w"])
    else:
        params["gate_w"][:, 1] = params["gate_w"][:, 0]
        params["gate_w"][:, 3] = params["gate_w"][:, 2]
    for k in (1, 2):
        jy, jaux = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray,
                                                         params),
                                  jnp.asarray(x), k=k, capacity_factor=1.0)
        ty, taux = tmoe.moe_apply(as_torch(params), torch.tensor(x), k=k,
                                  capacity_factor=1.0)
        close(to_np(ty), np.asarray(jy), FN_RTOL, f"{tie} k={k}")
        close(float(taux), float(jaux), FN_RTOL, f"{tie} k={k} aux")
    route = tmoe.moe_route(torch.tensor(params["gate_w"]), torch.tensor(x),
                           2, 1.0)
    # every token's two choices are a tied pair, the lower index first
    assert bool((route.topk_i[:, 0] + 1 == route.topk_i[:, 1]).all())
    if tie == "uniform":
        assert bool((route.topk_i[:, 0] == 0).all())


def test_moe_init_and_specs_match_the_reference():
    gen = torch.Generator().manual_seed(0)
    got = tmoe.moe_init(gen, H, F, E, device="cpu")
    want = _params()
    assert {kk: tuple(v.shape) for kk, v in got.items()} == {
        kk: v.shape for kk, v in want.items()}
    assert abs(float(got["w1"].std()) * np.sqrt(H) - 1) < 0.05
    assert not got["b1"].any() and not got["b2"].any()
    assert tmoe.moe_param_specs() == {
        kk: tuple(s) for kk, s in jmoe.moe_param_specs().items()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmoe.moe_init(gen, H, F, E)


def test_moe_layer_trainer_matches_jax_on_dp2_ep4():
    jmesh = JaxMeshConfig(data=2, expert=4, devices=jax.devices()).build()
    mesh = MeshConfig(data=2, expert=4, devices=["cpu"] * 8).build()
    jt = jmoe.MoELayerTrainer(jmesh, hidden=H, ffn=F, n_experts=E, lr=5e-2,
                              seed=0)
    tt = tmoe.MoELayerTrainer(mesh, hidden=H, ffn=F, n_experts=E, lr=5e-2,
                              params=as_torch(to_np(jt.params)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, H)).astype(np.float32)
    y = rng.normal(size=(32, H)).astype(np.float32)
    want = [float(jt.train_step(x, y)) for _ in range(5)]
    got = [float(tt.train_step(x, y)) for _ in range(5)]
    np.testing.assert_allclose(got, want, **CURVE)
    assert got[-1] < got[0]
    compare_trees(tt.params, jt.params, 1e-3, "params after 5 steps")


# ---------------------------------------------------------------------------
# MoELayer in a MultiLayerNetwork
# ---------------------------------------------------------------------------

def _moe_conf(aux_weight=0.5, k=2, cf=1.5, updater=None):
    return (J.NeuralNetConfiguration.Builder().seed(1)
            .updater(updater or JU.Adam(5e-3)).list()
            .layer(J.DenseLayer.Builder(nOut=16, activation="relu").build())
            .layer(J.MoELayer.Builder().nOut(12).ffnSize(32).nExperts(4)
                   .topK(k).capacityFactor(cf).auxWeight(aux_weight)
                   .build())
            .layer(J.OutputLayer.Builder().nOut(3).activation("softmax")
                   .build())
            .setInputType(J.InputType.feedForward(8))
            .build())


def _cls_batch(seed, n=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 8)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def test_moe_layer_json_output_and_gradients():
    port, jnet = net_pair(_moe_conf(), 0)   # JSON asserted equal both ways
    layer = port.layers[1]
    assert isinstance(layer, MoELayer)
    assert (layer.nIn, layer.nOut, layer.ffnSize) == (16, 12, 32)
    assert layer.param_shapes() == {kk: tuple(np.shape(v)) for kk, v in
                                    jnet._params[1].items()}
    x = np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32)
    check_layer(jnet.layers[1], layer, to_np(port._params[1]), x,
                to_np(port._states[1]), training=True)
    xb, _ = _cls_batch(1)
    close(port.output(xb).toNumpy(), np.asarray(jnet.output(xb).numpy()))


@pytest.mark.parametrize("k,cf", [(2, 1.5), (1, 0.5)])
def test_moe_layer_fit_matches_the_reference(k, cf):
    """Three Adam steps, each from the same state: the training loss
    (with auxWeight 0.5 x aux in it), params and updater state."""
    port, jnet = net_pair(_moe_conf(0.5, k, cf), 2)
    for step in range(3):
        x, y = _cls_batch(10 + step)
        sync(port, jnet)
        port.fit((x, y))
        jnet.fit((x, y))
        assert abs(port.score() - jnet.score()) <= FN_RTOL * abs(
            jnet.score()), (step, port.score(), jnet.score())
        compare_trees([port._params, port._opt_states],
                      [jnet._params, jnet._opt_states], TRAIN_RTOL,
                      f"step {step}", TRAIN_RTOL * 1e-4)
        close(float(port._states[1]["_aux_loss"]),
              float(jnet._states[1]["_aux_loss"]), FN_RTOL, "aux state")


def test_aux_loss_is_in_the_objective_and_only_in_training():
    x, y = _cls_batch(3)
    on, _ = net_pair(_moe_conf(0.5), 4)
    off, _ = net_pair(_moe_conf(0.0), 4)
    assert float(on._states[1]["_aux_loss"]) == 0.0
    on.output(x)
    assert float(on._states[1]["_aux_loss"]) == 0.0   # inference: unset
    s_on, s_off = on.score((x, y)), off.score((x, y))
    assert s_on == pytest.approx(s_off, rel=1e-6)      # score: no aux
    on.fit((x, y))
    off.fit((x, y))
    aux = float(on._states[1]["_aux_loss"])
    assert aux > 0.0 and float(off._states[1]["_aux_loss"]) == 0.0
    # the training loss differs by the aux term, and so do the gate's
    # updates
    assert on.score() == pytest.approx(off.score() + aux, rel=1e-5)
    assert float((on._params[1]["gate_w"] - off._params[1]["gate_w"])
                 .abs().max()) > 0


def test_moe_layer_zips_both_ways_and_param_api(tmp_path):
    port, jnet = net_pair(_moe_conf(), 5)
    x, y = _cls_batch(6)
    port.fit((x, y))
    path = str(tmp_path / "port.zip")
    ModelSerializer.writeModel(port, path)
    back = JaxSerializer.restoreMultiLayerNetwork(path)
    compare_trees([back._params, back._states, back._opt_states],
                  [port._params, port._states, port._opt_states], 0.0,
                  "port -> JAX")
    close(np.asarray(back.output(x).numpy()), port.output(x).toNumpy())
    again = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    compare_trees([again._params, again._states, again._opt_states],
                  [port._params, port._states, port._opt_states], 0.0,
                  "port -> port")
    jnet.fit((x, y))
    jpath = str(tmp_path / "jax.zip")
    JaxSerializer.writeModel(jnet, jpath)
    got = ModelSerializer.restoreMultiLayerNetwork(jpath, device="cpu")
    compare_trees([got._params, got._states, got._opt_states],
                  [jnet._params, jnet._states, jnet._opt_states], 0.0,
                  "JAX -> port")
    # the numpy carriers take the layer's params and updater state
    conf = port.conf
    compare_trees(params_from_numpy(conf, to_np(jnet._params), "cpu"),
                  jnet._params, 0.0, "params_from_numpy")
    ost = opt_states_from_numpy(conf, to_np(jnet._opt_states), "cpu")
    compare_trees(opt_states_to_numpy(ost), jnet._opt_states, 0.0,
                  "opt_states both ways")
    table = port.paramTable()
    assert sorted(k for k in table if k.startswith("1_")) == sorted(
        f"1_{kk}" for kk in jnet._params[1])
    assert port.numParams() == sum(np.size(v) for _, v in
                                   leaves(to_np(jnet._params)))
    assert "MoELayer" in port.summary()


# ---------------------------------------------------------------------------
# BERT with MoE layers
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=64, hidden=16, num_layers=2, num_heads=2, ffn=32,
             max_len=32, dropout=0.0, compute_dtype="float32", n_experts=4)


def _cfgs(**kw):
    opts = {**SMALL, **kw}
    return jbert.BertConfig(**opts), tbert.BertConfig(**opts)


@pytest.fixture(scope="module")
def moe_params():
    jcfg, _ = _cfgs()
    return to_np(jbert.init_params(jcfg, jax.random.key(3)))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _batch(seed, b=4, t=16):
    jcfg, _ = _cfgs()
    tokens, labels = jbert.synthetic_mlm_batch(jcfg, b, t, seed=seed)
    pos, lab, w = jbert.mlm_gather(labels, max_preds=jbert.mlm_max_preds(t))
    return tokens, labels, pos, lab, w


def test_bert_moe_forward_losses_and_gradients_match_jax(moe_params):
    jcfg, tcfg = _cfgs()
    port = bert_params_from_numpy(moe_params, "cpu")
    assert set(port["layers"][0]["moe"]) == {"gate_w", "w1", "b1", "w2",
                                            "b2"}
    tokens, labels, pos, lab, w = _batch(0)
    jhs, jaux = jbert.forward_with_aux(_j(moe_params), jcfg,
                                       jnp.asarray(tokens))
    ths, taux = tbert.forward_with_aux(port, tcfg, torch.tensor(tokens))
    close(to_np(ths), np.asarray(jhs), FN_RTOL, "hidden states")
    close(float(taux), float(jaux), FN_RTOL, "aux")
    assert float(taux) > 0
    want = jbert.mlm_loss(_j(moe_params), jcfg, jnp.asarray(tokens),
                          jnp.asarray(labels), deterministic=True)
    got = tbert.mlm_loss(port, tcfg, torch.tensor(tokens),
                         torch.tensor(labels), deterministic=True)
    close(float(got), float(want), FN_RTOL, "mlm_loss")
    args = [jnp.asarray(a) for a in (tokens, pos, lab, w)]
    want_g = jax.grad(jbert.mlm_loss_masked)(_j(moe_params), jcfg, *args,
                                             deterministic=True)
    leaves_ = tbert.param_leaves(port)
    for p in leaves_:
        p.requires_grad_(True)
    loss = tbert.mlm_loss_masked(port, tcfg, *[torch.tensor(a) for a in
                                               (tokens, pos, lab, w)],
                                 deterministic=True)
    close(float(loss), float(jbert.mlm_loss_masked(
        _j(moe_params), jcfg, *args, deterministic=True)), FN_RTOL,
        "mlm_loss_masked")
    grads = torch.autograd.grad(loss, leaves_, materialize_grads=True)
    for g, wv in zip(grads, tbert.param_leaves(to_np(want_g))):
        close(to_np(g), wv, FN_RTOL, "gradient")
    # the loss minus its MLM part is moe_aux_weight * aux
    noaux = tbert.mlm_loss_masked(port, dataclasses.replace(
        tcfg, moe_aux_weight=0.0), *[torch.tensor(a) for a in
                                     (tokens, pos, lab, w)],
        deterministic=True)
    close(float(loss - noaux), tcfg.moe_aux_weight * float(taux), 1e-4,
          "aux part of the loss")


@pytest.mark.parametrize("shape", [dict(data=1), dict(data=2, expert=2)],
                         ids=["one_device", "dp2_ep2"])
def test_bert_moe_trainer_matches_jax(shape):
    """Three Adam steps from the reference's weights; the gate trains."""
    jcfg, tcfg = _cfgs()
    n = int(np.prod(list(shape.values())))
    jt = jbert.BertTrainer(jcfg, JaxMeshConfig(
        **shape, devices=jax.devices()[:n]).build(), lr=1e-3, seed=3)
    mesh = MeshConfig(**shape, devices=["cpu"] * n).build()
    tt = tbert.BertTrainer(tcfg, lr=1e-3, mesh=mesh,
                           params=bert_params_from_numpy(to_np(jt.params),
                                                         "cpu"))
    assert tt.device.type == "cpu"
    g0 = to_np(tt.params["layers"][0]["moe"]["gate_w"])
    tokens, labels, *_ = _batch(7, b=8)
    want = [float(jt.train_step(tokens, labels)) for _ in range(3)]
    got = [float(tt.train_step(tokens, labels)) for _ in range(3)]
    np.testing.assert_allclose(got, want, **CURVE)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.abs(to_np(tt.params["layers"][0]["moe"]["gate_w"])
                  - g0).max() > 0
    compare_trees(tt.params, jt.params, 1e-3, "params after 3 steps")


def test_bert_moe_param_specs_and_mesh_rules():
    jcfg, tcfg = _cfgs()

    def as_tuples(tree):
        if isinstance(tree, dict):
            return {k: as_tuples(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [as_tuples(v) for v in tree]
        return tuple(tree)

    specs = jbert.param_specs(jcfg)
    want = {k: as_tuples(v) if k != "layers" else
            [{kk: as_tuples(vv) if not hasattr(vv, "items") else
              {a: tuple(b) for a, b in vv.items()} for kk, vv in lp.items()}
             for lp in v] for k, v in specs.items()}
    assert tbert.param_specs(tcfg) == want
    dense = dataclasses.replace(tcfg, n_experts=0)
    assert "ffn_in_w" in tbert.param_specs(dense)["layers"][0]
    # a seq or model axis at one process builds: seq runs ring attention,
    # model lays the specs out in name only
    for axes in (dict(data=1, seq=2), dict(data=1, model=2)):
        mesh = MeshConfig(**axes, devices=["cpu"] * 2).build()
        trainer = tbert.BertTrainer(tcfg, mesh=mesh)
        assert trainer.device.type == "cpu"
        assert trainer.param_specs["layers"][0]["qkv_w"] == (
            (None, "model") if "model" in axes else (None, None))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@cuda
def test_cuda_moe_apply_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    gen = torch.Generator().manual_seed(0)
    params = tmoe.moe_init(gen, 64, 128, 8, device="cpu")
    x = torch.randn((512, 64), generator=gen)
    for k, cf in ((1, 0.5), (2, 1.5)):
        y, aux = tmoe.moe_apply(params, x, k=k, capacity_factor=cf)
        yc, auxc = tmoe.moe_apply(as_torch(to_np(params), "cuda"),
                                  x.cuda(), k=k, capacity_factor=cf)
        close(to_np(yc), to_np(y), 1e-5, f"k={k}")
        close(float(auxc), float(aux), 1e-5, "aux")


@cuda
def test_cuda_moe_bert_step_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    # the flash kernels take head sizes 64 and 128
    _, tcfg = _cfgs(attention_impl="flash", hidden=128, ffn=256)
    tree = tbert.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    cpu = tbert.BertTrainer(tcfg, lr=1e-3, device="cpu",
                            params=bert_params_from_numpy(to_np(tree),
                                                          "cpu"))
    gpu = tbert.BertTrainer(tcfg, lr=1e-3,
                            params=bert_params_from_numpy(to_np(tree),
                                                          "cuda"))
    tokens, labels = tbert.synthetic_mlm_batch(tcfg, 8, 16, seed=2)
    for step in range(2):
        a = float(gpu.train_step(tokens, labels))
        b = float(cpu.train_step(tokens, labels))
        assert abs(a - b) <= 1e-4 * abs(b), (step, a, b)
