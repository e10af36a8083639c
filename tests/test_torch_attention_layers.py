"""The attention layers and AttentionVertex in the port, against the JAX
package.

- SelfAttentionLayer (projected with 1 and 2 heads, and unprojected),
  LearnedSelfAttentionLayer (projected and unprojected) and
  RecurrentAttentionLayer: JSON both ways, ``infer``, output and param
  and input gradients to 1e-5 of each array's largest element, on
  transferred weights; their ``infer`` errors.
- Networks of each, 2 Adam steps from the same state in both packages
  (losses to 1e-5 relative, params and moments to 1e-4).
- AttentionVertex: a graph node with its own (queries, keys, values)
  inputs through ``ComputationGraph`` (one input attending over itself,
  and separate query and key/value inputs of other widths), output,
  gradients and 2 steps against the JAX package's graph; the JSON names
  it a layer node; its ``projectInput=False`` error is the reference's.
- RecurrentAttentionLayer's carried state through ``rnnTimeStep`` equals
  its whole-sequence output.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import datasets as JD
from deeplearning4j_tpu import nn as J
from deeplearning4j_tpu.nn.conf import attention as jax_attention
from deeplearning4j_tpu.optimize import updaters as JU
from deeplearning4j_tpu_torch import datasets as PD
from deeplearning4j_tpu_torch import nn as P
from deeplearning4j_tpu_torch.nn.conf import attention
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as PU
from torch_parity import (
    FN_RTOL, TRAIN_RTOL, check_layer, close, compare_trees, graph_pair,
    net_pair, sync, to_np)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _adam(m):
    return (JU if m is J else PU).Adam(1e-2)


def _conf(m, layers, it):
    b = (m.NeuralNetConfiguration.Builder().seed(5).updater(_adam(m))
         .list())
    for lr in layers:
        b = b.layer(lr)
    return b.setInputType(it).build()


LAYERS = {
    "self_2heads": lambda m: m.SelfAttentionLayer.Builder(
        nOut=6, nHeads=2, activation="tanh").build(),
    "self_1head": lambda m: m.SelfAttentionLayer.Builder(
        nOut=4, headSize=3).build(),
    "self_unprojected": lambda m: m.SelfAttentionLayer.Builder(
        projectInput=False, activation="identity").build(),
    "learned_2heads": lambda m: m.LearnedSelfAttentionLayer.Builder(
        nOut=4, nHeads=2, nQueries=3, activation="identity").build(),
    "learned_unprojected": lambda m: m.LearnedSelfAttentionLayer.Builder(
        projectInput=False, nQueries=2).build(),
    "recurrent": lambda m: m.RecurrentAttentionLayer.Builder(
        nOut=5).build(),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_the_reference(name):
    jconf = _conf(J, [LAYERS[name](J), J.RnnOutputLayer.Builder().nOut(2)
                      .build()], J.InputType.recurrent(3, 5))
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.to_json() == jconf.to_json()
    jl, pl = jconf.layers[0], conf.layers[0]
    assert pl.to_json() == jl.to_json()
    assert pl.infer(conf.layer_input_types[0]).to_json() == jl.infer(
        jconf.layer_input_types[0]).to_json()
    params = to_np(pl.init_params(torch.Generator().manual_seed(2)))
    assert {k: v.shape for k, v in params.items()} == pl.param_shapes()
    assert sorted(params) == sorted(jax.eval_shape(
        lambda k: jl.init_params(k), jax.random.key(0)))
    x = np.random.default_rng(1).normal(size=(3, 3, 5)).astype(np.float32)
    check_layer(jl, pl, params, x)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_network_trains_as_the_reference(name):
    jconf = _conf(J, [LAYERS[name](J), J.GlobalPoolingLayer.Builder()
                      .build(), J.OutputLayer.Builder().nOut(2).build()],
                  J.InputType.recurrent(3, 5))
    port, jnet = net_pair(jconf, 1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3, 5)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
    compare_trees(port.gradients(x, y), jnet.gradients(x, y), FN_RTOL,
                  "gradients")
    for step in range(2):
        sync(port, jnet)
        port.fit((x, y))
        jnet.fit((x, y))
        assert abs(port.score() - jnet.score()) <= FN_RTOL * abs(
            jnet.score())
        compare_trees([port._params, port._opt_states],
                      [jnet._params, jnet._opt_states], TRAIN_RTOL,
                      f"step {step}", TRAIN_RTOL * 1e-4)


@pytest.mark.parametrize("m", [J, P], ids=["jax", "torch"])
def test_infer_errors(m):
    t = m.InputType.recurrent(3, 5)
    with pytest.raises(ValueError, match="nHeads=1"):
        m.SelfAttentionLayer(projectInput=False, nHeads=2).infer(t)
    with pytest.raises(ValueError, match="needs nOut"):
        m.LearnedSelfAttentionLayer().infer(t)
    with pytest.raises(ValueError, match="not divisible"):
        m.SelfAttentionLayer(nOut=5, nHeads=2).infer(t)
    with pytest.raises(ValueError, match="projectInput=False requires"):
        m.AttentionVertex(nOut=4, nHeads=2, projectInput=False).infer(t)


def test_recurrent_attention_streams_as_the_whole_sequence():
    conf = _conf(P, [P.RecurrentAttentionLayer.Builder(nOut=4).build(),
                     P.RnnOutputLayer.Builder().nOut(2).build()],
                 P.InputType.recurrent(3, 6))
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = np.random.default_rng(3).normal(size=(2, 3, 6)).astype(np.float32)
    # each step attends over the chunk it is given: one chunk of all six
    # steps through rnnTimeStep is the whole-sequence output
    close(net.rnnTimeStep(x).toNumpy(), net.output(x).toNumpy())
    assert set(net.rnnGetPreviousState(0)) == {"h"}


def _graph_conf(m, two_inputs):
    g = (m.NeuralNetConfiguration.Builder().seed(9)
         .updater(_adam(m)).graphBuilder())
    if two_inputs:
        g.addInputs("q", "kv")
        g.setInputTypes(m.InputType.recurrent(3, 4),
                        m.InputType.recurrent(5, 6))
        g.addLayer("att", m.AttentionVertex(nOut=4, nHeads=2,
                                            activation="identity"),
                   "q", "kv", "kv")
    else:
        g.addInputs("in")
        g.setInputTypes(m.InputType.recurrent(3, 5))
        g.addLayer("enc", m.LSTM.Builder(nOut=4, activation="tanh")
                   .build(), "in")
        g.addLayer("att", m.AttentionVertex(nOut=4, nHeads=2,
                                            activation="identity"),
                   "enc", "enc", "enc")
    g.addLayer("pool", m.GlobalPoolingLayer.Builder().build(), "att")
    g.addLayer("out", m.OutputLayer.Builder().nOut(2).build(), "pool")
    g.setOutputs("out")
    return g.build()


@pytest.mark.parametrize("two_inputs", [False, True],
                         ids=["self", "query_and_memory"])
def test_attention_vertex_graph_trains_as_the_reference(two_inputs):
    jconf = _graph_conf(J, two_inputs)
    port, jg = graph_pair(jconf, 4)
    assert _graph_conf(P, two_inputs).to_json() == jconf.to_json()
    assert '"kind": "layer"' in port.conf.to_json()
    rng = np.random.default_rng(0)
    xs = ([rng.normal(size=(3, 3, 4)).astype(np.float32),
           rng.normal(size=(3, 5, 6)).astype(np.float32)] if two_inputs
          else [rng.normal(size=(3, 3, 5)).astype(np.float32)])
    y = np.eye(2, dtype=np.float32)[[0, 1, 0]]
    close(port.outputSingle(*xs).toNumpy(),
          np.asarray(jg.outputSingle(*xs).numpy()))
    assert port._params["att"]["Wk"].shape == ((5 if two_inputs else 4), 4)
    compare_trees(port.gradients((xs, [y])), jg.gradients((xs, [y])),
                  FN_RTOL, "gradients")
    for step in range(2):
        sync(port, jg)
        port.fit(PD.MultiDataSet(xs, [y]))
        jg.fit(JD.MultiDataSet(xs, [y]))
        assert abs(port.score() - jg.score()) <= FN_RTOL * abs(jg.score())
        compare_trees([port._params, port._opt_states],
                      [jg._params, jg._opt_states], TRAIN_RTOL,
                      f"step {step}", TRAIN_RTOL * 1e-4)


def test_attention_vertex_unprojected_and_one_input():
    jv = jax_attention.AttentionVertex(projectInput=False)
    pv = attention.AttentionVertex(projectInput=False)
    t = J.InputType.recurrent(3, 5)
    jv.apply_defaults({})
    pv.apply_defaults({})
    assert pv.infer(P.InputType.recurrent(3, 5)).to_json() == \
        jv.infer(t).to_json()
    assert pv.param_shapes() == {} and pv.nOut == 3
    x = np.random.default_rng(2).normal(size=(2, 3, 5)).astype(np.float32)
    y, _ = pv.apply({}, {}, torch.tensor(x))
    jy, _ = jv.apply({}, {}, x, False, None)
    close(to_np(y), np.asarray(jy))
    y2, _ = pv.apply({}, {}, [torch.tensor(x)] * 3)
    close(to_np(y2), np.asarray(jy))
