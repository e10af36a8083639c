"""``chip_smoke.py``'s Adam step gate (``_adam_before``, ``_adam_gap``,
``_adam_gate``) on the CPU, with two copies of a network stepped from the
same state standing in for the card and the CPU.

- Two equal steps pass it: the gradients and squares the moments took in
  agree exactly, and each copy's weights moved by Adam's step of its own
  moments to the rounding of a weight.
- A missing update, a first moment that took in twice the gradient, and
  a FrozenLayer (NoOp updater) weight that moved each fail it.

The networks are the smoke's own: its small conv net (a FrozenLayer
among Adam layers), its AttentionVertex graph, and its
MaskZeroLayer(LSTM) + FrozenLayer(LSTM) net at a short sequence.
"""

import numpy as np
import pytest
import torch

NETS = ("conv2d", "attention_vertex", "wrapped_lstm")


def _pair(name):
    """(card stand-in, CPU twin, one batch) of the smoke's network
    ``name``, both on the CPU from the same weights."""
    import chip_smoke as smoke
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    rng = np.random.default_rng(7)
    if name == "wrapped_lstm":
        conf = smoke._wrapped_lstm_net_conf()
        x = rng.normal(size=(4, smoke.IMDB_EMBED, 12)).astype(np.float32)
        x[0, :, 8:] = 0.0
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (4, 12))]
        a = MultiLayerNetwork(conf, device="cpu").init()
        return a, smoke._cpu_twin(a), (x, y.transpose(0, 2, 1).copy())
    _, conf, shapes, n_out, kind = next(
        net for net in smoke._small_nets() if net[0] == name)
    assert kind == "classes"
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out,
                                                     shapes[0][0])]
    if hasattr(conf, "nodes"):
        a = ComputationGraph(conf, device="cpu").init()
        return a, smoke._graph_cpu_twin(a), MultiDataSet(xs, [y])
    a = MultiLayerNetwork(conf, device="cpu").init()
    b = smoke._cpu_twin(a)
    b._states = [{k: v.clone() for k, v in s.items()} for s in a._states]
    return a, b, (xs[0], y)


def _stepped(name, steps=1):
    """The pair after ``steps`` fit steps, the last from the same state,
    and what ``_adam_gap`` reads of that state."""
    import chip_smoke as smoke

    a, b, data = _pair(name)
    for _ in range(steps - 1):
        a.fit(data)
        b.fit(data)
    smoke._copy_state(torch, a, b)
    before = smoke._adam_before(b)
    a.fit(data)
    b.fit(data)
    return smoke, before, a, b


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("name", NETS)
def test_equal_steps_pass(name, steps):
    smoke, before, a, b = _stepped(name, steps)
    grad, sq, form, reach, apart, total = smoke._adam_gap(before, a, b)
    assert (grad, sq, reach, apart) == (0.0, 0.0, 0.0, 0)
    assert form < 1e-4 and total > 0
    smoke._adam_gate(name, steps - 1, smoke._adam_gap(before, a, b))


@pytest.mark.parametrize("name", NETS)
def test_missing_update_fails(name):
    smoke, before, a, b = _stepped(name)
    with torch.no_grad():
        for (w0s, _, _), group in zip(before[1], smoke._adam_groups(a)):
            for w0, w in zip(w0s, group[1]):
                w.copy_(w0)
    _, _, form, *_ = smoke._adam_gap(before, a, b)
    assert form > 0.5
    with pytest.raises(SystemExit, match="FAILED"):
        smoke._adam_gate(name, 0, smoke._adam_gap(before, a, b))


@pytest.mark.parametrize("name", NETS)
def test_wrong_first_moment_fails(name):
    smoke, before, a, b = _stepped(name)
    with torch.no_grad():
        for group in smoke._adam_groups(a):
            for m in group[2]:
                m.mul_(2.0)
    grad, *_ = smoke._adam_gap(before, a, b)
    assert grad == pytest.approx(1.0, rel=1e-4)
    with pytest.raises(SystemExit, match="FAILED"):
        smoke._adam_gate(name, 0, smoke._adam_gap(before, a, b))


@pytest.mark.parametrize("name", ["conv2d", "wrapped_lstm"])
def test_frozen_weight_moved_fails(name):
    smoke, before, a, b = _stepped(name)
    frozen = [g for g in smoke._adam_groups(a)
              if type(g[0]).__name__ == "NoOp"]
    assert frozen
    with torch.no_grad():
        frozen[0][1][0].add_(1e-6)
    _, _, form, *_ = smoke._adam_gap(before, a, b)
    assert form == float("inf")
    with pytest.raises(SystemExit, match="FAILED"):
        smoke._adam_gate(name, 0, smoke._adam_gap(before, a, b))
