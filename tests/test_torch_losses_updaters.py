"""The port's losses, updaters and schedules against the JAX package's.

Pure functions, fed the same numpy-made inputs in both packages: every
loss with and without a label mask (per timestep and per example), every
updater's ``apply`` over 3 steps (its state included), and every
learning-rate schedule through an updater's JSON. Tolerance: 1e-6 abs /
1e-5 rel (float32 on the CPU; the JAX package rounds its scalars, such as
Adam's bias correction, to float32, the port keeps them in Python floats).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import losses as jax_losses
from deeplearning4j_tpu.optimize import schedules as jax_schedules
from deeplearning4j_tpu.optimize import updaters as jax_updaters
from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.optimize import schedules, updaters

FN_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and leaves the cores
    to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_trees_close(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_trees_close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _assert_trees_close(g, w, what)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=what, **FN_TOL)


# -- losses -------------------------------------------------------------------

LOSS_CASES = [
    ("mcxent", "softmax"), ("negativeloglikelihood", "softmax"),
    ("mcxent", "sigmoid"), ("sparse_mcxent", "softmax"),
    ("mse", "identity"), ("l2", "tanh"), ("xent", "sigmoid"),
    ("xent", "softmax"), ("mae", "identity"), ("l1", "tanh"),
    ("hinge", "identity"), ("squared_hinge", "tanh"),
    ("kl_divergence", "softmax"), ("poisson", "softplus"),
    ("cosine_proximity", "identity"),
]


def _loss_inputs(name, shape, rng):
    pre = rng.normal(size=shape).astype(np.float32)
    c = shape[1]
    if name == "sparse_mcxent":
        lab_shape = (shape[0], 1) + shape[2:]
        return rng.integers(0, c, size=lab_shape).astype(np.float32), pre
    if name in ("hinge", "squared_hinge"):
        return np.sign(rng.normal(size=shape)).astype(np.float32), pre
    if name in ("mcxent", "negativeloglikelihood", "kl_divergence", "xent"):
        lab = rng.random(size=shape).astype(np.float32)
        return (lab / lab.sum(axis=1, keepdims=True)).astype(np.float32), pre
    return rng.random(size=shape).astype(np.float32), pre


@pytest.mark.parametrize("name,act", LOSS_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("mask", [None, "step", "example"])
def test_losses_match_jax(name, act, mask):
    rng = np.random.default_rng(len(name) * 7 + len(act))
    shape = (4, 5, 3)   # [N, C, T]: the time axis folds into the batch
    if name == "sparse_mcxent" and mask is not None:
        shape = (4, 5)
    labels, pre = _loss_inputs(name, shape, rng)
    m = None
    if mask == "step":
        m = (rng.random(size=(shape[0],) + shape[2:]) > 0.3).astype(
            np.float32)
    elif mask == "example":
        m = np.array([1, 0, 1, 1], np.float32)
    want = jax_losses.resolve_loss(name)(
        jnp.asarray(labels), jnp.asarray(pre), act,
        None if m is None else jnp.asarray(m))
    got = losses.resolve_loss(name)(
        torch.from_numpy(labels), torch.from_numpy(pre), act,
        None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(float(got), float(want), **FN_TOL)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="unknown loss"):
        losses.resolve_loss("nope")


# -- updaters and schedules -----------------------------------------------------

UPDATERS = [
    ("NoOp", {}), ("Sgd", {"learningRate": 0.05}),
    ("Nesterovs", {"learningRate": 0.05, "momentum": 0.8}),
    ("AdaGrad", {"learningRate": 0.05}), ("RmsProp", {"learningRate": 0.01}),
    ("AdaDelta", {}), ("Adam", {"learningRate": 0.01}),
    ("AdamW", {"learningRate": 0.01, "weightDecay": 0.1}),
    ("AMSGrad", {"learningRate": 0.01}), ("AdaMax", {"learningRate": 0.01}),
    ("Nadam", {"learningRate": 0.01}),
]


@pytest.mark.parametrize("name,kw", UPDATERS, ids=[u[0] for u in UPDATERS])
def test_updaters_match_jax_over_three_steps(name, kw):
    rng = np.random.default_rng(len(name))
    params = {"W": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    j_up = getattr(jax_updaters, name)(**kw)
    t_up = updaters.updater_from_config(j_up.to_json())
    assert type(t_up).__name__ == name
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    j_state, t_state = j_up.init_state(j_params), t_up.init_state(t_params)
    for step in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        j_upd, j_state = j_up.apply_mixed(
            {k: jnp.asarray(v) for k, v in grads.items()}, j_state,
            j_params, step)
        t_upd, t_state = t_up.apply_mixed(
            {k: torch.from_numpy(v) for k, v in grads.items()}, t_state,
            t_params, step)
        _assert_trees_close(t_upd, j_upd, f"{name} step {step}")
        _assert_trees_close(t_state, j_state, f"{name} state")
        j_params = {k: v - j_upd[k] for k, v in j_params.items()}
        for k in t_params:
            t_params[k] -= t_upd[k]


SCHEDULES = [
    ("FixedSchedule", dict(value=0.1)),
    ("ExponentialSchedule", dict(initialValue=0.1, gamma=0.9)),
    ("InverseSchedule", dict(initialValue=0.1, gamma=0.5, power=2.0)),
    ("PolySchedule", dict(initialValue=0.1, power=2.0, maxIter=10)),
    ("SigmoidSchedule", dict(initialValue=0.1, gamma=0.7, stepSize=4)),
    ("StepSchedule", dict(initialValue=0.1, decayRate=0.5, step=3)),
    ("MapSchedule", dict(values={0: 0.1, 3: 0.05, 7: 0.01})),
    ("CycleSchedule", dict(initialLearningRate=0.01, maxLearningRate=0.1,
                           cycleLength=12)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_jax(name, kw):
    j_sched = getattr(jax_schedules, name)(**kw)
    ramp = jax_schedules.RampSchedule(j_sched, 4)
    # through an updater's JSON, as a configuration carries it
    t_up = updaters.updater_from_config(
        jax_updaters.Sgd(ramp).to_json())
    assert isinstance(t_up.learningRate, schedules.RampSchedule)
    for it in range(14):
        np.testing.assert_allclose(t_up.lr(it), float(ramp.valueAt(it)),
                                   rtol=1e-6)
    assert schedules.resolve_lr(0.3, 5) == 0.3
    assert schedules.resolve_lr(lambda s: s * 2.0, 5) == 10.0
