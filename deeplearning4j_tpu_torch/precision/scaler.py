"""Dynamic loss scaling inside the training step.

Counterpart of ``deeplearning4j_tpu/precision/scaler.py``. The loss is
multiplied by a power-of-two scale before the backward pass, the
gradients are divided by the same scale before the updater, and a step
whose gradients came back non-finite is discarded on the device while
the scale halves; after ``growth_interval`` good steps in a row the scale
doubles.

The state is three 0-d tensors on the network's device (``scale``
float32, ``good_steps`` and ``overflows`` int32). ``all_finite`` is one
multi-tensor reduction over the gradient leaves (``torch._foreach_norm``
at infinity, which carries NaN and inf through), ``next_state`` is a few
``torch.where``s, and the networks gate the update with ``torch.where``
on the same 0-d flag: nothing here reads a device value on the host, so
an overflow step costs no host synchronisation. The host sees the state
one step behind through ``precision.monitor_for``.

Scales are powers of two, so ``scaled_loss / scale`` and
``grad / scale`` are exact in every binary float format.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.tree_util import tree_fill, tree_leaves

# state keys (all 0-d tensors):
#   scale      f32  current loss scale
#   good_steps i32  consecutive finite steps since the last change
#   overflows  i32  cumulative non-finite (skipped) steps
STATE_KEYS = ("scale", "good_steps", "overflows")

MAX_SCALE = 2.0 ** 31
MIN_SCALE = 1.0


class DynamicLossScaler:
    """Built once a network from its Policy."""

    def __init__(self, init_scale=2.0 ** 15, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000):
        self.init_scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.dynamic = True

    @classmethod
    def for_policy(cls, policy):
        """The scaler a Policy asks for, or None (no scaling)."""
        if not policy.scaling_enabled:
            return None
        if policy.loss_scaling == "dynamic":
            return cls(policy.init_scale, policy.growth_factor,
                       policy.backoff_factor, policy.growth_interval)
        return FixedLossScaler(float(policy.loss_scaling))

    def init_state(self, device="cpu") -> dict:
        return {"scale": torch.tensor(self.init_scale, dtype=torch.float32,
                                      device=device),
                "good_steps": torch.tensor(0, dtype=torch.int32,
                                           device=device),
                "overflows": torch.tensor(0, dtype=torch.int32,
                                          device=device)}

    # -- step math -----------------------------------------------------------
    def scale_loss(self, loss, state):
        return loss.float() * state["scale"]

    def unscale(self, grads, state):
        """``grads`` (any nesting) divided by the scale: each leaf times
        1 / scale in its own dtype, one multi-tensor launch a dtype."""
        leaves = tree_leaves(grads)
        inv = torch.reciprocal(state["scale"])
        out = iter(_foreach_by_dtype(
            leaves, lambda ls: torch._foreach_mul(ls, inv.to(ls[0].dtype))))
        return tree_fill(grads, out)

    @staticmethod
    def all_finite(tree):
        """A 0-d bool tensor: every floating leaf of ``tree`` is finite.
        The gate's condition: it must see the gradients before the
        updater does."""
        leaves = [x for x in tree_leaves(tree)
                  if x.is_floating_point() and x.numel()]
        if not leaves:
            return torch.ones((), dtype=torch.bool)
        norms = _foreach_by_dtype(
            leaves, lambda ls: torch._foreach_norm(ls, float("inf")))
        return torch.isfinite(torch.stack(
            [n.float() for n in norms])).all()

    def next_state(self, state, finite) -> dict:
        grown = (state["good_steps"] + 1) >= self.growth_interval
        scale_ok = torch.where(
            grown,
            torch.clamp(state["scale"] * self.growth_factor, max=MAX_SCALE),
            state["scale"])
        scale = torch.where(
            finite, scale_ok,
            torch.clamp(state["scale"] * self.backoff_factor,
                        min=MIN_SCALE))
        good = torch.where(finite & ~grown, state["good_steps"] + 1,
                           torch.zeros_like(state["good_steps"]))
        overflows = state["overflows"] + (~finite).to(torch.int32)
        return {"scale": scale.to(torch.float32),
                "good_steps": good.to(torch.int32),
                "overflows": overflows.to(torch.int32)}


class FixedLossScaler(DynamicLossScaler):
    """Constant scale: still unscales, still checks and skips non-finite
    steps, never adjusts."""

    def __init__(self, scale):
        super().__init__(init_scale=scale)
        self.dynamic = False

    def next_state(self, state, finite):
        zero = torch.zeros_like(state["good_steps"])
        return {"scale": state["scale"],
                "good_steps": torch.where(finite, state["good_steps"] + 1,
                                          zero).to(torch.int32),
                "overflows": (state["overflows"]
                              + (~finite).to(torch.int32)).to(torch.int32)}


def _foreach_by_dtype(leaves, fn):
    """``fn`` over ``leaves`` grouped by (dtype, device), one call a
    group, the results back in the leaves' order."""
    groups: dict = {}
    for i, x in enumerate(leaves):
        groups.setdefault((x.dtype, x.device), []).append(i)
    out = [None] * len(leaves)
    for idx in groups.values():
        for i, r in zip(idx, fn([leaves[i] for i in idx])):
            out[i] = r
    return out
