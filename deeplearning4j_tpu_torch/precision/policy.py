"""Precision policies: which dtype each role of a training or serving step
runs in.

Counterpart of ``deeplearning4j_tpu/precision/policy.py``. A ``Policy``
names three dtypes and an optional loss-scaling mode:

- ``param_dtype``: what ``init()`` allocates and the updater state
  mirrors (the master weights: float32 under any ``*_mixed`` policy);
- ``compute_dtype``: what the forward and backward run in (params and
  inputs are cast inside the differentiated function, so the cast's
  backward brings the gradients back in ``param_dtype``);
- ``output_dtype``: what inference returns;
- ``loss_scaling``: None, ``"dynamic"`` (``DynamicLossScaler``) or a
  fixed float scale.

The JSON of every policy is the JAX package's. The reference's dtype
properties ``param_jnp``, ``compute_jnp`` and ``output_jnp`` are
``param_torch``, ``compute_torch`` and ``output_torch`` here. bf16 compute
comes from these casts only: TF32 stays off and ``torch.autocast`` is not
used, since autocast picks per-op dtypes that the policy does not.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import torch_dtype
from deeplearning4j_tpu_torch.tree_util import tree_map


@dataclass(frozen=True)
class Policy:
    name: str = "float32"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    output_dtype: str = "float32"
    # None | "dynamic" | fixed float scale
    loss_scaling: object = None
    # DynamicLossScaler knobs (ignored unless loss_scaling == "dynamic")
    init_scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000

    @property
    def param_torch(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def compute_torch(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def output_torch(self) -> torch.dtype:
        return torch_dtype(self.output_dtype)

    @property
    def is_mixed(self) -> bool:
        return self.compute_dtype != self.param_dtype

    @property
    def scaling_enabled(self) -> bool:
        return self.loss_scaling is not None

    def to_json(self):
        """A named policy as its name; a customised one field by field."""
        if self.name in NAMED_POLICIES and self == NAMED_POLICIES[self.name]:
            return self.name
        d = {"@policy": self.name}
        for k, v in self.__dict__.items():
            d[k] = v
        return d

    @staticmethod
    def from_json(d):
        if d is None or isinstance(d, Policy):
            return d
        if isinstance(d, str):
            return named_policy(d)
        d = dict(d)
        name = d.pop("@policy", d.pop("name", "custom"))
        return Policy(name=name, **{k: v for k, v in d.items()
                                    if k in Policy.__dataclass_fields__})


def _uniform(name, dtype):
    return Policy(name=name, param_dtype=dtype, compute_dtype=dtype,
                  output_dtype=dtype)


NAMED_POLICIES = {
    "float32": _uniform("float32", "float32"),
    "fp32": _uniform("fp32", "float32"),
    "bfloat16": _uniform("bfloat16", "bfloat16"),
    "bf16": _uniform("bf16", "bfloat16"),
    "bf16_mixed": Policy(name="bf16_mixed", param_dtype="float32",
                         compute_dtype="bfloat16", output_dtype="float32",
                         loss_scaling="dynamic"),
    "fp16_mixed": Policy(name="fp16_mixed", param_dtype="float32",
                         compute_dtype="float16", output_dtype="float32",
                         loss_scaling="dynamic"),
}


def named_policy(name: str) -> Policy:
    try:
        return NAMED_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {name!r}; choose from "
            f"{sorted(NAMED_POLICIES)} or pass a precision.Policy") from None


def _dtype_name(data_type) -> str:
    """A dataType (a name, a numpy or a torch dtype) as the name the JAX
    package writes: numpy's, and "bfloat16", which numpy has no name
    for without ml_dtypes."""
    name = str(data_type).removeprefix("torch.")
    if name != "bfloat16":
        name = str(np.dtype(name))
    torch_dtype(name)   # reject a type the port does not run
    return name


def resolve_policy(precision, data_type) -> Policy:
    """The effective Policy of a configuration: ``precision`` may be None
    (the uniform policy of ``data_type``), a policy name, a Policy, or a
    serialized policy dict."""
    if precision is None:
        dt = _dtype_name(data_type)
        return _uniform(dt, dt)
    if isinstance(precision, Policy):
        return precision
    if isinstance(precision, str):
        return named_policy(precision)
    return Policy.from_json(precision)


def cast_floating(tree, dtype):
    """Every floating leaf of ``tree`` cast to ``dtype``, leaving integer
    leaves (embedding ids, step counts) and float64 leaves alone. Leaves
    already in ``dtype`` are returned as they are, so the cast costs
    nothing where nothing needs one; under autograd the cast is
    differentiable and its backward returns the leaf's own dtype."""
    dtype = torch_dtype(dtype)

    def one(x):
        if not isinstance(x, torch.Tensor) or not x.is_floating_point():
            return x
        if x.dtype == dtype or x.dtype == torch.float64:
            return x
        return x.to(dtype)

    return tree_map(one, tree)
