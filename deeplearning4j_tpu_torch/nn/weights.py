"""Weight initialization schemes.

Counterpart of ``deeplearning4j_tpu/nn/weights.py``: the same DL4J schemes
and fan conventions, drawn from an explicit ``torch.Generator``. The draws
differ from the JAX package's threefry keys, so parity between the two
packages goes through transferred weights (``utils/convert.py``), never
through a shared seed.
"""

from __future__ import annotations

import math

import torch


def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen) * std


def _uniform(gen, shape, limit):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


_INITS = {
    # DL4J XAVIER: gaussian with var 2/(fanIn+fanOut)
    "xavier": lambda g, s, fi, fo: _normal(g, s, math.sqrt(2.0 / (fi + fo))),
    "xavier_uniform": lambda g, s, fi, fo: _uniform(
        g, s, math.sqrt(6.0 / (fi + fo))),
    "xavier_fan_in": lambda g, s, fi, fo: _normal(g, s, math.sqrt(1.0 / fi)),
    # He / RELU: gaussian with var 2/fanIn
    "relu": lambda g, s, fi, fo: _normal(g, s, math.sqrt(2.0 / fi)),
    "relu_uniform": lambda g, s, fi, fo: _uniform(g, s, math.sqrt(6.0 / fi)),
    "lecun_normal": lambda g, s, fi, fo: _normal(g, s, math.sqrt(1.0 / fi)),
    "lecun_uniform": lambda g, s, fi, fo: _uniform(g, s, math.sqrt(3.0 / fi)),
    "normal": lambda g, s, fi, fo: _normal(g, s, 1.0 / math.sqrt(fi)),
    "uniform": lambda g, s, fi, fo: _uniform(g, s, 1.0 / math.sqrt(fi)),
    "sigmoid_uniform": lambda g, s, fi, fo: _uniform(
        g, s, 4.0 * math.sqrt(6.0 / (fi + fo))),
    "zero": lambda g, s, fi, fo: torch.zeros(s),
    "ones": lambda g, s, fi, fo: torch.ones(s),
}


class WeightInit:
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    NORMAL = "normal"
    UNIFORM = "uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    ZERO = "zero"
    ONES = "ones"


def init_weight(name, generator, shape, fan_in, fan_out,
                dtype=torch.float32, device="cpu"):
    """Draw one weight on the CPU from ``generator`` (so a seed gives the
    same weights on every device) and move it to ``device``. ``name`` may
    be a callable ``(generator, shape) -> tensor``."""
    if callable(name):
        w = torch.as_tensor(name(generator, shape))
    else:
        key = str(name).lower()
        if key not in _INITS:
            raise ValueError(f"unknown weight init {name!r}")
        w = _INITS[key](generator, tuple(shape), fan_in, fan_out)
    return w.to(device=device, dtype=dtype)
