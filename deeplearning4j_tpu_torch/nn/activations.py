"""Activation functions for layer configs.

Counterpart of ``deeplearning4j_tpu/nn/activations.py``: the same names
(DL4J's Activation enum as strings, so configs stay JSON) resolving to
PyTorch functions with the JAX package's definitions (``gelu`` is the tanh
approximation, as ``jax.nn.gelu`` defaults to).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _leaky_relu(alpha):
    return lambda x: F.leaky_relu(x, alpha)


def _elu(alpha):
    return lambda x: F.elu(x, alpha)


def _thresholded_relu(theta):
    return lambda x: torch.where(x > theta, x, torch.zeros_like(x))


ACTIVATIONS = {
    "identity": lambda x: x,
    "relu": torch.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "logsoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "leakyrelu": _leaky_relu(0.01),
    "elu": _elu(1.0),
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "hardsigmoid": F.hardsigmoid,
    "rationaltanh": lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0),
    "rectifiedtanh": lambda x: torch.clamp(torch.tanh(x), min=0.0),
    "cube": lambda x: x ** 3,
    "thresholdedrelu": _thresholded_relu(1.0),
}


class Activation:
    """Enum-style accessors: Activation.RELU == "relu"."""

    IDENTITY = "identity"
    RELU = "relu"
    RELU6 = "relu6"
    TANH = "tanh"
    SIGMOID = "sigmoid"
    SOFTMAX = "softmax"
    LOGSOFTMAX = "logsoftmax"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    SWISH = "swish"
    MISH = "mish"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    HARDTANH = "hardtanh"
    HARDSIGMOID = "hardsigmoid"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    CUBE = "cube"
    THRESHOLDEDRELU = "thresholdedrelu"


_PARAMETRIZED = {"leakyrelu": _leaky_relu, "elu": _elu,
                 "thresholdedrelu": _thresholded_relu}


def resolve_activation(name):
    """Accept a name string, an Activation constant, or a callable.
    "leakyrelu:<alpha>", "elu:<alpha>" and "thresholdedrelu:<theta>"
    carry their parameter in the name."""
    if callable(name):
        return name
    key = str(name).lower().replace("_", "")
    base, sep, arg = key.partition(":")
    if sep and base in _PARAMETRIZED:
        return _PARAMETRIZED[base](float(arg))
    if key not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return ACTIVATIONS[key]
