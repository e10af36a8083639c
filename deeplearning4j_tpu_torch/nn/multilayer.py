"""MultiLayerNetwork: the sequential-network runtime (inference half).

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``. Parameters are a
list of per-layer ``{name: Tensor}`` dicts in the JAX package's order and
with its names, on one explicit device. The network runs on the GPU
unless the caller passes ``device="cpu"``. Training (fit, score, TBPTT,
the updaters' state) comes with the training slice.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers import OUTPUT_LAYER_TYPES


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.layers = conf.layers
        if not self.layers:
            raise ValueError("configuration has no layers")
        if not isinstance(self.layers[-1], OUTPUT_LAYER_TYPES):
            raise ValueError("last layer must be an OutputLayer")
        if conf.precision not in (None, "float32"):
            raise NotImplementedError(
                f"precision policy {conf.precision!r} comes with the "
                f"precision slice (ROADMAP.md, queue 1)")
        self.device = resolve_device(device)
        self._params: list[dict] = []
        self._states: list[dict] = []
        self._stream_states = None   # rnnTimeStep carried state per layer
        self._stream_batch = None
        self._initialized = False

    # -- init ----------------------------------------------------------------
    def init(self, params=None):
        """Initialize from the configuration's seed, or install ``params``
        (a list of per-layer {name: Tensor} dicts, as made by
        ``utils.convert.params_from_numpy``)."""
        dtype = self.conf.dtype
        if params is None:
            gen = torch.Generator().manual_seed(int(self.conf.seed))
            params = [lr.init_params(gen, dtype, self.device)
                      for lr in self.layers]
        else:
            if len(params) != len(self.layers):
                raise ValueError(f"{len(params)} param dicts for "
                                 f"{len(self.layers)} layers")
            for i, (lr, p) in enumerate(zip(self.layers, params)):
                want = lr.param_shapes()
                got = {k: tuple(v.shape) for k, v in p.items()}
                if got != want:
                    raise ValueError(f"layer {i} params {got} do not match "
                                     f"the configuration's {want}")
                for v in p.values():
                    if v.device != self.device or v.dtype != dtype:
                        raise ValueError(
                            f"layer {i} params must be {dtype} on "
                            f"{self.device}, got {v.dtype} on {v.device}")
        self._params = list(params)
        self._states = [lr.init_state(dtype, self.device)
                        for lr in self.layers]
        self._initialized = True
        return self

    def _check_init(self):
        if not self._initialized:
            raise RuntimeError("call init() first")

    def _input(self, x):
        """A batch as a tensor on this network's device; float inputs take
        the configured dtype."""
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x, device=self.device)
        if x.is_floating_point() and x.dtype != self.conf.dtype:
            x = x.to(self.conf.dtype)
        return x

    # -- pure forward --------------------------------------------------------
    def _forward(self, params, states, x):
        new_states = []
        for lr, p, st in zip(self.layers, params, states):
            x, st = lr.apply(p, st, x)
            new_states.append(st)
        return x, new_states

    def _infer_fn(self, training=False):
        """The inference function ``(params, states, x) -> y``. PyTorch runs
        eagerly, so there is nothing to compile or cache."""
        if training:
            raise NotImplementedError(
                "training-mode forward comes with the training slice")

        def fn(params, states, x):
            with torch.inference_mode():
                y, _ = self._forward(params, states, x)
            return y

        return fn

    def output(self, x, train: bool = False) -> torch.Tensor:
        """The network's output for batch ``x`` ([N, C, T] for recurrent
        nets), as a tensor on the network's device."""
        self._check_init()
        return self._infer_fn(train)(self._params, self._states,
                                     self._input(x))

    # -- streaming inference (rnnTimeStep / rnnClearPreviousState) -----------
    def _recurrent_indices(self):
        return [i for i, lr in enumerate(self.layers)
                if getattr(lr, "IS_RECURRENT", False)]

    def _seed_rnn_states(self, states, batch_size):
        out = list(states)
        for i in self._recurrent_indices():
            out[i] = self.layers[i].streaming_state(
                batch_size, self.conf.dtype, self.device)
        return out

    def rnnTimeStep(self, x):
        """Streaming inference with carried hidden state: x is [N, C] (one
        timestep) or [N, C, T] (a chunk). Successive calls continue the
        sequence; rnnClearPreviousState() resets."""
        self._check_init()
        x = self._input(x)
        single = x.dim() == 2
        if single:
            x = x[:, :, None]
        n = x.shape[0]
        rec = set(self._recurrent_indices())
        if self._stream_states is None or self._stream_batch != n:
            seeded = self._seed_rnn_states(self._states, n)
            self._stream_states = {i: seeded[i] for i in rec}
            self._stream_batch = n
        states = [self._stream_states[i] if i in rec else s
                  for i, s in enumerate(self._states)]
        with torch.inference_mode():
            y, new_states = self._forward(self._params, states, x)
        self._stream_states = {i: new_states[i] for i in rec}
        return y[:, :, 0] if single and y.dim() == 3 else y

    def rnnClearPreviousState(self):
        self._stream_states = None
        self._stream_batch = None

    def rnnGetPreviousState(self, layer_idx: int) -> dict:
        if self._stream_states is None:
            return {}
        return dict(self._stream_states.get(layer_idx, {}))

    def rnnSetPreviousState(self, layer_idx: int, state: dict):
        """Install carried state (e.g. restoring a saved streaming session).
        Works after rnnClearPreviousState: a fresh session is seeded from
        the given state's batch size."""
        vals = {k: self._input(v) for k, v in state.items()}
        if self._stream_states is None:
            if not vals:
                raise ValueError("cannot infer batch size from empty state")
            n = next(iter(vals.values())).shape[0]
            seeded = self._seed_rnn_states(self._states, n)
            self._stream_states = {i: seeded[i]
                                   for i in self._recurrent_indices()}
            self._stream_batch = n
        self._stream_states[layer_idx] = vals

    # -- params --------------------------------------------------------------
    def numParams(self) -> int:
        return sum(v.numel() for p in self._params for v in p.values())
