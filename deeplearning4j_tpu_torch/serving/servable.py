"""Servable adapters: one uniform `infer(batch) -> batch` face over a
network, with shape-bucketed warmup.

Counterpart of ``deeplearning4j_tpu/serving/servable.py``. There is no
XLA executable to compile: PyTorch runs eagerly, so warmup runs the
inference function once at each ladder shape (``compile_shape``), which
builds the kernels and fills the allocator's caches before traffic
arrives. Parameters are read from the live network at call time, never
captured.

The host boundary of a bfloat16 model (a network whose precision policy
outputs bfloat16) is float32: requests come in as float32 arrays that
hold bfloat16 values, and answers go out as float32, because numpy on
the GPU machine has no bfloat16 (the JAX package's numpy has it through
ml_dtypes). The network casts the batch to its compute dtype, so the
values it computes on are the bfloat16 ones either way.

Replicas (``for_device``), where the port differs by design. The
reference clones a servable onto N devices, each clone placing its own
copy of the params there. The port serves on one card, so a replica is a
clone on the SAME device that shares the model's parameter tensors
(read-only at inference) and owns:

- a ``torch.cuda.Stream`` of its own: ``infer`` runs the whole dispatch
  under ``torch.cuda.stream(...)`` (the host-to-device copy, the model,
  whose kernels launch on the current stream, and the copy back), so two
  replicas' dispatches can overlap on the card. The stream waits once, on
  an event recorded when the clone is made, for the stream that wrote the
  weights;
- staging buffers: one host tensor a bucket shape (pinned on CUDA, so the
  copy to the card is asynchronous on the replica's stream), reused by
  every dispatch of that shape. A dispatch ends by reading its answer
  back, which waits for the replica's stream, so the next dispatch may
  overwrite them.

The memory ledger's ``replica_args`` claim (one per replica) counts the
bytes a replica really owns, its staging buffers; the shared weights are
not counted again. A replica on the CPU has no stream and runs on the
calling worker thread, with staging buffers all the same.
"""

from __future__ import annotations

import copy
import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.telemetry import memledger


def _model_dtype(model) -> np.dtype:
    """The serving-boundary dtype a model's configuration implies: its
    precision policy's output dtype (the dataType without a policy), with
    bfloat16 served as float32 (the module's host-boundary rule)."""
    conf = getattr(model, "conf", None)
    if conf is None or not hasattr(conf, "precision_policy"):
        return np.dtype(np.float32)
    out = conf.precision_policy.output_dtype
    return np.dtype(np.float32 if out == "bfloat16" else out)


def _host(y) -> np.ndarray:
    """An answer on the host: a bfloat16 one as float32."""
    if y.dtype == torch.bfloat16:
        y = y.float()
    return y.cpu().numpy()


class Servable:
    """Base: a model's pure inference function behind numpy in/out.

    Subclasses provide `_infer_fn()` (the function) and `_call_args()`
    (its non-input arguments, read fresh per call). Batches move to
    `device`, where the model lives.

    `cost_label` (set by ModelRegistry.register) names the servable in
    the memory ledger's claims; `mem_label` (set by a ReplicaSet to the
    replica's name) tells the claims of replicas on one device apart.
    """

    cost_label = None

    def __init__(self, example_shape, device, dtype=np.float32):
        if example_shape is None:
            raise ValueError(
                "serving needs the per-example input shape (no batch "
                "axis), e.g. example_shape=(784,)")
        self.example_shape = tuple(int(d) for d in example_shape)
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device)
        self._warmed: set = set()
        self._lock = threading.Lock()
        # a replica clone's own state (for_device): its CUDA stream, the
        # event its stream waits on before first use, its staging buffers
        self.replica = False
        self.stream = None
        self._ready = None
        self._staging: dict = {}
        self._mem_claims = []   # memory-ledger claims this servable owns
        self.mem_label = None

    def for_device(self, device) -> "Servable":
        """A replica of this servable on ``device``, which must be the
        model's own (the port serves on one card: a replica shares the
        model's parameter tensors and owns a CUDA stream and staging
        buffers, see the module docstring). The clone warms on its own
        stream."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = resolve_device(device)
        if device != self.device:
            raise ValueError(
                f"a replica of a model on {self.device} cannot run on "
                f"{device}: replicas share the model's parameters on its "
                f"one device")
        clone = copy.copy(self)
        clone.replica = True
        clone._warmed = set()
        clone._lock = threading.Lock()
        clone._staging = {}
        clone._mem_claims = []
        clone.stream = clone._ready = None
        if device.type == "cuda":
            clone.stream = torch.cuda.Stream(device)
            clone._ready = torch.cuda.Event()
            clone._ready.record(torch.cuda.current_stream(device))
        return clone

    # -- memory-ledger claims ------------------------------------------------
    def _ledger_site(self) -> str:
        return self.cost_label or f"servable:{type(self).__name__}"

    def _mem_suffix(self) -> str:
        label = memledger.device_label(self.device)
        return label if not self.mem_label else f"{label}:{self.mem_label}"

    def _stage(self, shape):
        """This replica's host staging tensor for one input shape (made
        on first use, pinned on CUDA); a new one re-states the replica's
        ``replica_args`` claim with every staging byte it owns."""
        buf = self._staging.get(shape)
        if buf is not None:
            return buf
        dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        buf = torch.empty(shape, dtype=dtype,
                          pin_memory=self.device.type == "cuda")
        with self._lock:
            self._staging[shape] = buf
            staged = sum(b.numel() * b.element_size()
                         for b in self._staging.values())
        c = memledger.claim(
            "replica_args", f"{self._ledger_site()}@{self._mem_suffix()}",
            nbytes=staged, device=self.device, staging_buffers=len(
                self._staging), shares_params=True)
        if c is not None and c not in self._mem_claims:
            self._mem_claims.append(c)
        return buf

    def release_memory_claims(self):
        """Drop this servable's memory-ledger claims: called when a
        replica retires or a registry entry is unregistered."""
        claims, self._mem_claims = self._mem_claims, []
        for c in claims:
            c.release()

    # -- subclass surface ---------------------------------------------------
    def _infer_fn(self):
        raise NotImplementedError

    def _call_args(self) -> tuple:
        raise NotImplementedError

    # -- warmup -------------------------------------------------------------
    def compile_shape(self, shape: tuple):
        """The reference's AOT compile of one shape is XLA's; here it is
        the warm run of one concrete input shape (idempotent): the
        kernels build and the allocator's caches fill, nothing is kept
        but the shape's name (and a replica's staging buffer)."""
        shape = tuple(shape)
        if shape in self._warmed:
            return
        self.infer(np.zeros(shape, self.dtype))
        with self._lock:
            self._warmed.add(shape)

    def warmup(self, ladder) -> list[tuple]:
        """Run every ladder shape once; returns the warmed shapes."""
        shapes = ladder.shapes(self.example_shape)
        for s in shapes:
            self.compile_shape(s)
        return shapes

    @property
    def warmed_shapes(self) -> list[tuple]:
        return sorted(self._warmed)

    # whether the inference function reads every tensor it uses from
    # _call_args(), so that "meta" copies of them run it without touching
    # a device (a plain function may close over tensors on the card)
    shape_evaluable = False

    def estimate_shape_bytes(self, shape):
        """Pre-warmup footprint estimate for one bucket shape:
        ``(input_bytes, output_bytes)``, by running the inference
        function on "meta" copies of its arguments (shapes only: nothing
        is allocated or computed, the counterpart of ``jax.eval_shape``).
        None where the servable is not ``shape_evaluable`` or the
        function cannot run on "meta" tensors (a hand-written kernel's
        wrapper refuses them), so the planner does not guess."""
        if not self.shape_evaluable:
            return None
        try:
            meta = [_to_meta(a) for a in self._call_args()]
            x = torch.empty(tuple(shape), device="meta", dtype=torch.from_numpy(
                np.zeros(0, self.dtype)).dtype)
            y = self._infer_fn()(*meta, x)
            return memledger.tree_bytes(x), memledger.tree_bytes(y)
        except Exception:   # noqa: BLE001
            return None

    # -- hot path -----------------------------------------------------------
    def infer(self, x) -> np.ndarray:
        """Run one already-bucketed batch; the result comes back to the
        host as numpy (which waits for the device), a bfloat16 one as
        float32. A replica runs it on its own stream from its staging
        buffer."""
        x = np.ascontiguousarray(x, dtype=self.dtype)
        if not self.replica:
            y = self._infer_fn()(*self._call_args(),
                                 torch.from_numpy(x).to(self.device))
            return _host(y)
        host = self._stage(x.shape)
        host.numpy()[...] = x
        if self.stream is None:
            # a copy: the answer may alias the staging buffer
            return np.array(_host(self._infer_fn()(*self._call_args(),
                                                   host)))
        with torch.cuda.stream(self.stream):
            if self._ready is not None:
                self.stream.wait_event(self._ready)
                self._ready = None
            y = self._infer_fn()(*self._call_args(),
                                 host.to(self.device, non_blocking=True))
            return _host(y)


def _to_meta(tree):
    """A tree's tensors as "meta" tensors of the same shapes and dtypes."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


class NetworkServable(Servable):
    """MultiLayerNetwork: runs the network's own inference function, so
    direct `net.output()` calls and serving compute the same thing."""

    shape_evaluable = True

    def __init__(self, net, example_shape, dtype=None):
        super().__init__(example_shape, net.device,
                         _model_dtype(net) if dtype is None else dtype)
        self.net = net

    def _infer_fn(self):
        return self.net._infer_fn(False)

    def _call_args(self):
        return (self.net._params, self.net._states)


class GraphServable(Servable):
    """ComputationGraph with a single input and a single output: runs the
    graph's own forward, as ``outputSingle`` does, with the params read
    from the live graph at call time."""

    shape_evaluable = True

    def __init__(self, graph, example_shape, dtype=None):
        if len(graph.conf.inputs) != 1 or len(graph.conf.outputs) != 1:
            raise ValueError(
                f"serving supports single-input/single-output graphs; "
                f"got inputs={graph.conf.inputs} "
                f"outputs={graph.conf.outputs}")
        super().__init__(example_shape, graph.device,
                         _model_dtype(graph) if dtype is None else dtype)
        self.graph = graph

    def _infer_fn(self):
        return self.graph._infer_fn(False)

    def _call_args(self):
        return (self.graph._params, self.graph._states)


class SameDiffServable(Servable):
    """SameDiff graph: serve one placeholder -> one output variable. The
    graph's values are read at call time (a graph trained since it was
    registered serves its new values), and the graph runs under
    ``torch.inference_mode()`` on its own device."""

    def __init__(self, sd, input_name, output_name, example_shape,
                 dtype=None):
        super().__init__(example_shape, sd.device,
                         np.float32 if dtype is None else dtype)
        self.sd = sd
        self.input_name = (input_name.name()
                           if hasattr(input_name, "name") else input_name)
        self.output_name = (output_name.name()
                            if hasattr(output_name, "name") else output_name)

    def _run(self, params, consts, x):
        fn = self.sd._make_fn((self.output_name,), False)
        with torch.inference_mode():
            out = fn({self.input_name: x}, params, consts, self.sd._seed)
        return out[self.output_name]

    def _infer_fn(self):
        return self._run

    def _call_args(self):
        return self.sd._split_values()


class FnServable(Servable):
    """A plain ``fn(x) -> y`` over tensors, served like any network: the
    escape hatch for custom pipelines (BERT's ``forward`` over token ids,
    for one). ``fn`` runs under ``torch.inference_mode()`` on the
    servable's device ("cuda" unless named) and returns a tensor numpy
    can hold (float32, not bfloat16)."""

    def __init__(self, fn, example_shape, dtype=None, device=None):
        super().__init__(example_shape, resolve_device(device),
                         np.float32 if dtype is None else dtype)
        self.fn = fn

    def _run(self, x):
        with torch.inference_mode():
            return self.fn(x)

    def _infer_fn(self):
        return self._run

    def _call_args(self):
        return ()


def estimate_warmup_bytes(servable, ladder) -> dict | None:
    """Pre-warmup footprint of a full ladder warmup (the registry's
    capacity planner): the servable's call-arg bytes (the params, counted
    once: every bucket shares them) plus each bucket's input + output
    bytes from ``estimate_shape_bytes``. A lower bound (the activations
    in between are not counted) that still catches a ladder that cannot
    fit before the first warm run. None when the servable cannot be
    shape-evaluated."""
    buckets = {}
    total = 0
    for s in ladder.shapes(servable.example_shape):
        est = servable.estimate_shape_bytes(s)
        if est is None:
            return None
        buckets["x".join(str(d) for d in s)] = est[0] + est[1]
        total += est[0] + est[1]
    try:
        param_bytes = memledger.tree_bytes(servable._call_args())
    except Exception:   # noqa: BLE001
        param_bytes = 0
    return {"param_bytes": param_bytes, "buckets": buckets,
            "total": total + param_bytes, "basis": "meta"}


def as_servable(model, example_shape=None, dtype=None,
                input_name=None, output_name=None) -> Servable:
    """Wrap a supported model type in its Servable adapter. dtype=None
    takes the serving-boundary dtype from the model's precision policy
    (``_model_dtype``; float32 for a SameDiff graph or a plain function); a
    SameDiff graph needs the
    placeholder it is fed through and the variable it answers with."""
    if isinstance(model, Servable):
        return model
    kind = type(model).__name__
    if kind == "MultiLayerNetwork":
        return NetworkServable(model, example_shape, dtype)
    if kind == "ComputationGraph":
        return GraphServable(model, example_shape, dtype)
    if kind == "SameDiff":
        if input_name is None or output_name is None:
            raise ValueError(
                "SameDiff serving needs input_name= and output_name=")
        return SameDiffServable(model, input_name, output_name,
                                example_shape, dtype)
    if callable(model):
        return FnServable(model, example_shape, dtype)
    raise TypeError(f"cannot serve a {kind} (the port serves "
                    f"MultiLayerNetwork, ComputationGraph, SameDiff and "
                    f"plain functions so far)")
