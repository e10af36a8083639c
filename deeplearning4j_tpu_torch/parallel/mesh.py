"""Device mesh and topology configuration.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``, with its names: the
axis constants, ``MeshConfig`` (the same ``ValueError``\\ s for a second
``-1`` axis and for device counts), ``Mesh`` (``shape``, ``axis_names``,
``devices``), ``spec_for``, ``shard_batch``, ``global_batch``,
``host_sharded_batch`` and ``replicated``.

In the JAX package a mesh lays GSPMD shardings over its devices, and every
collective is compiled into the step. Here one process drives the mesh
(see ``parallel/__init__.py`` for what each axis does): a ``Mesh`` is a
named-axis layout over a list of ``torch.device``\\ s, a spec is a tuple of
axis names or ``None`` (the reference's ``PartitionSpec``), and a batch
"sharded" over ``data`` is the whole batch on the mesh's first device. The
mesh's devices may repeat one card (``[torch.device("cuda")] * 4``); the
CPU tests name ``["cpu"] * n``. ``MeshConfig.build()`` without devices
takes every CUDA device and raises when CUDA is absent: there is no
fallback to the CPU.

``replica_devices`` comes with the multi-rank parallel tier (ROADMAP
queue 1, item 12).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

_AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS, EXPERT_AXIS)


class Mesh:
    """Devices laid out over named axes: ``devices`` a numpy object array
    of ``torch.device`` of ``shape``'s sizes, ``shape`` an axis -> size
    dict in ``axis_names`` order (as ``jax.sharding.Mesh.shape``)."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """Where one process keeps what the reference replicates or shards
        over ``data``/``expert``: the mesh's first device."""
        return self.devices.flat[0]

    def stage_device(self, stage: int) -> torch.device:
        """The device of pipeline stage ``stage``: index ``stage`` along
        ``pipe``, 0 along every other axis (the first device without a
        pipe axis)."""
        if PIPE_AXIS not in self.axis_names:
            if stage:
                raise ValueError(f"stage {stage} of a mesh without a pipe "
                                 f"axis")
            return self.device
        idx = [0] * len(self.axis_names)
        idx[self.axis_names.index(PIPE_AXIS)] = stage
        return self.devices[tuple(idx)]

    def __repr__(self):
        names = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, {names})"


def _default_devices():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: a mesh without named devices takes "
            "every CUDA device; name them (devices=['cpu'] * n) to lay "
            "the mesh over the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class MeshConfig:
    """Declarative mesh: MeshConfig(data=4, model=2) -> 8-device mesh.

    Unspecified axes get size 1; data absorbs leftover devices when
    data=-1 (the common 'use everything for DP' case)."""

    def __init__(self, data=-1, model=1, seq=1, pipe=1, expert=1,
                 devices=None):
        self.sizes = {DATA_AXIS: data, MODEL_AXIS: model, SEQ_AXIS: seq,
                      PIPE_AXIS: pipe, EXPERT_AXIS: expert}
        self.devices = devices

    def build(self) -> Mesh:
        devices = ([resolve_device(d) for d in self.devices]
                   if self.devices is not None else _default_devices())
        n = len(devices)
        fixed = math.prod(v for v in self.sizes.values() if v > 0)
        sizes = dict(self.sizes)
        n_auto = sum(1 for v in sizes.values() if v <= 0)
        if n_auto > 1:
            raise ValueError("at most one axis may be -1 (auto)")
        if n_auto == 1:
            if n % fixed != 0:
                raise ValueError(
                    f"{n} devices not divisible by fixed axes {fixed}")
            auto = n // fixed
            for k, v in sizes.items():
                if v <= 0:
                    sizes[k] = auto
        total = math.prod(sizes.values())
        if total != n:
            raise ValueError(
                f"mesh {sizes} needs {total} devices, have {n}")
        # size-1 axes are dropped, so specs naming them resolve to None
        axis_names = [a for a in _AXES if sizes[a] > 1] or [DATA_AXIS]
        shape = [sizes[a] for a in axis_names]
        arr = np.empty(n, dtype=object)
        arr[:] = devices
        return Mesh(arr.reshape(shape), axis_names)

    @staticmethod
    def data_parallel(devices=None) -> Mesh:
        return MeshConfig(data=-1, devices=devices).build()


def spec_for(mesh: Mesh, *axes) -> tuple:
    """A spec (tuple of axis names) with the axes the mesh lacks (size-1
    axes) as None."""
    names = set(mesh.axis_names)
    return tuple(a if a in names else None for a in axes)


def _on_device(mesh, arr):
    return torch.as_tensor(arr, device=mesh.device)


def shard_batch(mesh: Mesh, batch):
    """A host batch on the mesh: the whole batch on its first device."""
    return _on_device(mesh, batch)


def global_batch(mesh: Mesh, arr, spec=None):
    """The global batch from an array every process holds in full; in one
    process the array on the mesh's first device (``spec`` is taken for
    the reference's signature)."""
    del spec
    return _on_device(mesh, arr)


def host_sharded_batch(mesh: Mesh, arr, spec=None):
    """The global batch from per-process shards; in one process the one
    shard is the batch, on the mesh's first device."""
    del spec
    return _on_device(mesh, arr)


def replicated(mesh: Mesh) -> torch.device:
    """Where a replicated value lives in one process: the mesh's first
    device (the reference returns a ``NamedSharding`` with an empty
    spec)."""
    return mesh.device
