"""Device mesh and topology configuration.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``, with its names: the
axis constants, ``MeshConfig`` (the same ``ValueError``\\ s for a second
``-1`` axis and for device counts), ``Mesh`` (``shape``, ``axis_names``,
``devices``), ``spec_for``, ``shard_batch``, ``global_batch``,
``host_sharded_batch`` and ``replicated``.

In the JAX package a mesh lays GSPMD shardings over its devices, and every
collective is compiled into the step. Here a ``Mesh`` is a named-axis
layout over a list of ``torch.device``\\ s, a spec is a tuple of axis names
or ``None`` (the reference's ``PartitionSpec``), and each position of the
mesh belongs to one process (``Mesh.ranks``; see ``parallel/__init__.py``
for what each axis does):

- **One process.** Every position is this process's. A batch "sharded"
  over ``data`` is the whole batch on the mesh's first device. The mesh's
  devices may repeat one card (``[torch.device("cuda")] * 4``); the CPU
  tests name ``["cpu"] * n``.
- **Several ranks** (a ``torch.distributed`` group, ``MultiHost``). The
  mesh spans world size x the devices each rank names, rank-major as
  ``jax.devices()`` orders a pod: rank r owns the flat positions
  [r L, (r + 1) L). ``global_batch`` and ``shard_batch`` cut this rank's
  rows (and, by the spec, its sequence block) out of an array every rank
  holds whole; ``host_sharded_batch`` takes the rank's own rows as they
  are. A ``model``, ``pipe`` or ``expert`` axis that runs across ranks
  raises ``NotImplementedError`` (ROADMAP queue 1 item 12b).

``MeshConfig.build()`` without devices takes the devices ``MultiHost``
gave this rank, else the virtual CPU devices a ``RuntimeConfig`` with
``host_device_count`` applied, else every CUDA device, and raises when
CUDA is absent: there is no fallback to the CPU.

``replica_devices`` comes with the serving half of the parallel tier
(ROADMAP queue 1, item 12b).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import resolve_device
from deeplearning4j_tpu_torch.parallel import multihost

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

_AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS, EXPERT_AXIS)
# axes whose positions may belong to different ranks; the others are the
# serving half of the parallel tier
_RANK_AXES = (DATA_AXIS, SEQ_AXIS)


class Mesh:
    """Devices laid out over named axes: ``devices`` a numpy object array
    of ``torch.device`` of ``shape``'s sizes, ``shape`` an axis -> size
    dict in ``axis_names`` order (as ``jax.sharding.Mesh.shape``).

    ``ranks`` (an int array of the same shape, zeros by default) names the
    rank that owns each position and ``rank`` is this process's; a
    position another rank owns holds that rank's device as a label."""

    def __init__(self, devices, axis_names, ranks=None, rank=0):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.ranks = (np.zeros(self.devices.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(
                          self.devices.shape))
        self.rank = int(rank)
        self._mine = np.argwhere(self.ranks == self.rank)
        if not len(self._mine):
            raise ValueError(f"rank {self.rank} owns no position of the "
                             f"mesh")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def multi_rank(self) -> bool:
        """Whether the mesh's positions belong to more than one rank."""
        return bool((self.ranks != self.rank).any())

    @property
    def device(self) -> torch.device:
        """Where this process keeps what the reference replicates or shards
        over ``data``/``expert``: the first device it owns."""
        return self.devices[tuple(self._mine[0])]

    def coords(self, axis: str) -> list:
        """The indices along ``axis`` at which this rank owns a position
        ([0] for an axis the mesh lacks)."""
        if axis not in self.axis_names:
            return [0]
        col = self._mine[:, self.axis_names.index(axis)]
        return sorted({int(i) for i in col})

    def spans_ranks(self, axis: str) -> bool:
        """Whether moving along ``axis`` from this rank's positions reaches
        another rank's."""
        if axis not in self.axis_names:
            return False
        a = self.axis_names.index(axis)
        for pos in self._mine:
            line = list(pos)
            line[a] = slice(None)
            if (self.ranks[tuple(line)] != self.rank).any():
                return True
        return False

    def axis_device(self, axis: str, index: int) -> torch.device:
        """The device at ``index`` along ``axis`` and this rank's first
        position along every other axis."""
        pos = list(self._mine[0])
        if axis in self.axis_names:
            pos[self.axis_names.index(axis)] = index
        elif index:
            raise ValueError(f"index {index} along {axis!r}, which the mesh "
                             f"lacks")
        return self.devices[tuple(pos)]

    def axis_peer(self, axis: str, step: int) -> int:
        """The rank ``step`` places along ``axis`` from this rank's first
        position (modulo the axis size): the ring's neighbours."""
        pos = list(self._mine[0])
        a = self.axis_names.index(axis)
        pos[a] = (pos[a] + step) % self.shape[axis]
        return int(self.ranks[tuple(pos)])

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
        world = int(self.ranks.max()) + 1
        tail = f", rank {self.rank} of {world}" if world > 1 else ""
        return f"Mesh({self.shape}, {names}{tail})"


def _default_devices():
    """This rank's devices when ``MultiHost`` made the group, else the
    virtual CPU devices of an applied ``RuntimeConfig``, else every CUDA
    device (raising without CUDA)."""
    if multihost.MultiHost.local_devices():
        return list(multihost.MultiHost.local_devices())
    from deeplearning4j_tpu_torch import runtime

    virtual = runtime.virtual_cpu_devices()
    if virtual:
        return virtual
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: a mesh without named devices takes "
            "every CUDA device; name them (devices=['cpu'] * n) to lay "
            "the mesh over the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class MeshConfig:
    """Declarative mesh: MeshConfig(data=4, model=2) -> 8-device mesh.

    Unspecified axes get size 1; data absorbs leftover devices when
    data=-1 (the common 'use everything for DP' case). Under a process
    group ``devices`` are this rank's, and the mesh spans every rank's."""

    def __init__(self, data=-1, model=1, seq=1, pipe=1, expert=1,
                 devices=None):
        self.sizes = {DATA_AXIS: data, MODEL_AXIS: model, SEQ_AXIS: seq,
                      PIPE_AXIS: pipe, EXPERT_AXIS: expert}
        self.devices = devices

    def build(self) -> Mesh:
        local = ([resolve_device(d) for d in self.devices]
                 if self.devices is not None else _default_devices())
        world, rank = multihost.world()
        devices = local * world
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
        ranks = np.repeat(np.arange(world), len(local))
        mesh = Mesh(arr.reshape(shape), axis_names, ranks.reshape(shape),
                    rank)
        for axis in axis_names:
            if axis not in _RANK_AXES and mesh.spans_ranks(axis):
                raise NotImplementedError(
                    f"a {axis!r} axis across ranks is not ported: it comes "
                    f"with ROADMAP queue 1 item 12b (tensor parallelism "
                    f"across ranks and the sharded serving tier)")
        return mesh

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


def local_block(mesh: Mesh, arr, spec):
    """This rank's block of ``arr`` (every rank holds it whole) by
    ``spec``: along each dim named by an axis, the contiguous range of the
    axis indices this rank owns; the whole array in one process."""
    if not mesh.multi_rank:
        return arr
    for dim, axis in enumerate(spec):
        if axis is None or axis not in mesh.axis_names:
            continue
        n = mesh.shape[axis]
        if arr.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(arr.shape)} does not "
                             f"split over {axis}={n}")
        chunk = arr.shape[dim] // n
        idx = mesh.coords(axis)
        lo, hi = idx[0] * chunk, (idx[-1] + 1) * chunk
        arr = arr[(slice(None),) * dim + (slice(lo, hi),)]
    return arr


def shard_batch(mesh: Mesh, batch):
    """A host batch on the mesh: this rank's rows over ``data`` on its
    first device (the whole batch in one process)."""
    return _on_device(mesh, local_block(mesh, batch,
                                        spec_for(mesh, DATA_AXIS)))


def global_batch(mesh: Mesh, arr, spec=None):
    """The global batch from an array every process holds in full: this
    rank's block by ``spec`` (``data`` over the batch axis by default) on
    its first device; in one process the whole array."""
    spec = spec if spec is not None else spec_for(mesh, DATA_AXIS)
    return _on_device(mesh, local_block(mesh, arr, spec))


def host_sharded_batch(mesh: Mesh, arr, spec=None):
    """The global batch from per-process shards (each rank holds its own
    rows, the global batch their concatenation in rank order): the rank's
    shard as it is, on its first device."""
    del spec
    return _on_device(mesh, arr)


def replicated(mesh: Mesh) -> torch.device:
    """Where a replicated value lives in this process: the mesh's first
    device it owns (the reference returns a ``NamedSharding`` with an
    empty spec)."""
    return mesh.device
