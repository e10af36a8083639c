"""Transport between the positions of a mesh.

The port's own module: the counterpart of what the JAX package compiles
into a step, ``lax.ppermute``, ``lax.psum`` and ``shard_map``'s
``lax.axis_index``. It moves tensors and holds no policy: what to send,
when, and how to weigh it is the caller's.

- ``ring_shift`` sends each block one place on along a mesh axis. Across
  ranks that is one ``dist.batch_isend_irecv`` of a send to the next rank
  and a receive from the previous one; in one process the caller holds
  every block of the axis in a list and each block moves to the next
  position's device with ``.to()`` (a no-op where the devices repeat).
- ``all_reduce_sum`` sums a tensor in place over the group (nothing to do
  without one).
- ``axis_size`` / ``axis_rank``: the axis's size, and the one index along
  it at which this rank sits (the ring's rank index).

The group's collectives time out (``multihost.TIMEOUT``),
so a lost rank fails a call here instead of hanging it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.multihost import world


def group_active() -> bool:
    """Whether a process group exists (world size 1 included)."""
    return dist.is_available() and dist.is_initialized()


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape.get(axis, 1))


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along ``axis``; raises where the rank owns more
    than one index there (a one-process ring holds them all)."""
    idx = mesh.coords(axis)
    if len(idx) != 1:
        raise ValueError(f"this rank owns indices {idx} along {axis!r}, "
                         f"not one")
    return idx[0]


def ring_shift(x, mesh, axis: str):
    """Move blocks one place on along ``axis``.

    Across ranks ``x`` is a tensor or a tuple of tensors (this rank's
    blocks): each is sent to the next rank along the axis and replaced by
    the previous rank's, and the received tensors come back in the same
    structure. In one process ``x`` is the list of the axis's n blocks,
    block i at position i: the result holds block i - 1 at position i, on
    that position's device."""
    if not mesh.spans_ranks(axis):
        n = axis_size(mesh, axis)
        if len(x) != n:
            raise ValueError(f"{len(x)} blocks for {axis}={n}")
        return [x[i - 1].to(mesh.axis_device(axis, i)) for i in range(n)]
    single = isinstance(x, torch.Tensor)
    sends = [x] if single else list(x)
    nxt, prv = mesh.axis_peer(axis, 1), mesh.axis_peer(axis, -1)
    recvs = [torch.empty_like(t) for t in sends]
    ops = []
    for t, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt))
        ops.append(dist.P2POp(dist.irecv, r, prv))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs[0] if single else tuple(recvs)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the group, in place; ``t`` as it is without a
    group."""
    if group_active():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` overwritten in place by rank ``src``'s; as it is without a
    group."""
    if group_active() and world()[0] > 1:
        dist.broadcast(t, src)
    return t
