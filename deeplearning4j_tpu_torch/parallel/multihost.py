"""Multi-process initialization: the process group.

Counterpart of ``deeplearning4j_tpu/parallel/multihost.py``, with its names
(``VoidConfiguration`` with ``builder()``, ``MultiHost.initialize``,
``topology``, ``shutdown``). Where the JAX package wires processes together
with ``jax.distributed.initialize``, the port makes a
``torch.distributed`` process group: the rendezvous is ``tcp://`` +
``controllerAddress``, the backend is NCCL when this process's devices are
CUDA devices and gloo when the caller names the CPU, and every collective
of the group times out after ``TIMEOUT`` seconds, so a lost rank fails the
call instead of hanging it.

The reference's ``initialize`` with ``num_processes=1`` only marks the
group initialized. The port makes a real group of one there (NCCL on the
card), so one card runs the collectives of the multi-rank paths
(``parallel/transport.py``) at world size 1.

``devices`` (port only) names this process's devices. By default a rank
drives one CUDA device, ``cuda:(rank % device_count)`` (NCCL takes one
rank a card), and raises when CUDA is absent; the CPU tests name
``devices=["cpu"]`` (or several, as the reference's virtual devices).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.backend import resolve_device

TIMEOUT = 120.0   # seconds any collective of the group may take


def world() -> tuple:
    """(world size, this rank): the process group's when one is
    initialized, else (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class VoidConfiguration:
    """Facade with the reference's field names. controllerAddress is the
    group's rendezvous (host:port); networkMask/ports collapse (one TCP
    rendezvous endpoint)."""

    _FIELDS = ("controllerAddress", "networkMask", "unicastPort",
               "streamId")

    def __init__(self, controllerAddress="127.0.0.1:8476",
                 networkMask=None, unicastPort=None, streamId=None):
        self.controllerAddress = controllerAddress
        if networkMask is not None or unicastPort is not None \
                or streamId is not None:
            from deeplearning4j_tpu_torch.parallel.trainer import (
                _warn_noop_knob)

            _warn_noop_knob(
                "VoidConfiguration.networkMask/unicastPort/streamId",
                "the torch.distributed group uses one TCP rendezvous "
                "endpoint")

    @staticmethod
    def builder():
        class _B:
            def __init__(self):
                self._kw = {}

            def __getattr__(self, item):
                if item not in VoidConfiguration._FIELDS:
                    raise AttributeError(
                        f"VoidConfiguration has no field {item!r} "
                        f"(known: {VoidConfiguration._FIELDS})")

                def setter(v):
                    self._kw[item] = v
                    return self

                return setter

            def build(self):
                return VoidConfiguration(**self._kw)

        return _B()


class MultiHost:
    """Process-group lifecycle for multi-process training."""

    _initialized = False
    _init_args = None
    _devices: list = []

    @staticmethod
    def initialize(void_config: VoidConfiguration | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *, devices=None):
        """Join this process to the group of ``num_processes`` (1 when
        None) as rank ``process_id`` (0 when None). Call once per process
        before building a mesh; afterwards ``MeshConfig.build()`` spans
        every rank's devices. A second call with other arguments raises
        until ``shutdown()``."""
        args = ((void_config or VoidConfiguration()).controllerAddress,
                num_processes, process_id)
        if MultiHost._initialized:
            if MultiHost._init_args is not None \
                    and args != MultiHost._init_args \
                    and any(a is not None for a in args[1:]):
                raise RuntimeError(
                    f"MultiHost already initialized with "
                    f"{MultiHost._init_args}; cannot re-initialize with "
                    f"{args} — call shutdown() first")
            return MultiHost.topology()
        n = 1 if num_processes is None else int(num_processes)
        rank = 0 if process_id is None else int(process_id)
        if devices is None:
            dev = resolve_device(None)
            if dev.type == "cuda":
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            devices = [dev]
        devices = [resolve_device(d) for d in devices]
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a rank's devices must be of one type: "
                             f"{devices}")
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(devices[0])
        dist.init_process_group(
            backend, init_method=f"tcp://{args[0]}", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT))
        MultiHost._initialized = True
        MultiHost._init_args = args
        MultiHost._devices = devices
        return MultiHost.topology()

    @staticmethod
    def local_devices() -> list:
        """The devices this rank drives (empty before ``initialize``)."""
        return list(MultiHost._devices)

    @staticmethod
    def backend() -> str | None:
        """The group's backend ("nccl", "gloo"), or None without one."""
        if dist.is_available() and dist.is_initialized():
            return dist.get_backend()
        return None

    @staticmethod
    def topology() -> dict:
        n, rank = world()
        local = len(MultiHost._devices) or 1
        return {
            "process_index": rank,
            "process_count": n,
            "local_devices": local,
            "global_devices": local * n,
        }

    @staticmethod
    def shutdown():
        if MultiHost._initialized and dist.is_initialized():
            dist.destroy_process_group()
        MultiHost._initialized = False
        MultiHost._init_args = None
        MultiHost._devices = []
