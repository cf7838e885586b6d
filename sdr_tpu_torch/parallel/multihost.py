"""Scale-out across processes: process set-up and the mesh that spans them.

Port of ``sdr_tpu/parallel/multihost.py``.  A run over several processes
is the same sharded receivers as one process: the mesh spans processes,
each process passes its own part of the input and runs its own cells.
Layout policy, as in the JAX package: the **channel** axis goes across
processes (embarrassingly parallel: nothing is exchanged) and the **time**
axis within one, so the halo exchange of time sharding stays inside a
process (K6, over NVLink between the cards of one host) and never crosses
the network.  ``cross_process_time`` transposes the layout, so that every
halo crosses the process edge as ``torch.distributed`` point-to-point
(``time_shard.exchange_edges``): kept to check its results and cost.

:func:`setup` wires ``torch.distributed``; :func:`make_mesh` lays out every
process's devices.  Without a process group both work in one process.
"""

from __future__ import annotations

import datetime
import json
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.rendezvous import rendezvous

from sdr_tpu_torch.parallel.mesh import Mesh, local_devices

_DEVICES_KEY = "sdr_tpu_torch/devices/"


def _card(device: torch.device) -> str:
    """What names a device across processes: ``cpu``, or a card's host and
    UUID (which no ``CUDA_VISIBLE_DEVICES`` renumbering changes)."""
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else 0
    return f"{socket.gethostname()}/{torch.cuda.get_device_properties(index).uuid}"


def pick_backend(cards_by_rank: Sequence[Sequence[str]]) -> str:
    """``nccl`` when every rank names CUDA cards only and no card is named
    by two ranks (NCCL refuses two ranks on one device); ``gloo`` for the
    CPU, or ranks that share a card.  ``cards_by_rank[r]``: what
    :func:`_card` gives for rank r's devices."""
    owners: dict[str, int] = {}
    for rank, cards in enumerate(cards_by_rank):
        if not cards or "cpu" in cards:
            return "gloo"
        for card in set(cards):
            if owners.setdefault(card, rank) != rank:
                return "gloo"
    return "nccl"


def _url(coordinator_address: Optional[str]) -> str:
    """``env://`` by default, a URL as given, ``host:port`` as TCP."""
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def setup(coordinator_address: Optional[str] = None,
          num_processes: Optional[int] = None,
          process_id: Optional[int] = None,
          init_distributed: bool = True,
          backend: Optional[str] = None,
          timeout: datetime.timedelta = datetime.timedelta(seconds=300),
          devices: Optional[Sequence[torch.device | str]] = None) -> None:
    """Initialize the ``torch.distributed`` default group for a mesh that
    spans processes (the JAX package's ``jax.distributed.initialize``).

    No-op when ``init_distributed`` is False or the group already exists.
    ``coordinator_address``: a rendezvous URL (``tcp://host:port``,
    ``file:///path``) or ``host:port``; None reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` from the environment.
    ``backend``: ``nccl`` or ``gloo``; None picks from the ``devices``
    every process names (this process's, exchanged through the
    rendezvous store; :func:`pick_backend`).  With NCCL the process's
    first device becomes its current one and the communicator is made at
    once.  A peer that does not arrive within ``timeout`` fails the
    rendezvous instead of hanging it."""
    if not init_distributed or dist.is_initialized():
        return
    if backend is None and devices is None:
        raise ValueError("name this process's devices, or the backend")
    devices = [torch.device(d) for d in devices] if devices else []
    store, rank, world = next(rendezvous(
        _url(coordinator_address),
        -1 if process_id is None else process_id,
        -1 if num_processes is None else num_processes, timeout=timeout))
    store.set_timeout(timeout)
    if backend is None:
        store.set(f"{_DEVICES_KEY}{rank}",
                  json.dumps([_card(d) for d in devices]))
        backend = pick_backend([json.loads(store.get(f"{_DEVICES_KEY}{r}"))
                                for r in range(world)])
    device_id = None
    if backend == "nccl":
        if not devices or devices[0].type != "cuda":
            raise ValueError(f"NCCL needs this process's CUDA device, got "
                             f"{devices}")
        device_id = devices[0]
        torch.cuda.set_device(device_id)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout,
                            device_id=device_id)


def make_mesh(time_per_host: Optional[int] = None,
              ch_axis: str = "ch", time_axis: str = "time",
              cross_process_time: bool = False,
              devices: Optional[Sequence[torch.device | str]] = None
              ) -> Mesh:
    """Global 2-D (channel x time) mesh with ``time_per_host`` devices on
    each time row.

    ``devices``, this process's, default to :func:`~sdr_tpu_torch.
    parallel.mesh.local_devices`; a list naming one device several times
    lays several shards on it.  With a process group, every process's
    devices are gathered rank by rank, each entry keeping its rank.
    ``time_per_host`` defaults to this process's device count, which puts
    every time row on one process: halo exchanges stay inside it and the
    channel axis spans the processes.  ``cross_process_time`` transposes
    the grid, as in the JAX package, so that every time row takes one
    device from each process: the layout the default policy exists to
    avoid, kept so that its results and cost can be checked."""
    local = [str(torch.device(d)) for d in (
        devices if devices is not None else local_devices())]
    if dist.is_initialized():
        names: list = [None] * dist.get_world_size()
        dist.all_gather_object(names, local)
    else:
        names = [local]
    devs = np.array([d for per in names for d in per], dtype=object)
    ranks = np.array([r for r, per in enumerate(names) for _ in per])
    if time_per_host is None:
        time_per_host = len(local)
    if len(devs) % time_per_host:
        raise ValueError(f"{len(devs)} devices do not split into rows of "
                         f"{time_per_host}")
    grid = devs.reshape(len(devs) // time_per_host, time_per_host)
    ranks = ranks.reshape(grid.shape)
    if cross_process_time:
        grid, ranks = grid.T, ranks.T
    return Mesh(grid, (ch_axis, time_axis), ranks=ranks)
