"""Mesh layout for scale-out over several cards.

Port of ``sdr_tpu/parallel/multihost.py::make_mesh`` over this process's
devices.  Layout policy, as in the JAX package: the **channel** axis goes
across hosts (embarrassingly parallel) and the **time** axis within a
host, so the halo exchange of time sharding rides NVLink between the cards
of one host and never the network.  Process set-up across hosts (the JAX
package's ``setup``) is not ported yet: this module lays out the local
devices only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sdr_tpu_torch.parallel.mesh import Mesh, local_devices


def make_mesh(time_per_host: Optional[int] = None,
              ch_axis: str = "ch", time_axis: str = "time",
              cross_process_time: bool = False,
              devices: Optional[Sequence[torch.device | str]] = None
              ) -> Mesh:
    """2-D (channel x time) mesh with ``time_per_host`` devices on each
    time row.

    ``devices`` defaults to :func:`~sdr_tpu_torch.parallel.mesh.
    local_devices`; a list naming one device several times lays several
    shards on it.  ``time_per_host`` defaults to the device count, which
    keeps every halo exchange inside a row.  ``cross_process_time``
    transposes the grid, as in the JAX package, so that every time row
    takes one device from each group: the layout the default policy exists
    to avoid, kept so that its results and cost can be checked."""
    devs = np.array(list(devices) if devices is not None
                    else local_devices(), dtype=object)
    if time_per_host is None:
        time_per_host = len(devs)
    if len(devs) % time_per_host:
        raise ValueError(f"{len(devs)} devices do not split into rows of "
                         f"{time_per_host}")
    grid = devs.reshape(len(devs) // time_per_host, time_per_host)
    if cross_process_time:
        grid = grid.T
    return Mesh(grid, (ch_axis, time_axis))
