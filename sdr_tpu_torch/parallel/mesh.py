"""Devices on named axes: the port's counterpart of ``jax.sharding.Mesh``.

PyTorch has no mesh object, so the scale-out layer carries its own: an
ndarray of ``torch.device`` with one dimension per axis name, and beside
it the rank of the process that owns each entry (the counterpart of JAX's
``Device.process_index``).  A device may appear more than once: S time
shards on one card (``[cuda:0] * S``), or ``cpu`` S times, named by the
caller, on a machine without a GPU.  The shards of one process that share
a device run as rows of one batch there.

A mesh named without ranks belongs to the process that builds it;
``multihost.make_mesh`` builds one that spans every process of a
``torch.distributed`` group.  Each process runs only its own entries
(:meth:`Mesh.local_cells`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 without
    one (the counterpart of ``jax.process_index()``)."""
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """``devices`` (nested sequences or an ndarray of ``torch.device`` or
    device strings) laid out on ``axis_names``, one name per dimension.
    ``ranks``, of the same shape, names the process that owns each entry;
    without it every entry is this process's (:func:`process_index`)."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        arr = np.array(devices, dtype=object)
        self.devices = np.array([torch.device(d) for d in arr.flat],
                                dtype=object).reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{self.devices.ndim}-D devices need as many "
                             f"axis names, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if ranks is None:
            self.ranks = np.full(arr.shape, process_index(), dtype=np.int64)
        else:
            self.ranks = np.asarray(ranks, dtype=np.int64)
            if self.ranks.shape != arr.shape:
                raise ValueError(f"ranks of shape {self.ranks.shape} for "
                                 f"devices of shape {arr.shape}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return len(np.unique(self.ranks)) > 1

    def _layout(self, arr: np.ndarray, axis: str,
                batch_axis: Optional[str]) -> np.ndarray:
        keep = [axis] if batch_axis is None else [batch_axis, axis]
        for name in keep:
            if name not in self.axis_names:
                raise ValueError(f"mesh axes {self.axis_names} have no "
                                 f"{name!r}")
        idx = tuple(slice(None) if n in keep else 0 for n in self.axis_names)
        rest = [n for n in self.axis_names if n in keep]
        g = arr[idx]
        if rest != keep:
            g = g.T
        return g.reshape(-1, self.shape[axis])

    def grid(self, axis: str, batch_axis: Optional[str] = None
             ) -> np.ndarray:
        """The devices as a (B, S) grid: ``axis`` across, ``batch_axis``
        down (B = 1 without one).  Any other axis replicates, as an
        unnamed axis of a JAX ``PartitionSpec`` does: its first device
        is taken."""
        return self._layout(self.devices, axis, batch_axis)

    def rank_grid(self, axis: str, batch_axis: Optional[str] = None
                  ) -> np.ndarray:
        """The owning ranks in the layout of :meth:`grid`."""
        return self._layout(self.ranks, axis, batch_axis)

    def local_cells(self, axis: str, batch_axis: Optional[str] = None
                    ) -> tuple[range, range]:
        """The cells of the (B, S) grid of :meth:`grid` that this process
        owns, as (rows, shards); the devices they run on are those of the
        grid.  Raises ValueError unless they form one block: this process's
        input is its rows over its time span."""
        mine = self.rank_grid(axis, batch_axis) == process_index()
        rows = np.flatnonzero(mine.any(axis=1))
        cols = np.flatnonzero(mine.any(axis=0))
        if not rows.size:
            raise ValueError(f"process {process_index()} owns no cell of "
                             f"{self!r}")
        block = (range(int(rows[0]), int(rows[-1]) + 1),
                 range(int(cols[0]), int(cols[-1]) + 1))
        if not mine[block[0].start:block[0].stop,
                    block[1].start:block[1].stop].all():
            raise ValueError(f"the cells of process {process_index()} in "
                             f"{self!r} are not one block of rows and "
                             "shards")
        return block

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}, "
                f"ranks={self.ranks.ravel().tolist()})")


def local_devices() -> list[torch.device]:
    """This process's CUDA devices.  Raises RuntimeError on a machine
    without any: a CPU caller names its devices (``Mesh(["cpu"] * S,
    ...)``, or ``make_mesh(devices=[...])``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: name the devices "
                           "of a CPU mesh explicitly, e.g. ['cpu'] * S")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]
