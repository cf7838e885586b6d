"""Devices on named axes: the port's counterpart of ``jax.sharding.Mesh``.

PyTorch has no mesh object, so the scale-out layer carries its own: an
ndarray of ``torch.device`` with one dimension per axis name.  A device may
appear more than once: S time shards on one card (``[cuda:0] * S``), or
``cpu`` S times on a machine without a GPU.  One process drives every
shard, and the shards that share a device run as rows of one batch there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """``devices`` (nested sequences or an ndarray of ``torch.device`` or
    device strings) laid out on ``axis_names``, one name per dimension."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.array(devices, dtype=object)
        self.devices = np.array([torch.device(d) for d in arr.flat],
                                dtype=object).reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{self.devices.ndim}-D devices need as many "
                             f"axis names, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def grid(self, axis: str, batch_axis: Optional[str] = None
             ) -> np.ndarray:
        """The devices as a (B, S) grid: ``axis`` across, ``batch_axis``
        down (B = 1 without one).  Any other axis replicates, as an
        unnamed axis of a JAX ``PartitionSpec`` does: its first device
        is taken."""
        keep = [axis] if batch_axis is None else [batch_axis, axis]
        for name in keep:
            if name not in self.axis_names:
                raise ValueError(f"mesh axes {self.axis_names} have no "
                                 f"{name!r}")
        idx = tuple(slice(None) if n in keep else 0 for n in self.axis_names)
        rest = [n for n in self.axis_names if n in keep]
        g = self.devices[idx]
        if rest != keep:
            g = g.T
        return g.reshape(-1, self.shape[axis])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def local_devices() -> list[torch.device]:
    """This process's CUDA devices; ``[cpu]`` on a machine without any."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]
