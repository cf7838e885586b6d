"""Channel-parallel receive: a batch of independent FM stations over devices.

Port of ``sdr_tpu/parallel/channel.py``.  Every op of the receiver takes
leading batch dims, so C channels over D devices is a split of the batch
with nothing exchanged on the hot path.  Each device streams its share of
the channels through ``run_blocks``, one block program per device (on the
card a CUDA graph of ``SCAN_BLOCKS`` chained blocks per whole chunk, the
block's graph for the rest); the outputs stay on their devices, as
the JAX package's stay sharded, until :func:`gather_channels` collects
them.  Mesh shards that share a device run as one batch there.  On a mesh
that spans processes each process passes its own channels and runs its own
shards, as the JAX worker's ``make_array_from_process_local_data`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sdr_tpu_torch import config as cfg
from sdr_tpu_torch.models import receiver as rx
from sdr_tpu_torch.parallel.mesh import Mesh


class ChannelShards(NamedTuple):
    """Outputs of :func:`channel_sharded_run`, one entry per shard of this
    process along the mesh axis (every shard, on a mesh of one process):
    ``outputs[i]`` stacked (n_blocks, C/D, out_len) and ``states[i]``
    with batch (C/D,), on that shard's device; the process's shard i holds
    its channel rows i*C/D to (i+1)*C/D."""

    outputs: list
    states: list


def channel_sharded_run(iq_channels: np.ndarray, mesh: Mesh,
                        mode: int | cfg.Mode | cfg.ModeConfig = 0,
                        stereo: bool = True, with_rds: bool = False,
                        block_size: Optional[int] = None,
                        axis: str = "ch") -> ChannelShards:
    """Run C independent channels sharded over ``mesh`` axis ``axis``.

    ``iq_channels``: this process's (C_p, n_samples) interleaved IQ, the
    channels of its shards in axis order (all C on a mesh of one process),
    normalized float or raw uint8 (u8 stays u8 up to the device, where K1
    normalizes it: a quarter of the float bytes).  C_p must be a multiple
    of the process's shard count.  Nothing is exchanged between shards or
    processes.  The PLL kernel is chosen from the global (C, arms) shape,
    C = C_p / (the process's shards) x (the axis size), as the JAX
    package's one program over the whole batch chooses it."""
    mc = (mode if isinstance(mode, cfg.ModeConfig)
          else cfg.get_mode_config(mode))
    with_rds = with_rds and mc.rds is not None
    if block_size is None:
        block_size = mc.default_block_size(with_rds)
    grid = mesh.grid(axis)
    shards = mesh.local_cells(axis)[1]
    devices = [grid[0, d] for d in shards]
    c, n = iq_channels.shape
    if c % len(devices):
        raise ValueError(f"{c} channels do not split over {len(devices)} "
                         f"devices of {axis!r}")
    per = c // len(devices)
    n_blocks = n // block_size
    blocks = np.asarray(iq_channels)[:, : n_blocks * block_size]
    if blocks.dtype != np.uint8:
        blocks = blocks.astype(np.float32)
    # (n_blocks, C, block): the block axis first, as run_blocks takes it
    blocks = np.moveaxis(blocks.reshape(c, n_blocks, block_size), 1, 0)
    fused = rx.fused_mixer_policy(per * grid.shape[1],
                                  int(stereo) + int(with_rds))
    rx.pin_fp32_matmul()

    by_dev: dict[torch.device, list[int]] = {}
    for d, dev in enumerate(devices):
        by_dev.setdefault(dev, []).append(d)
    outputs, states = [None] * len(devices), [None] * len(devices)
    for dev, local in by_dev.items():
        rows = np.concatenate([np.arange(d * per, (d + 1) * per)
                               for d in local])
        x = torch.from_numpy(np.ascontiguousarray(blocks[:, rows])).to(dev)
        outs, st = rx.run_blocks(
            x, rx.design_coeffs(mc, device=dev),
            rx.init_state(mc, (len(rows),), device=dev), mc, stereo,
            with_rds, fused_mixer=fused)
        for i, d in enumerate(local):
            take = slice(i * per, (i + 1) * per)
            outputs[d] = rx.map_state(lambda a: a[:, take], outs)
            states[d] = rx.map_state(lambda a: a[take], st)
    return ChannelShards(outputs, states)


def gather_channels(shards: ChannelShards,
                    device: torch.device | str | None = None
                    ) -> tuple[rx.BlockOutputs, rx.ReceiverState]:
    """This process's channels in order on one ``device`` (default: its
    first shard's): outputs (n_blocks, C_p, out_len) and the (C_p,)-batch
    final state.  Nothing crosses processes."""
    device = torch.device(device) if device is not None else \
        shards.outputs[0].fm_demod.device
    cat = lambda dim: lambda *xs: torch.cat([x.to(device) for x in xs],
                                            dim=dim)
    return (rx.map_state(cat(1), *shards.outputs),
            rx.map_state(cat(0), *shards.states))
