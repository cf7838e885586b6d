"""Scale-out layer: the receiver sharded over devices.

Port of ``sdr_tpu/parallel``.  Two axes:

* **channel parallelism** (``channel``): a batch of independent stations
  split over devices, nothing exchanged on the hot path;
* **time parallelism** (``time_shard``): one long recording split into
  contiguous segments, made comparable to a contiguous run by the halo
  exchange, kernel K6 (``halo``): each shard receives an overlap prefix
  from its left neighbour, warms up its filter and PLL states on it, and
  discards the overlap's outputs.

A :class:`~.mesh.Mesh` names the devices on named axes, and may name one
card several times: the shards of a process that share a card run as rows
of one batch there.  A mesh may span processes: ``multihost.setup`` joins
them in a ``torch.distributed`` group and ``multihost.make_mesh`` lays out
every process's devices as one channel x time grid.  Each process then
passes its own part of the input and runs its own cells; halos that cross
the process edge travel as point-to-point messages
(``time_shard.exchange_edges``), those inside a process by K6.
"""

from sdr_tpu_torch.parallel.channel import (  # noqa: F401
    ChannelShards,
    channel_sharded_run,
    gather_channels,
)
from sdr_tpu_torch.parallel.mesh import Mesh, local_devices  # noqa: F401
from sdr_tpu_torch.parallel.time_shard import (  # noqa: F401
    assemble_time_chunks,
    default_block_if,
    halo_raw,
    time_sharded_receive,
    time_sharded_receive_chunked,
)
