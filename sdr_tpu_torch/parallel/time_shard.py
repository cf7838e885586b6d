"""Time-parallel receive: one recording split into S shards with a halo.

Port of ``sdr_tpu/parallel/time_shard.py``.  Every stateful op of the
receiver carries a small trailing-input state, so a shard that starts with
the right input prefix from its left neighbour (the halo) starts with the
state a contiguous run would hand it:

* **linear/FIR state** (FIR tails, demod last-IQ, allpass delay) is fully
  determined by the last few input samples: exact after the warm-up;
* the **PLLs** are recurrences over the whole past.  The overlap gives them
  a re-lock runway; after lock they track the same pilot, so the kept
  outputs agree to PLL-tracking tolerance, not bit for bit.

The overlap is rounded up to whole blocks, its outputs are discarded, and
shard 0 (whose halo is zeros) is reset to the exact fresh state after its
warm-up, so it matches a contiguous run from sample 0.

Where the JAX package runs one ``shard_map`` program over a device mesh,
each process here runs its own cells of a
:class:`~sdr_tpu_torch.parallel.mesh.Mesh` (all of them on a mesh of one
process).  The shards that share a device run as rows of one batch through
the same block program as a contiguous run: on one card, time sharding
turns the serial PLL of one station into S (or C x S) lanes.  The halo
exchange inside a process is kernel K6 (``parallel.halo``; one launch per
card, the shards of one card handed over as row blocks of one buffer): on
CUDA tensors it runs on the card, on CPU tensors its plain version runs.
Where a time row crosses the process edge, the left process sends its last
shard's tail to the right one as ``torch.distributed`` point-to-point
(:func:`exchange_edges`), which overwrites the zeros K6 gave that
process's first shard.  The input is normalized float32, so the RF
front-end on this path is K5 (float), as in the JAX package.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from sdr_tpu_torch import config as cfg
from sdr_tpu_torch.models import receiver as rx
from sdr_tpu_torch.parallel import halo as khalo
from sdr_tpu_torch.parallel.mesh import Mesh

_F32 = torch.float32


def default_block_if(mc: cfg.ModeConfig, with_rds: bool = False) -> int:
    """Smallest whole-multiple IF block length >= 5000 samples."""
    mult = mc.if_block_multiple(with_rds)
    return -(-5000 // mult) * mult


def halo_raw(mc: cfg.ModeConfig, block_if: int,
             overlap_if: Optional[int] = None) -> int:
    """Raw samples of a shard's halo: the overlap (default 6000 IF
    samples) rounded up to whole ``block_if``-IF blocks."""
    overlap_if = 6000 if overlap_if is None else overlap_if
    return -(-overlap_if // block_if) * block_if * 2 * mc.rf_decim


class _Group(NamedTuple):
    """The shards on one device: ``cells`` are (b, k) grid positions, each
    ``c_local`` consecutive rows of the device's batch."""

    device: torch.device
    cells: list


class _Shards:
    """Where every shard of a (C, n) recording lives and how it is cut.

    ``iq_shape`` is this process's part: its rows of the (B, S) grid
    (``rows_b``) over its time span (shards ``cols``), from which the
    global C and n follow."""

    def __init__(self, iq_shape: tuple, mesh: Mesh, mc: cfg.ModeConfig,
                 stereo: bool, with_rds: bool, overlap_if: Optional[int],
                 axis: str, batch_axis: Optional[str],
                 block_if: Optional[int]):
        self.grid = mesh.grid(axis, batch_axis)
        self.rows_b, self.cols = mesh.local_cells(axis, batch_axis)
        n_b, self.s = self.grid.shape
        mult = mc.if_block_multiple(with_rds)
        if block_if is None:
            block_if = default_block_if(mc, with_rds)
        if block_if % mult:
            raise ValueError(f"block_if {block_if} is not a multiple of "
                             f"{mult}")
        # the overlap is whole blocks so that whole steps are discarded
        self.block_raw = block_if * 2 * mc.rf_decim
        self.halo_raw = halo_raw(mc, block_if, overlap_if)
        self.n_skip = self.halo_raw // self.block_raw
        n = iq_shape[-1]
        self.seg = n // len(self.cols)
        if self.seg * len(self.cols) != n:
            raise ValueError(f"a recording of {n} samples does not split "
                             f"evenly across {len(self.cols)} shards")
        if self.seg % self.block_raw:
            raise ValueError(f"a segment of {self.seg} raw samples is not a "
                             f"whole number of {self.block_raw}-sample blocks")
        if self.halo_raw > self.seg:
            raise ValueError(f"overlap of {self.halo_raw} raw samples is "
                             f"longer than a segment of {self.seg}")
        self.blocks_per_seg = self.seg // self.block_raw
        self.batched = batch_axis is not None
        c_here = int(iq_shape[0]) if self.batched else 1
        if c_here % len(self.rows_b):
            raise ValueError(f"{c_here} channels do not split over "
                             f"{len(self.rows_b)} devices of {batch_axis!r}")
        self.c_local = c_here // len(self.rows_b)
        self.c = self.c_local * n_b
        groups: dict[torch.device, list] = {}
        for b in self.rows_b:
            for k in self.cols:
                groups.setdefault(self.grid[b, k], []).append((b, k))
        self.groups = [_Group(d, cells) for d, cells in groups.items()]
        self.where = {cell: (g, j) for g, grp in enumerate(self.groups)
                      for j, cell in enumerate(grp.cells)}
        # the PLL kernel is chosen from the GLOBAL shape: the rows of a
        # device's batch would count S*C lanes and could flip K2 to K3,
        # and a process's own rows would count fewer
        arms = int(stereo) + int(with_rds)
        self.fused_mixer = rx.fused_mixer_policy(self.c, arms)
        self.arms = ["fm_demod", "mono"] + (["left", "right"] if stereo
                                            else []) \
            + (["rds_symbols"] if with_rds else [])

    def local(self, cell: tuple[int, int]) -> tuple[slice, int]:
        """Rows and shard of ``cell`` in this process's (C_p, S_p, seg)
        input."""
        b, k = cell
        i = b - self.rows_b.start
        return slice(i * self.c_local, (i + 1) * self.c_local), \
            k - self.cols.start

    def rows(self, cells: list, segs: np.ndarray, lo: int, hi: int
             ) -> np.ndarray:
        """Samples [lo, hi) of each cell's segment, as (cells*c_local,
        hi-lo) rows; ``segs`` is this process's (C_p, S_p, seg)."""
        return np.concatenate([segs[r, k, lo:hi]
                               for r, k in map(self.local, cells)])

    def halos(self, cells: list, segs: np.ndarray) -> np.ndarray:
        """Each cell's halo sliced on the host: the left segment's tail,
        zeros for shard 0."""
        return np.concatenate([
            segs[r, k - 1, -self.halo_raw:] if k else
            np.zeros((self.c_local, self.halo_raw), np.float32)
            for r, k in map(self.local, cells)])

    def first_rows(self, group: _Group) -> torch.Tensor:
        """(rows,) mask of the device's batch rows that belong to global
        shard 0."""
        mask = torch.tensor([k == 0 for _, k in group.cells],
                            device=group.device)
        return mask.repeat_interleave(self.c_local)


def edge_peers(mesh: Mesh, axis: str = "time",
               batch_axis: Optional[str] = None) -> tuple[list, list]:
    """The halos of this process's cells that cross the process edge, per
    time row b of :meth:`Mesh.grid`: (b, peer rank) pairs of the tails it
    sends (its last shard's, to the owner of the next shard) and of the
    halo slots it receives (its first shard's, from the owner of the
    previous one)."""
    ranks = mesh.rank_grid(axis, batch_axis)
    rows, cols = mesh.local_cells(axis, batch_axis)
    sends = [(b, int(ranks[b, cols[-1] + 1])) for b in rows
             if cols[-1] + 1 < ranks.shape[1]]
    recvs = [(b, int(ranks[b, cols[0] - 1])) for b in rows if cols[0] > 0]
    return sends, recvs


def _reset_first(state: rx.ReceiverState, fresh: rx.ReceiverState,
                 first: torch.Tensor) -> rx.ReceiverState:
    """Shard 0's zero halo warms its FIR states correctly but walks its
    PLLs (zero input still advances the oscillator): its rows go back to
    the exact fresh state a contiguous run starts from."""
    return rx.map_state(
        lambda f, w: torch.where(first.view((-1,) + (1,) * (w.ndim - 1)),
                                 f, w), fresh, state)


def _block_major(x: torch.Tensor, n_blocks: int, block: int
                 ) -> torch.Tensor:
    """The (n_blocks, rows, block) view of a (rows, >= n_blocks*block)
    buffer's first blocks.  Its one copy into (K, rows, block) layout per
    chunk is the chunk graph's input copy (``Program.scan``)."""
    return x[:, :n_blocks * block].reshape(
        x.shape[0], n_blocks, block).movedim(1, 0)


class _Runner:
    """Per device: coefficients, state, and one block program
    (``models.receiver.make_block_fn``) over the device's batch rows: the
    counterpart of the JAX package's jitted time-sharded step and of its
    two scans, the warm-up and the body (``_scan_blocks`` in the chunked
    form).  Each scan is a chunk graph (``Program.scan``,
    ``receiver.run_span``).  K6 and the edge exchange run outside the
    programs, once per call."""

    def __init__(self, sh: _Shards, mc: cfg.ModeConfig, stereo: bool,
                 with_rds: bool):
        self.sh, self.mc = sh, mc
        self.coeffs = [rx.design_coeffs(mc, device=g.device)
                       for g in sh.groups]
        self.states = [self.fresh(g) for g in sh.groups]
        self.fns = [rx.make_block_fn(mc, stereo, with_rds,
                                     fused_mixer=sh.fused_mixer)
                    for _ in sh.groups]

    def fresh(self, g: _Group) -> rx.ReceiverState:
        return rx.init_state(self.mc, (len(g.cells) * self.sh.c_local,),
                             device=g.device)

    def step(self, blocks: list[torch.Tensor]) -> list[rx.BlockOutputs]:
        """Blocks (m, rows, block_raw) on every device: one replay each
        (``receiver.run_span``), launched device after device without
        waiting, so several cards run at once; outputs stacked (m, rows,
        out)."""
        outs = []
        for g, blk in enumerate(blocks):
            out, self.states[g] = rx.run_span(self.fns[g], blk,
                                              self.coeffs[g], self.states[g])
            outs.append(out)
        return outs

    def warm_up(self, halos: list[torch.Tensor]) -> None:
        """Run the halo blocks as one graph of the ``n_skip`` blocks a
        device (outputs discarded), then reset shard 0 to a fresh state
        made anew, not one kept from before the warm-up: a state the
        programs returned is their own buffers, which every step overwrites
        in place (the state is donated)."""
        self.step([_block_major(h, self.sh.n_skip, self.sh.block_raw)
                   for h in halos])
        self.states = [_reset_first(st, self.fresh(g), self.sh.first_rows(g))
                       for st, g in zip(self.states, self.sh.groups)]

    def run(self, xs: list[torch.Tensor], n_blocks: int
            ) -> list[dict[str, torch.Tensor]]:
        """``n_blocks`` blocks of every device's (rows, n_blocks*block_raw)
        input, on the device or the host, in chunks of
        ``receiver.SCAN_BLOCKS`` (``receiver.block_spans``); returns per
        device arm -> (rows, n_blocks*out_per_block)."""
        blocks = [_block_major(x, n_blocks, self.sh.block_raw) for x in xs]
        per_dev = [[] for _ in xs]
        for span in rx.block_spans(n_blocks):
            for g, out in enumerate(self.step([b[span] for b in blocks])):
                per_dev[g].append(out)
        return [{a: torch.cat([getattr(o, a) for o in outs]).movedim(0, 1)
                 .reshape(len(x), -1) for a in self.sh.arms}
                for outs, x in zip(per_dev, xs)]


def _prepare(iq, mesh: Mesh, mode, stereo: bool, with_rds: bool,
             overlap_if, axis: str, batch_axis, block_if):
    mc = cfg.get_mode_config(mode) if not isinstance(
        mode, cfg.ModeConfig) else mode
    with_rds = with_rds and mc.rds is not None
    iq = np.asarray(iq, dtype=np.float32)
    if (iq.ndim == 2) != (batch_axis is not None):
        raise ValueError(f"iq of shape {iq.shape}: (n,) without a batch "
                         "axis, (C, n) with one")
    sh = _Shards(iq.shape, mesh, mc, stereo, with_rds, overlap_if, axis,
                 batch_axis, block_if)
    segs = iq.reshape(len(sh.rows_b) * sh.c_local, len(sh.cols), sh.seg)
    rx.pin_fp32_matmul()
    return mc, with_rds, sh, segs


def _staging(like: torch.Tensor, nccl: bool) -> torch.Tensor:
    """A contiguous buffer for one edge message: for NCCL on the card the
    group is bound to (the process's current device: one communicator for
    all of its messages, whichever of its cards a shard is on), for gloo
    in host memory, pinned when ``like`` is on a card."""
    if nccl:
        return torch.empty(like.shape, dtype=like.dtype, device=torch.device(
            "cuda", torch.cuda.current_device()))
    return torch.empty(like.shape, dtype=like.dtype,
                       pin_memory=like.device.type == "cuda")


def exchange_edges(sends: list, recvs: list) -> None:
    """The halos that cross the process edge, as ``torch.distributed``
    point-to-point: ``sends`` are (tail, peer rank, tag) and ``recvs``
    (halo slot, peer rank, tag), where a tag names the time row, so that
    the messages of one pair of processes match row by row.  Tails and
    slots may be strided views on any of the process's devices: each
    message goes through a contiguous staging buffer chosen by the group's
    backend, on the card for NCCL, in host memory for gloo (whose TCP
    transport cannot read a card's memory).  Every process whose mesh row
    crosses an edge calls this once per call of
    :func:`time_sharded_receive`."""
    nccl = dist.get_backend() == "nccl"
    ops, landed = [], []
    for tail, peer, tag in sends:
        buf = _staging(tail, nccl)
        buf.copy_(tail)
        ops.append(dist.P2POp(dist.isend, buf, peer, tag=tag))
    for slot, peer, tag in recvs:
        buf = _staging(slot, nccl)
        ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
        landed.append((slot, buf))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for slot, buf in landed:
        slot.copy_(buf)
    exchange_edges.messages += len(ops)


# messages sent or received across the process edge, in this process
exchange_edges.messages = 0


def time_sharded_receive(iq: np.ndarray, mesh: Mesh,
                         mode: int | cfg.Mode | cfg.ModeConfig = 0,
                         stereo: bool = True, with_rds: bool = False,
                         overlap_if: Optional[int] = None,
                         axis: str = "time",
                         batch_axis: Optional[str] = None,
                         block_if: Optional[int] = None) -> rx.BlockOutputs:
    """Process one recording time-sharded over ``mesh`` axis ``axis``.

    ``iq``: (n,) normalized interleaved IQ; n must split into S =
    ``mesh.shape[axis]`` segments of whole ``block_if``-IF blocks.  With
    ``batch_axis`` set, ``iq`` is (C, n): a channel batch split over that
    axis, and time over ``axis`` (a channel x time grid).  On a mesh that
    spans processes each process passes only its part, its rows over its
    time span (:meth:`~sdr_tpu_torch.parallel.mesh.Mesh.local_cells`),
    and the global C and n follow from the mesh.  ``overlap_if`` (default
    6000 IF samples: beyond FIR depth, with re-lock runway for the pilot
    PLL) is rounded up to whole blocks.  Each device holds one extended
    buffer [halo | segment] per shard; K6 fills the halos inside the
    process, :func:`exchange_edges` those across its edge, the warm-up
    runs over them (one graph of the halo blocks a device) and is
    discarded, and the blocks stream through the device's block program
    over its rows, a chunk graph per ``receiver.SCAN_BLOCKS`` blocks.  Returns this process's
    outputs laid out exactly like a contiguous run of its part ((n_out,),
    or (C_p, n_out)) on its first device; disabled arms are empty."""
    mc, with_rds, sh, segs = _prepare(iq, mesh, mode, stereo, with_rds,
                                      overlap_if, axis, batch_axis, block_if)
    length = sh.halo_raw + sh.seg
    ext = []
    for grp in sh.groups:
        buf = torch.empty((len(grp.cells) * sh.c_local, length), dtype=_F32,
                          device=grp.device)
        buf[:, sh.halo_raw:].copy_(torch.from_numpy(
            sh.rows(grp.cells, segs, 0, sh.seg)))
        ext.append(buf)
    c = sh.c_local

    def cell(bk: tuple[int, int]) -> torch.Tensor:
        g, j = sh.where[bk]
        return ext[g][j * c:(j + 1) * c]

    if len(ext) == 1:
        # one device: its cells (b, k), in order, are row blocks of ext[0]
        khalo.halo_shift_right(
            ext[0].view(len(sh.rows_b), len(sh.cols), c, length),
            sh.halo_raw)
    else:
        khalo.halo_shift_right([[cell((b, k)) for k in sh.cols]
                                for b in sh.rows_b], sh.halo_raw)
    sends, recvs = edge_peers(mesh, axis, batch_axis)
    if sends or recvs:
        if not dist.is_initialized():
            raise RuntimeError(f"{mesh!r} spans processes: its halos cross "
                               "the process edge, which needs the "
                               "torch.distributed group (multihost.setup)")
        # K6 gave this process's first shards zeros, as to global shard 0;
        # the left process's tails overwrite them
        k0, k1 = sh.cols[0], sh.cols[-1]
        exchange_edges(
            [(cell((b, k1))[:, -sh.halo_raw:], peer, b) for b, peer in sends],
            [(cell((b, k0))[:, :sh.halo_raw], peer, b) for b, peer in recvs])

    runner = _Runner(sh, mc, stereo, with_rds)
    runner.warm_up([buf[:, :sh.halo_raw] for buf in ext])
    outs = runner.run([buf[:, sh.halo_raw:] for buf in ext],
                      sh.blocks_per_seg)
    return _assemble(sh, outs, sh.groups[0].device)


def _assemble(sh: _Shards, outs: list[dict], device: torch.device
              ) -> rx.BlockOutputs:
    """Per-device (rows, T) outputs -> the contiguous layout of this
    process's part: row i of cell (b, k) at local channel r*c_local + i and
    time k'*T + t, with (r, k') the cell's place in the part."""
    res = {}
    for a in sh.arms:
        t = outs[0][a].shape[-1]
        full = torch.empty((len(sh.rows_b) * sh.c_local, len(sh.cols) * t),
                           dtype=_F32, device=device)
        for cell, (g, j) in sh.where.items():
            rows, k = sh.local(cell)
            full[rows, k * t:(k + 1) * t] = \
                outs[g][a][j * sh.c_local:(j + 1) * sh.c_local].to(device)
        res[a] = full if sh.batched else full[0]
    empty = torch.zeros((0,), dtype=_F32, device=device)
    return rx.BlockOutputs(**{f: res.get(f, empty)
                              for f in rx.BlockOutputs._fields})


def time_sharded_receive_chunked(iq: np.ndarray, mesh: Mesh,
                                 mode: int | cfg.Mode | cfg.ModeConfig = 0,
                                 stereo: bool = True,
                                 with_rds: bool = False,
                                 overlap_if: Optional[int] = None,
                                 axis: str = "time",
                                 batch_axis: Optional[str] = None,
                                 block_if: Optional[int] = None,
                                 chunk_blocks: int = 32
                                 ) -> Iterator[dict[str, np.ndarray]]:
    """Chunk-streaming variant of :func:`time_sharded_receive`.

    Yields one dict per chunk of ``chunk_blocks`` blocks: arm name -> host
    numpy of shape (S, [C,] chunk*out_per_block).  Device memory is
    O(S x chunk) however long the recording.  The halos are sliced on the
    host (the same values K6 delivers, so this path needs no K6), and the
    same rows, blocks, shard-0 reset and pinned PLL kernel as the
    single-shot path run, so :func:`assemble_time_chunks` of the chunks is
    bit-identical to it.  The host array holds the whole recording, so the
    mesh must be one process's, as in the JAX package: a mesh that spans
    processes raises ValueError."""
    if mesh.spans_processes:
        raise ValueError(f"{mesh!r} spans processes: the chunked path slices "
                         "its halos from one host array; use "
                         "time_sharded_receive")
    mc, with_rds, sh, segs = _prepare(iq, mesh, mode, stereo, with_rds,
                                      overlap_if, axis, batch_axis, block_if)
    return _chunks(mc, stereo, with_rds, sh, segs, chunk_blocks)


def _chunks(mc: cfg.ModeConfig, stereo: bool, with_rds: bool, sh: _Shards,
            segs: np.ndarray, chunk_blocks: int
            ) -> Iterator[dict[str, np.ndarray]]:
    # the halos and rows stay on the host: the programs copy each chunk of
    # blocks into their static inputs (through pinned staging)
    runner = _Runner(sh, mc, stereo, with_rds)
    runner.warm_up([torch.from_numpy(sh.halos(g.cells, segs))
                    for g in sh.groups])
    c = sh.c_local
    for k0 in range(0, sh.blocks_per_seg, chunk_blocks):
        k1 = min(k0 + chunk_blocks, sh.blocks_per_seg)
        xs = [torch.from_numpy(sh.rows(g.cells, segs, k0 * sh.block_raw,
                                       k1 * sh.block_raw))
              for g in sh.groups]
        outs = [{a: v.cpu().numpy() for a, v in o.items()}
                for o in runner.run(xs, k1 - k0)]
        chunk = {}
        for a in sh.arms:
            arr = np.empty((sh.s, sh.c, outs[0][a].shape[-1]), np.float32)
            for (b, k), (g, j) in sh.where.items():
                arr[k, b * c:(b + 1) * c] = outs[g][a][j * c:(j + 1) * c]
            chunk[a] = arr if sh.batched else arr[:, 0]
        yield chunk


def assemble_time_chunks(chunks: list[dict]) -> dict:
    """Reassemble :func:`time_sharded_receive_chunked` outputs into the
    single-shot layout: arm -> ([C,] S*total_per) with shard-major time,
    exactly like :func:`time_sharded_receive`."""
    out = {}
    for a in chunks[0]:
        cat = np.concatenate([c[a] for c in chunks], axis=-1)  # (S,[C],T)
        flat = np.moveaxis(cat, 0, -2)                         # ([C],S,T)
        out[a] = flat.reshape(flat.shape[:-2] + (-1,))
    return out
