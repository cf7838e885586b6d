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
one process here holds the S shards on the devices of a
:class:`~sdr_tpu_torch.parallel.mesh.Mesh`.  The shards that share a
device run as rows of one batch through the same ``process_block`` as a
contiguous run: on one card, time sharding turns the serial PLL of one
station into S (or C x S) lanes.  The halo exchange is kernel K6
(``parallel.halo``): on CUDA tensors it runs on the card, on CPU tensors
its plain version runs.  The input is normalized float32, so the RF
front-end on this path is K5 (float), as in the JAX package.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from sdr_tpu_torch import config as cfg
from sdr_tpu_torch.models import receiver as rx
from sdr_tpu_torch.parallel import halo as khalo
from sdr_tpu_torch.parallel.mesh import Mesh

_F32 = torch.float32


def default_block_if(mc: cfg.ModeConfig, with_rds: bool = False) -> int:
    """Smallest whole-multiple IF block length >= 5000 samples."""
    mult = mc.if_block_multiple(with_rds)
    return -(-5000 // mult) * mult


class _Group(NamedTuple):
    """The shards on one device: ``cells`` are (b, k) grid positions, each
    ``c_local`` consecutive rows of the device's batch."""

    device: torch.device
    cells: list


class _Shards:
    """Where every shard of a (C, n) recording lives and how it is cut."""

    def __init__(self, iq_shape: tuple, mesh: Mesh, mc: cfg.ModeConfig,
                 stereo: bool, with_rds: bool, overlap_if: Optional[int],
                 axis: str, batch_axis: Optional[str],
                 block_if: Optional[int]):
        self.grid = mesh.grid(axis, batch_axis)
        n_b, self.s = self.grid.shape
        mult = mc.if_block_multiple(with_rds)
        if block_if is None:
            block_if = default_block_if(mc, with_rds)
        if block_if % mult:
            raise ValueError(f"block_if {block_if} is not a multiple of "
                             f"{mult}")
        if overlap_if is None:
            overlap_if = 6000
        # the overlap is whole blocks so that whole steps are discarded
        self.n_skip = -(-overlap_if // block_if)
        self.block_raw = block_if * 2 * mc.rf_decim
        self.halo_raw = self.n_skip * self.block_raw
        n = iq_shape[-1]
        self.seg = n // self.s
        if self.seg * self.s != n:
            raise ValueError(f"a recording of {n} samples does not split "
                             f"evenly across {self.s} shards")
        if self.seg % self.block_raw:
            raise ValueError(f"a segment of {self.seg} raw samples is not a "
                             f"whole number of {self.block_raw}-sample blocks")
        if self.halo_raw > self.seg:
            raise ValueError(f"overlap of {self.halo_raw} raw samples is "
                             f"longer than a segment of {self.seg}")
        self.blocks_per_seg = self.seg // self.block_raw
        self.batched = batch_axis is not None
        self.c = int(iq_shape[0]) if self.batched else 1
        if self.c % n_b:
            raise ValueError(f"{self.c} channels do not split over "
                             f"{n_b} devices of {batch_axis!r}")
        self.c_local = self.c // n_b
        groups: dict[torch.device, list] = {}
        for b in range(n_b):
            for k in range(self.s):
                groups.setdefault(self.grid[b, k], []).append((b, k))
        self.groups = [_Group(d, cells) for d, cells in groups.items()]
        self.where = {cell: (g, j) for g, grp in enumerate(self.groups)
                      for j, cell in enumerate(grp.cells)}
        # the PLL kernel is chosen from the GLOBAL shape: the rows of a
        # device's batch would count S*C lanes and could flip K2 to K3
        arms = int(stereo) + int(with_rds)
        self.fused_mixer = rx.fused_mixer_policy(self.c, arms)
        self.arms = ["fm_demod", "mono"] + (["left", "right"] if stereo
                                            else []) \
            + (["rds_symbols"] if with_rds else [])

    def rows(self, cells: list, segs: np.ndarray, lo: int, hi: int
             ) -> np.ndarray:
        """Samples [lo, hi) of each cell's segment, as (cells*c_local,
        hi-lo) rows; ``segs`` is (C, S, seg)."""
        c = self.c_local
        return np.concatenate([segs[b * c:(b + 1) * c, k, lo:hi]
                               for b, k in cells])

    def halos(self, cells: list, segs: np.ndarray) -> np.ndarray:
        """Each cell's halo sliced on the host: the left segment's tail,
        zeros for shard 0."""
        c = self.c_local
        return np.concatenate([
            segs[b * c:(b + 1) * c, k - 1, -self.halo_raw:] if k else
            np.zeros((c, self.halo_raw), np.float32) for b, k in cells])

    def first_rows(self, group: _Group) -> torch.Tensor:
        """(rows,) mask of the device's batch rows that belong to shard 0."""
        mask = torch.tensor([k == 0 for _, k in group.cells],
                            device=group.device)
        return mask.repeat_interleave(self.c_local)


def _reset_first(state: rx.ReceiverState, fresh: rx.ReceiverState,
                 first: torch.Tensor) -> rx.ReceiverState:
    """Shard 0's zero halo warms its FIR states correctly but walks its
    PLLs (zero input still advances the oscillator): its rows go back to
    the exact fresh state a contiguous run starts from."""
    return rx.map_state(
        lambda f, w: torch.where(first.view((-1,) + (1,) * (w.ndim - 1)),
                                 f, w), fresh, state)


class _Runner:
    """Per device: coefficients, state, and one process_block step over
    the device's batch rows."""

    def __init__(self, sh: _Shards, mc: cfg.ModeConfig, stereo: bool,
                 with_rds: bool):
        self.sh, self.mc, self.stereo, self.with_rds = sh, mc, stereo, with_rds
        self.coeffs = [rx.design_coeffs(mc, device=g.device)
                       for g in sh.groups]
        self.states = [rx.init_state(mc, (len(g.cells) * sh.c_local,),
                                     device=g.device) for g in sh.groups]

    def step(self, blocks: list[torch.Tensor]) -> list[rx.BlockOutputs]:
        """One block on every device (launched device after device, so
        several cards run at once)."""
        outs = []
        for g, blk in enumerate(blocks):
            out, self.states[g] = rx.process_block(
                blk, self.coeffs[g], self.states[g], self.mc,
                stereo=self.stereo, with_rds=self.with_rds,
                fused_mixer=self.sh.fused_mixer)
            outs.append(out)
        return outs

    def warm_up(self, halos: list[torch.Tensor]) -> None:
        """Run the halo blocks (outputs discarded), then reset shard 0."""
        fresh = list(self.states)
        br = self.sh.block_raw
        for b in range(self.sh.n_skip):
            self.step([h[:, b * br:(b + 1) * br] for h in halos])
        self.states = [_reset_first(st, f, self.sh.first_rows(g))
                       for st, f, g in zip(self.states, fresh,
                                           self.sh.groups)]

    def run(self, xs: list[torch.Tensor], n_blocks: int
            ) -> list[dict[str, torch.Tensor]]:
        """``n_blocks`` blocks of every device's (rows, n_blocks*block_raw)
        input; returns per device arm -> (rows, n_blocks*out_per_block)."""
        br = self.sh.block_raw
        per_dev = [[] for _ in xs]
        for b in range(n_blocks):
            for g, out in enumerate(self.step([x[:, b * br:(b + 1) * br]
                                               for x in xs])):
                per_dev[g].append(out)
        return [{a: torch.cat([getattr(o, a) for o in outs], dim=-1)
                 for a in self.sh.arms} for outs in per_dev]


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
    segs = iq.reshape(sh.c, sh.s, sh.seg)
    rx.pin_fp32_matmul()
    return mc, with_rds, sh, segs


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
    axis, and time over ``axis`` (a channel x time grid).  ``overlap_if``
    (default 6000 IF samples: beyond FIR depth, with re-lock runway for
    the pilot PLL) is rounded up to whole blocks.  Each device holds one
    extended buffer [halo | segment] per shard; K6 fills the halos, the
    warm-up runs over them and is discarded, and every block streams
    through ``process_block`` over the device's rows.  Returns the outputs
    laid out exactly like a contiguous run ((n_out,), or (C, n_out)) on
    the mesh's first device; disabled arms are empty."""
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
    khalo.halo_shift_right(
        [[ext[g][j * c:(j + 1) * c] for g, j in
          (sh.where[(b, k)] for k in range(sh.s))]
         for b in range(sh.grid.shape[0])], sh.halo_raw)

    runner = _Runner(sh, mc, stereo, with_rds)
    runner.warm_up([buf[:, :sh.halo_raw] for buf in ext])
    outs = runner.run([buf[:, sh.halo_raw:] for buf in ext],
                      sh.blocks_per_seg)
    return _assemble(sh, outs, mesh.devices.flat[0])


def _assemble(sh: _Shards, outs: list[dict], device: torch.device
              ) -> rx.BlockOutputs:
    """Per-device (rows, T) outputs -> the contiguous layout: channel
    b*c_local + i, time k*T + t for row i of cell (b, k)."""
    c = sh.c_local
    res = {}
    for a in sh.arms:
        t = outs[0][a].shape[-1]
        full = torch.empty((sh.c, sh.s * t), dtype=_F32, device=device)
        for (b, k), (g, j) in sh.where.items():
            full[b * c:(b + 1) * c, k * t:(k + 1) * t] = \
                outs[g][a][j * c:(j + 1) * c].to(device)
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
    bit-identical to it."""
    mc, with_rds, sh, segs = _prepare(iq, mesh, mode, stereo, with_rds,
                                      overlap_if, axis, batch_axis, block_if)
    put = lambda a, grp: torch.from_numpy(a).to(grp.device)
    runner = _Runner(sh, mc, stereo, with_rds)
    runner.warm_up([put(sh.halos(g.cells, segs), g) for g in sh.groups])
    c = sh.c_local
    for k0 in range(0, sh.blocks_per_seg, chunk_blocks):
        k1 = min(k0 + chunk_blocks, sh.blocks_per_seg)
        xs = [put(sh.rows(g.cells, segs, k0 * sh.block_raw,
                          k1 * sh.block_raw), g) for g in sh.groups]
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
