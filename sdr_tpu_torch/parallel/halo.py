"""Halo exchange of time sharding: kernel K6 and its plain version.

Port of ``sdr_tpu/parallel/pallas_halo.py`` (the kernel
``halo_shift_right``).  Semantics, as ``lax.ppermute(x, axis, [(i, i+1)
for i in range(S-1)])`` within each row of any other mesh axes: shard k
receives shard k-1's trailing ``halo`` samples, shard 0 receives zeros.

Every shard owns an extended buffer ``[halo | segment]`` ((rows, L) or
(L,), float32, time last): its segment in the suffix, its halo slot in the
prefix.  :func:`halo_shift_right` fills every halo slot in place and takes
the buffers in either of two forms:

* one tensor (T, S, rows, L): T time rows of S shards, each shard a block
  of channel rows, all on one device, as ``time_sharded_receive`` lays out
  a card's shards.  Its strides describe every buffer (:class:`RowBlocks`),
  so where its addresses and lengths are 16-byte multiples
  (:func:`bulk_aligned`) the kernel's row-block entry takes them as ten
  integers; any other layout takes the table entry;
* time rows as lists (each the S shard buffers in time order, on any
  devices): the table entry, one launch per card for all of that card's
  shards, a left neighbour on another card read through peer access.

On CPU tensors it runs the plain version (:func:`halo_shift_right_plain`).
The JAX kernel takes 1-D meshes only (a limit of JAX's DMA lowering); this
one shifts within every row of a channel x time grid.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Union

import torch

from sdr_tpu_torch.kernels import build

_MAX_SHARDS = 64              # table entries per launch (csrc/halo.cu)
_PEER_UNSUPPORTED = 217       # cudaErrorPeerAccessUnsupported
_MAX_ROW_BLOCKS = 65535       # time rows x shards x rows per launch
# (device, peer) pairs with peer access on: a property of the process's
# CUDA contexts, so it is kept per process
_peers_enabled: set[tuple[int, int]] = set()

Rows = Sequence[Sequence[torch.Tensor]]


class RowBlocks(NamedTuple):
    """Shard buffers as equally spaced row blocks: row r of shard k of time
    row b starts ``b * group_stride + k * shard_stride + r * row_stride``
    floats after ``ptr`` (an address, as ``data_ptr()`` gives it), and each
    is ``length`` floats long, the halo slot its first ``n``."""

    ptr: int
    time_rows: int
    shards: int
    rows: int
    n: int
    length: int
    row_stride: int
    shard_stride: int
    group_stride: int

    def offsets(self, b: int, k: int, r: int) -> tuple[Optional[int], int]:
        """(source, destination) addresses of row r of shard k of time row
        b: the left neighbour's tail (None for shard 0: zeros) and this
        row's halo slot."""
        dst = self.ptr + 4 * (b * self.group_stride + k * self.shard_stride
                              + r * self.row_stride)
        src = (dst - 4 * (self.shard_stride - self.length + self.n)
               if k else None)
        return src, dst


def _disjoint(rb: RowBlocks) -> bool:
    """The buffers of ``rb`` do not overlap: each shard's rows lie inside
    its shard stride, each time row's shards inside its group stride."""
    span = (rb.rows - 1) * rb.row_stride + rb.length
    if rb.rows > 1 and rb.row_stride < rb.length:
        return False
    if rb.shards > 1 and rb.shard_stride < span:
        return False
    return rb.time_rows == 1 or rb.group_stride >= (
        (rb.shards - 1) * rb.shard_stride + span)


def row_blocks_of(buf: torch.Tensor, halo: int) -> RowBlocks:
    """The :class:`RowBlocks` of a (T, S, rows, L) float32 tensor; raises
    on what the kernel does not take."""
    if buf.dtype != torch.float32:
        raise TypeError(f"shard buffers must be float32, got {buf.dtype}")
    if buf.ndim != 4 or buf.stride(3) != 1:
        raise ValueError(f"a (time rows, shards, rows, L) tensor with unit "
                         f"time stride is needed, got shape "
                         f"{tuple(buf.shape)}, strides {buf.stride()}")
    t, s, c, length = buf.shape
    if not 0 < halo <= length - halo:
        raise ValueError(f"halo {halo} must be positive and no longer than "
                         f"the segment ({length} - halo)")
    st = buf.stride()
    # the stride of a dimension of size 1 is never used
    rb = RowBlocks(buf.data_ptr(), t, s, c, halo, length,
                   st[2] if c > 1 else length, st[1] if s > 1 else 0,
                   st[0] if t > 1 else 0)
    if min(rb.row_stride, rb.shard_stride, rb.group_stride) < 0 \
            or not _disjoint(rb):
        raise ValueError(f"shard buffers of strides {st} overlap")
    return rb


def bulk_aligned(rb: RowBlocks) -> bool:
    """Whether K6's row-block entry takes ``rb``: its bulk copies move
    16-byte multiples between 16-byte aligned addresses."""
    return rb.ptr % 16 == 0 and not (rb.n | rb.length | rb.row_stride
                                     | rb.shard_stride | rb.group_stride) % 4


def _shard_views(buf: torch.Tensor) -> list[list[torch.Tensor]]:
    """The time rows of shard buffers of a (T, S, rows, L) tensor, as the
    table entry takes them."""
    return [[buf[b, k] for k in range(buf.shape[1])]
            for b in range(buf.shape[0])]


def halo_fill_blocks_plain(buf: torch.Tensor, halo: int) -> None:
    """The plain version in place on a (T, S, rows, L) tensor."""
    buf[:, 1:, :, :halo].copy_(buf[:, :-1, :, buf.shape[-1] - halo:])
    buf[:, 0, :, :halo] = 0.0


def halo_shift_right_plain(tails: Sequence[torch.Tensor]
                           ) -> list[torch.Tensor]:
    """Plain version of K6 over one time row: zeros for shard 0 and
    ``tails[k-1]`` on shard k's device (``tails[k].device``) for shard k."""
    return [torch.zeros_like(tails[0])] + [
        tails[k - 1].to(tails[k].device) for k in range(1, len(tails))]


def halo_fill_plain(rows: Rows, halo: int) -> None:
    """The plain version applied in place to shard buffers laid out as
    :func:`halo_shift_right` takes them: what it does on CPU tensors, and
    its reference on the card."""
    for row in rows:
        halos = halo_shift_right_plain([b[..., -halo:] for b in row])
        for buf, h in zip(row, halos):
            buf[..., :halo].copy_(h)


def _check(rows: Rows, halo: int) -> str:
    """Validate the shard buffers; returns their device type."""
    bufs = [b for row in rows for b in row]
    if not bufs:
        raise ValueError("no shard buffers")
    first = bufs[0]
    for b in bufs:
        if b.dtype != torch.float32:
            raise TypeError(f"shard buffers must be float32, got {b.dtype}")
        if b.shape != first.shape or b.ndim not in (1, 2):
            raise ValueError(f"shard buffers must share one (rows, L) or (L,)"
                             f" shape, got {tuple(b.shape)} and "
                             f"{tuple(first.shape)}")
        if b.stride(-1) != 1 or (b.ndim == 2 and b.shape[0] > 1
                                 and b.stride(0) != first.stride(0)):
            raise ValueError("a halo slot is not contiguous: every buffer "
                             "needs unit stride in time and one row stride")
    kinds = {b.device.type for b in bufs}
    if len(kinds) != 1:
        raise ValueError(f"shard buffers mix device types {sorted(kinds)}")
    length = first.shape[-1]
    if not 0 < halo <= length - halo:
        raise ValueError(f"halo {halo} must be positive and no longer than "
                         f"the segment ({length} - halo)")
    return kinds.pop()


def _enable_peer(lib, device: int, peer: int) -> None:
    """Once per pair: let ``device`` read ``peer``'s memory."""
    if (device, peer) in _peers_enabled:
        return
    rc = lib.sdr_halo_enable_peer(device, peer)
    if rc == _PEER_UNSUPPORTED:
        raise RuntimeError(f"cuda:{device} cannot access the memory of "
                           f"cuda:{peer} (cudaDeviceCanAccessPeer says no): "
                           "K6 cannot read a left neighbour there")
    build.check(rc, "sdr_halo_enable_peer")
    _peers_enabled.add((device, peer))


def _launch_table(rows: Rows, halo: int) -> int:
    """Launch K6's table entry over CUDA shard buffers checked by
    :func:`_check`: one launch per card for up to 64 of its shards, on that
    card's current stream.  A tail on another card is ordered by an event
    on its card's current stream, and that stream then waits for the
    launch before it may reuse the memory.  Returns the number of
    launches."""
    first = rows[0][0]
    n_rows = first.shape[0] if first.ndim == 2 else 1
    stride = first.stride(0) if first.ndim == 2 else 0
    by_card: dict[int, list] = {}
    for row in rows:
        for k, buf in enumerate(row):
            src = row[k - 1][..., -halo:] if k else None
            by_card.setdefault(buf.device.index, []).append((src, buf))
    lib = build.load()
    n_launches = 0
    for card, entries in by_card.items():
        peers = sorted({src.device.index for src, _ in entries
                        if src is not None and src.device.index != card})
        for peer in peers:
            _enable_peer(lib, card, peer)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(peer))
            torch.cuda.current_stream(card).wait_event(ready)
        stream = build.current_stream(card)
        for i in range(0, len(entries), _MAX_SHARDS):
            part = entries[i:i + _MAX_SHARDS]
            table = ctypes.c_void_p * len(part)
            src = table(*[None if s is None else s.data_ptr()
                          for s, _ in part])
            dst = table(*[d.data_ptr() for _, d in part])
            rc = lib.sdr_halo_shift(card, src, dst, len(part), n_rows, halo,
                                    stride, stride, stream)
            build.check(rc, "sdr_halo_shift")
            n_launches += 1
        if peers:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(card))
            for peer in peers:
                torch.cuda.current_stream(peer).wait_event(done)
    return n_launches


def launch_row_blocks(rb: RowBlocks, device: int) -> None:
    """One launch of K6's row-block entry on CUDA device ``device``, on its
    current stream; ``rb`` must be :func:`bulk_aligned`.  Counts nothing:
    :func:`halo_shift_right` counts."""
    if rb.time_rows * rb.shards * rb.rows > _MAX_ROW_BLOCKS:
        raise ValueError(f"{rb.time_rows} x {rb.shards} x {rb.rows} rows "
                         f"exceed {_MAX_ROW_BLOCKS} per launch")
    rc = build.load().sdr_halo_shift_rows(
        device, rb.ptr, rb.time_rows, rb.shards, rb.rows, rb.n, rb.length,
        rb.row_stride, rb.shard_stride, rb.group_stride,
        build.current_stream(device))
    build.check(rc, "sdr_halo_shift_rows")


def halo_shift_right(rows: Union[Rows, torch.Tensor], halo: int) -> None:
    """K6, in place: within every time row, shard k's first ``halo``
    samples become shard k-1's last ``halo`` samples, and shard 0's become
    zeros.  ``rows``: a (T, S, rows, L) tensor, or time rows as lists of
    shard buffers (see the module docstring).

    CUDA tensors launch the kernel (the row-block entry for a tensor whose
    layout is :func:`bulk_aligned`, else the table entry) and CPU tensors
    take the plain version; a mix, or any other device, raises."""
    if isinstance(rows, torch.Tensor):
        rb = row_blocks_of(rows, halo)
        device = rows.get_device()
        if device < 0:
            if rows.device.type != "cpu":
                raise RuntimeError(f"no K6 kernel for device {rows.device}")
            halo_fill_blocks_plain(rows, halo)
            return
        if bulk_aligned(rb):
            launch_row_blocks(rb, device)
            halo_shift_right.launches += 1
            halo_shift_right.row_block_launches += 1
            return
        rows = _shard_views(rows)
    else:
        kind = _check(rows, halo)
        if kind == "cpu":
            halo_fill_plain(rows, halo)
            return
        if kind != "cuda":
            raise RuntimeError(f"no K6 kernel for device type {kind}")
    halo_shift_right.launches += _launch_table(rows, halo)


halo_shift_right.launches = 0
# launches through the row-block entry, also counted in .launches
halo_shift_right.row_block_launches = 0
