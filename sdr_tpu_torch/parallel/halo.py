"""Halo exchange of time sharding: kernel K6 and its plain version.

Port of ``sdr_tpu/parallel/pallas_halo.py`` (the kernel
``halo_shift_right``).  Semantics, as ``lax.ppermute(x, axis, [(i, i+1)
for i in range(S-1)])`` within each row of any other mesh axes: shard k
receives shard k-1's trailing ``halo`` samples, shard 0 receives zeros.

Every shard owns an extended buffer ``[halo | segment]`` ((rows, L) or
(L,), float32, time last): its segment in the suffix, its halo slot in the
prefix.  :func:`halo_shift_right` takes the buffers as time rows (a list of
rows, each the S shard buffers in time order, on any devices) and fills
every halo slot in place.  On CUDA tensors it launches ``csrc/halo.cu``
once per card for all of that card's shards (a left neighbour on another
card is read through peer access); on CPU tensors it runs the plain
version, :func:`halo_shift_right_plain`.  The JAX kernel takes 1-D meshes
only (a limit of JAX's DMA lowering); this one shifts within every row of
a channel x time grid.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from sdr_tpu_torch.kernels import build

_MAX_SHARDS = 64              # table entries per launch (csrc/halo.cu)
_PEER_UNSUPPORTED = 217       # cudaErrorPeerAccessUnsupported
# (device, peer) pairs with peer access on: a property of the process's
# CUDA contexts, so it is kept per process
_peers_enabled: set[tuple[int, int]] = set()

Rows = Sequence[Sequence[torch.Tensor]]


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


def launch(rows: Rows, halo: int) -> int:
    """Launch K6 over CUDA shard buffers (see the module docstring): one
    launch per card for up to 64 of its shards, on that card's current
    stream.  A tail on another card is ordered by an event on its card's
    current stream, and that stream then waits for the launch before it
    may reuse the memory.  Returns the number of launches.  Counts
    nothing: :func:`halo_shift_right` counts."""
    if _check(rows, halo) != "cuda":
        raise ValueError("K6 launches on CUDA tensors only")
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
        stream = torch.cuda.current_stream(card)
        for peer in peers:
            _enable_peer(lib, card, peer)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(peer))
            stream.wait_event(ready)
        for i in range(0, len(entries), _MAX_SHARDS):
            part = entries[i:i + _MAX_SHARDS]
            table = ctypes.c_void_p * len(part)
            src = table(*[None if s is None else s.data_ptr()
                          for s, _ in part])
            dst = table(*[d.data_ptr() for _, d in part])
            rc = lib.sdr_halo_shift(card, src, dst, len(part), n_rows, halo,
                                    stride, stride, stream.cuda_stream)
            build.check(rc, "sdr_halo_shift")
            n_launches += 1
        if peers:
            done = torch.cuda.Event()
            done.record(stream)
            for peer in peers:
                torch.cuda.current_stream(peer).wait_event(done)
    return n_launches


def halo_shift_right(rows: Rows, halo: int) -> None:
    """K6, in place: within every time row, shard k's first ``halo``
    samples become shard k-1's last ``halo`` samples, and shard 0's become
    zeros.

    CUDA tensors launch the kernel (:func:`launch`) and CPU tensors take the
    plain version; a mix, or any other device, raises."""
    kind = _check(rows, halo)
    if kind == "cpu":
        halo_fill_plain(rows, halo)
        return
    if kind != "cuda":
        raise RuntimeError(f"no K6 kernel for device type {kind}")
    halo_shift_right.launches += launch(rows, halo)


halo_shift_right.launches = 0
