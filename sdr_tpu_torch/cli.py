"""Command-line receiver of the PyTorch port: u8 IQ in -> PCM/wav/RDS out.

Port of ``sdr_tpu/cli.py``, single-station and wideband:

    python -m sdr_tpu_torch.cli --mode 0 --stereo capture.raw -o out.pcm
    rtl_sdr -f 99.9M -s 2.4M - | python -m sdr_tpu_torch.cli --mode 0 - \\
        | aplay -f S16_LE -r 48000
    python -m sdr_tpu_torch.cli --mode 0 --stereo --rds --wideband 9600000 \\
        --offsets=-1500000,2000000 capture.raw --wav -o station

The flags are the JAX CLI's, except ``--pallas``, which picks among the
JAX package's TPU kernels: the port has one path, whose kernels are chosen
by device.  ``--device`` (default ``cuda``) names the device; without a
GPU the CLI exits with an error unless ``--device cpu`` is given.

Each block runs the receiver's block program (``Receiver.process``: on
the card a CUDA graph of the block, replayed), behind the channelizer's
with ``--wideband``, whose output stays on the device and is copied into
the receiver program's input there.  Each block's outputs (audio and RDS
symbols) are packed into one tensor on the device and copied to pinned
host memory without blocking, on the stream behind the replay; up to
``--inflight`` blocks are in flight, and each is written once its CUDA
event has completed, strictly in block order, so the output bytes do not
depend on ``--inflight``.

``--trace DIR`` runs the decode loop under ``utils.profiling.trace_to``
and prints the Chrome trace's path: the port's ``sdr.*`` spans (the block
program's inputs, load, replay and copy-out) beside the device's kernels
and copies.  ``--stats`` adds the block programs' counts of the run
(``models.program.counts``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from sdr_tpu_torch import config as cfg
from sdr_tpu_torch import io as sio
from sdr_tpu_torch import checkpoint
from sdr_tpu_torch.models import program, rds_decode
from sdr_tpu_torch.models import receiver as rx
from sdr_tpu_torch.models.channelizer import Channelizer, ChannelizerState
from sdr_tpu_torch.utils import profiling


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdr_tpu_torch",
        description="FM receiver on PyTorch and CUDA (NVIDIA GPU)")
    p.add_argument("input", help="raw interleaved u8 IQ file, or '-' "
                                 "for stdin")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs "
                        "the kernels' plain PyTorch versions)")
    p.add_argument("--mode", type=int, default=0, choices=[0, 1, 2, 3],
                   help="sample-rate mode (group-28 constraint table)")
    p.add_argument("--stereo", action="store_true",
                   help="decode stereo (default mono)")
    p.add_argument("--rds", action="store_true",
                   help="decode RDS frames (modes 0/2 only)")
    p.add_argument("--rds-algo", default="robust",
                   choices=["robust", "reference", "tracking"],
                   help="RDS symbol-clock recovery: restart-free "
                        "phase/parity estimation (robust, default), the "
                        "reference-faithful CDR (reference), or windowed "
                        "re-estimation for drifting transmit clocks "
                        "(tracking)")
    p.add_argument("-o", "--output", default="-",
                   help="PCM output path, '-' for stdout")
    p.add_argument("--wav", action="store_true",
                   help="write a .wav file instead of raw PCM")
    p.add_argument("--block-size", type=int, default=None,
                   help="raw u8 samples per block (default per-mode)")
    p.add_argument("--stats", action="store_true",
                   help="print throughput stats and the block programs' "
                        "counts to stderr at EOF")
    p.add_argument("--trace", metavar="DIR",
                   help="trace the decode loop with torch.profiler (the "
                        "port's sdr.* spans beside the device's kernels and "
                        "copies) into a Chrome trace under DIR")
    p.add_argument("--inflight", type=int,
                   default=int(os.environ.get("SDR_TPU_CLI_INFLIGHT", "8")),
                   help="blocks in flight on the device->host copy "
                        "pipeline (raises audio latency by inflight "
                        "blocks)")
    p.add_argument("--save-state", metavar="PATH",
                   help="checkpoint receiver state to PATH (.npz) at EOF")
    p.add_argument("--resume", metavar="PATH",
                   help="resume from a state checkpoint (.npz)")
    p.add_argument("--wideband", metavar="FS",
                   help="input is a wideband capture at FS samples/s: "
                        "channelize --offsets stations and decode them as "
                        "one batch (requires --wav -o PREFIX)")
    p.add_argument("--offsets", metavar="HZ,HZ,...",
                   help="comma-separated station offsets for --wideband")
    return p


class _Fetcher:
    """In-order device->host pipeline of packed block outputs.

    ``push`` starts a block's copy into pinned host memory without
    blocking and records a CUDA event behind it; once ``depth`` blocks are
    pending, the oldest is waited for and handed to ``emit``.  On the CPU
    a block is handed over as it is.  ``emit`` sees blocks in push order."""

    def __init__(self, depth: int, emit: Callable[[np.ndarray], None]):
        self.depth = max(1, depth)
        self.emit = emit
        self.pending: deque = deque()

    def push(self, packed: torch.Tensor) -> None:
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = packed, None
        self.pending.append((host, event))
        while len(self.pending) >= self.depth:
            self._pop()

    def drain(self) -> None:
        while self.pending:
            self._pop()

    def _pop(self) -> None:
        host, event = self.pending.popleft()
        if event is not None:
            event.synchronize()
        self.emit(host.numpy())


def _pack(out: rx.BlockOutputs, stereo: bool,
          with_rds: bool) -> torch.Tensor:
    """A block's audio and RDS symbols (every station's) in one tensor on
    the device, so they ride one device->host copy."""
    parts = [out.left, out.right] if stereo else [out.mono]
    if with_rds:
        parts.append(out.rds_symbols)
    return torch.cat(parts, dim=-1)


def _unpack(flat: np.ndarray, stereo: bool,
            sym_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`_pack` on the host: (audio (..., n) or
    (..., n, 2), RDS symbols (..., sym_len))."""
    if stereo:
        n_a = (flat.shape[-1] - sym_len) // 2
        audio = np.stack([flat[..., :n_a], flat[..., n_a:2 * n_a]], axis=-1)
        return audio, flat[..., 2 * n_a:]
    n_a = flat.shape[-1] - sym_len
    return flat[..., :n_a], flat[..., n_a:]


def _raw_blocks(stream, block_size: int):
    """Raw u8 blocks of ``block_size``: the native threaded reader (it
    reads ahead of the device) where the stream has a file descriptor and
    the native runtime builds, plain reads otherwise, as the JAX CLI."""
    try:
        from sdr_tpu_torch import native
        return native.BlockReader(stream.fileno(), block_size, raw=True)
    except (ImportError, OSError):
        return sio.iter_iq_blocks_raw(stream, block_size)


def _traced(stack: contextlib.ExitStack, args) -> str | None:
    """With ``--trace DIR``: what follows, until ``stack`` closes, runs
    under ``profiling.trace_to(DIR)``; returns the trace's path."""
    return (stack.enter_context(profiling.trace_to(args.trace))
            if args.trace else None)


def _counts_line(since: dict) -> str:
    """``--stats``' line of the block programs' counts during the run
    (``models.program.counts``): more captures than the programs have
    shapes means a graph was built again."""
    return "programs: " + ", ".join(
        f"{k} {program.counts[k] - since[k]}"
        for k in ("captures", "warm_ups", "replays", "blocks"))


def _warn_algo_mismatch(rds_meta: dict, requested: str) -> None:
    """A checkpoint pins its RDS algorithm (the carry layouts differ)."""
    stored = rds_meta.get("algo")
    if stored and stored != requested:
        print(f"warning: --rds-algo {requested} ignored - checkpoint "
              f"was created with '{stored}' and resume continues with it",
              file=sys.stderr)


def _main_wideband(args, device: torch.device,
                   rds_decoders: list | None) -> int:
    """Wideband path: channelize + batched receive, one wav per station
    (PREFIX_<k>.wav), RDS per station on stderr, streaming with
    ``--save-state``/``--resume`` over the channelizer carry, the batched
    receiver state and every station's RDS carry."""
    if not args.offsets or not args.wav or args.output == "-":
        print("--wideband needs --offsets HZ,HZ,... and --wav -o PREFIX",
              file=sys.stderr)
        return 2
    offsets = [float(f) for f in args.offsets.split(",")]
    mc = cfg.get_mode_config(args.mode)
    with_rds = args.rds and mc.rds is not None
    if args.rds and mc.rds is None:
        print(f"mode {args.mode} carries no RDS; ignoring --rds",
              file=sys.stderr)
    ch = Channelizer(offsets, float(args.wideband), args.mode, device=device)
    receiver = rx.Receiver(args.mode, stereo=args.stereo, with_rds=with_rds,
                           batch_shape=(len(offsets),), device=device)
    bs_wide = (args.block_size
               or mc.default_block_size(with_rds)) * ch.decim

    rds_decs = ([rds_decode.StreamingRdsDecoder(mc.rds.sps, args.rds_algo)
                 for _ in offsets] if with_rds else [])
    block_count = 0
    if args.resume:
        # the wideband receiver is fed channelized float baseband, not u8
        receiver.state, meta = checkpoint.load(
            args.resume, expect_input_dtype="float32", device=device)
        block_count = meta.get("block_count", 0)
        ha = meta["host_arrays"]
        ch.state = ChannelizerState(
            fir=torch.as_tensor(ha["chan/fir"], device=device),
            phi0=torch.as_tensor(ha["chan/phi0"], device=device))
        if with_rds and "rds_per_station" in meta.get("extra", {}):
            rds_decs = []
            for k, rmeta in enumerate(meta["extra"]["rds_per_station"]):
                _warn_algo_mismatch(rmeta, args.rds_algo)
                rds_decs.append(rds_decode.StreamingRdsDecoder.
                                load_state_dict(
                                    {key[len(f"rds{k}/"):]: v
                                     for key, v in ha.items()
                                     if key.startswith(f"rds{k}/")}, rmeta))
        print(f"resumed from {args.resume} at block {block_count}",
              file=sys.stderr)
    if rds_decoders is not None:
        rds_decoders.extend(rds_decs)

    sym_len = 0

    def emit(flat: np.ndarray) -> None:
        audio, rest = _unpack(flat, args.stereo, sym_len)
        for k, w in enumerate(writers):
            w.write(audio[k])
        for k, dec in enumerate(rds_decs):
            dec.feed(rest[k])

    n_blocks = 0
    with contextlib.ExitStack() as stack:
        in_stream = (sio.stdin_binary() if args.input == "-" else
                     stack.enter_context(open(args.input, "rb")))
        writers = [stack.enter_context(sio.StreamingWavWriter(
            f"{args.output}_{k}.wav", mc.audio_fs,
            channels=2 if args.stereo else 1)) for k in range(len(offsets))]
        fetcher = _Fetcher(args.inflight, emit)
        counts0 = dict(program.counts)
        trace_path = _traced(stack, args)
        t0 = time.time()
        while True:
            raw = in_stream.read(bs_wide)
            if raw is None or len(raw) < bs_wide:
                break
            out = receiver.process(
                ch.process(np.frombuffer(raw, dtype=np.uint8)))
            if with_rds and not sym_len:
                sym_len = int(out.rds_symbols.shape[-1])
            fetcher.push(_pack(out, args.stereo, with_rds))
            n_blocks += 1
        fetcher.drain()
        dt = time.time() - t0
    if not args.save_state:
        for dec in rds_decs:
            dec.flush()

    if n_blocks == 0 and not args.resume:
        print(f"input shorter than one wideband block ({bs_wide} samples); "
              "nothing decoded", file=sys.stderr)
        return 1

    if args.save_state:
        host_arrays = {"chan/fir": ch.state.fir.cpu().numpy(),
                       "chan/phi0": ch.state.phi0.cpu().numpy()}
        extra = {"wideband": {"fs": ch.fs_wide, "offsets": list(offsets)}}
        if with_rds:
            extra["rds_per_station"] = []
            for k, dec in enumerate(rds_decs):
                arrays, rmeta = dec.state_dict()
                extra["rds_per_station"].append(rmeta)
                host_arrays.update({f"rds{k}/{key}": v
                                    for key, v in arrays.items()})
        written = checkpoint.save(args.save_state, receiver.state,
                                  args.mode,
                                  block_count=block_count + n_blocks,
                                  extra=extra, host_arrays=host_arrays,
                                  input_dtype="float32")
        print(f"state saved to {written} "
              f"(block {block_count + n_blocks})", file=sys.stderr)

    for k, f_off in enumerate(offsets):
        msg = (f"station {k} @ {f_off / 1e6:+.2f} MHz -> "
               f"{args.output}_{k}.wav")
        if with_rds:
            dec = rds_decs[k]
            msg += f" | RDS {dec.n_matches} frames"
            if dec.n_corrected:
                msg += f" ({dec.n_corrected} corrected)"
            st = dec.station_info()
            if st.n_groups and st.pi is not None:
                msg += f" PI={st.pi:04X} PS={st.ps_name!r}"
        print(msg, file=sys.stderr)
    if args.stats:
        pairs = n_blocks * bs_wide / 2
        print(f"{n_blocks} wideband blocks, {len(offsets)} stations, "
              f"{pairs / 1e6:.2f} M IQ pairs in {dt:.2f}s = "
              f"{pairs / dt / 1e6:.1f} MS/s", file=sys.stderr)
        print(_counts_line(counts0), file=sys.stderr)
    if trace_path:
        print(f"trace: {trace_path}", file=sys.stderr)
    return 0


def _main_single(args, device: torch.device,
                 rds_decoders: list | None) -> int:
    """Single-station path: raw u8 blocks -> PCM or wav, RDS on stderr."""
    mc = cfg.get_mode_config(args.mode)
    if args.wav and args.output == "-":
        print("--wav needs an output file: pass -o PATH", file=sys.stderr)
        return 2
    with_rds = args.rds and mc.rds is not None
    if args.rds and mc.rds is None:
        print(f"mode {args.mode} carries no RDS; ignoring --rds",
              file=sys.stderr)
    bs = args.block_size or mc.default_block_size(with_rds)
    receiver = rx.Receiver(args.mode, stereo=args.stereo, with_rds=with_rds,
                           device=device)
    # streaming host-side RDS decode with carried state: O(block) host
    # memory however long the run
    rds_dec = (rds_decode.StreamingRdsDecoder(mc.rds.sps, args.rds_algo)
               if with_rds else None)
    first_offsets: list[str] = []

    block_count = 0
    if args.resume:
        # this path feeds raw u8 end to end; refuse float-produced state
        receiver.state, meta = checkpoint.load(
            args.resume, expect_input_dtype="uint8", device=device)
        block_count = meta.get("block_count", 0)
        if with_rds and "rds" in meta.get("extra", {}):
            _warn_algo_mismatch(meta["extra"]["rds"], args.rds_algo)
            rds_dec = rds_decode.StreamingRdsDecoder.load_state_dict(
                {k[len("rds/"):]: v
                 for k, v in meta["host_arrays"].items()
                 if k.startswith("rds/")},
                meta["extra"]["rds"])
        print(f"resumed from {args.resume} at block {block_count}",
              file=sys.stderr)
    if rds_decoders is not None and rds_dec is not None:
        rds_decoders.append(rds_dec)
    n_matches_at_start = rds_dec.n_matches if rds_dec is not None else 0

    sym_len = 0

    def emit(flat: np.ndarray) -> None:
        """Write and decode one block's packed host outputs."""
        audio, rest = _unpack(flat, args.stereo, sym_len)
        write(audio)
        if rds_dec is not None:
            for _, off in rds_dec.feed(rest):
                if len(first_offsets) < 12:
                    first_offsets.append(off)

    n_blocks = 0
    with contextlib.ExitStack() as stack:
        in_stream = (sio.stdin_binary() if args.input == "-" else
                     stack.enter_context(open(args.input, "rb")))
        if args.wav:
            # per-block incremental writes: host memory stays O(block)
            write = stack.enter_context(sio.StreamingWavWriter(
                args.output, mc.audio_fs,
                channels=2 if args.stereo else 1)).write
        else:
            write = functools.partial(
                sio.write_pcm,
                sio.stdout_binary() if args.output == "-" else
                stack.enter_context(open(args.output, "wb")))
        fetcher = _Fetcher(args.inflight, emit)
        counts0 = dict(program.counts)
        trace_path = _traced(stack, args)
        t0 = time.time()
        for blk in _raw_blocks(in_stream, bs):
            out = receiver.process(blk)
            if with_rds and not sym_len:
                sym_len = int(out.rds_symbols.shape[-1])
            fetcher.push(_pack(out, args.stereo, with_rds))
            n_blocks += 1
        fetcher.drain()
        dt = time.time() - t0

    if rds_dec is not None and not args.save_state:
        # decode what the CDR still buffers; skipped when checkpointing so
        # the carry persists for the resumed run
        for _, off in rds_dec.flush():
            if len(first_offsets) < 12:
                first_offsets.append(off)
    if args.save_state:
        extra, host_arrays = {}, {}
        if rds_dec is not None:
            arrays, rmeta = rds_dec.state_dict()
            extra["rds"] = rmeta
            host_arrays = {f"rds/{k}": v for k, v in arrays.items()}
        written = checkpoint.save(args.save_state, receiver.state, args.mode,
                                  block_count=block_count + n_blocks,
                                  extra=extra, host_arrays=host_arrays,
                                  input_dtype="uint8")
        print(f"state saved to {written} "
              f"(block {block_count + n_blocks})", file=sys.stderr)
    if with_rds and n_blocks:
        # after a resume n_matches is cumulative across the checkpoint but
        # first_offsets covers only this run
        label = "first this run" if args.resume else "first"
        n_new = rds_dec.n_matches - n_matches_at_start
        corr = (f", {rds_dec.n_corrected} error-corrected"
                if rds_dec.n_corrected else "")
        print(f"RDS: {rds_dec.n_matches} frames{corr} ({label}: "
              f"{', '.join(first_offsets)}"
              f"{'...' if n_new > len(first_offsets) else ''})",
              file=sys.stderr)
        st = rds_dec.station_info()
        if st.n_groups:
            pi = f"{st.pi:04X}" if st.pi is not None else "----"
            print(f"RDS station: PI={pi} PTY={st.pty} TP={st.tp} "
                  f"PS={st.ps_name!r} RT={st.radiotext!r} "
                  f"({st.n_groups} groups {st.group_counts})",
                  file=sys.stderr)

    if args.stats and n_blocks:
        pairs = n_blocks * bs / 2
        print(f"{n_blocks} blocks, {pairs / 1e6:.2f} M IQ pairs in "
              f"{dt:.2f}s = {pairs / dt / 1e6:.1f} MS/s "
              f"({pairs / mc.rf_fs / dt:.1f}x real-time)", file=sys.stderr)
        print(_counts_line(counts0), file=sys.stderr)
    if trace_path:
        print(f"trace: {trace_path}", file=sys.stderr)
    return 0


def main(argv=None, rds_decoders: list | None = None) -> int:
    """Run the CLI on ``argv``; returns the exit code.  ``rds_decoders``,
    when a list, receives the run's ``StreamingRdsDecoder`` (one per
    station), so a caller can read the decoded groups."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available: pass --device cpu to run the "
              "receiver on the CPU", file=sys.stderr)
        return 2
    if args.wideband:
        return _main_wideband(args, device, rds_decoders)
    return _main_single(args, device, rds_decoders)


if __name__ == "__main__":
    sys.exit(main())
