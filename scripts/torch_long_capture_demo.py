#!/usr/bin/env python3
"""Long-capture demo of the PyTorch port: a >= 60 s capture streamed
through ``Receiver.iter_run`` with O(chunk) memory, on the card.

The port's counterpart of ``scripts/long_capture_demo.py``: a 2 s
mode-0 stereo+RDS station (seed 1) tiled to each ``--durations`` (60 and
120 s by default), streamed through ``Receiver.iter_run(chunk_blocks=64)``
on ``--device`` (default cuda), each host chunk copied straight into the
chunk program's static input, the audio written as 16-bit PCM per chunk
under ``build/studies/``.  Each duration runs in a process of its own,
so that nothing of one run (the allocator's cache, cuBLAS workspaces,
the host's high-water mark) counts in the other's.  Per duration: wall
time, x real time, I/Q Msamples/s, the peak host RSS and its growth
during the run, and on the card ``torch.cuda.max_memory_allocated`` over
the process, which must not grow with the duration.  Writes
``docs/torch_long_capture.json`` (on the CPU: ``build/studies/``).

    python3 scripts/torch_long_capture_demo.py [--durations 60,120]
        [--chunk-blocks 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import torch_studies

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sdr_tpu_torch import config as cfg  # noqa: E402
from sdr_tpu_torch.io import pcm_quantize  # noqa: E402
from sdr_tpu_torch.models.receiver import SCAN_BLOCKS, Receiver  # noqa: E402
from sdr_tpu_torch.utils import synth  # noqa: E402


def run(iq: np.ndarray, device, chunk_blocks: int, pcm: str) -> dict:
    mc = cfg.get_mode_config(0)
    cuda = torch.device(device).type == "cuda"
    r = Receiver(0, stereo=True, with_rds=True, device=device)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    written = 0
    with open(pcm, "wb") as f:
        for outs in r.iter_run(iq, chunk_blocks=chunk_blocks):
            audio = np.stack([outs.left.reshape(-1), outs.right.reshape(-1)],
                             axis=-1)
            buf = pcm_quantize(audio).tobytes()
            f.write(buf)
            written += len(buf)
    wall = time.perf_counter() - t0
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    dur = len(iq) / 2 / mc.rf_fs
    return {"duration_s": dur, "blocks": len(iq) // mc.default_block_size(
                True), "wall_s": wall, "x_real_time": dur / wall,
            "iq_msamples_per_s": len(iq) / 2 / wall / 1e6,
            "pcm_bytes": written, "peak_rss_mb": rss1 / 1024,
            "peak_rss_growth_mb": (rss1 - rss0) / 1024,
            "max_memory_allocated_bytes":
                torch.cuda.max_memory_allocated() if cuda else None,
            "captures": [c.blocks for c in r.program.captures]}


def one(secs: float, device, chunk_blocks: int) -> dict:
    """One duration: the capture tiled from a 2 s station, then
    :func:`run`."""
    mc = cfg.get_mode_config(0)
    base = synth.synthesize_fm(duration_s=2.0, mode=0, seed=1,
                               with_stereo=True, with_rds=True).iq_u8
    work = os.path.join(torch_studies.ROOT, "build", "studies")
    os.makedirs(work, exist_ok=True)
    iq = np.tile(base, int(np.ceil(secs * mc.rf_fs * 2 / len(base))))
    return run(iq, device, chunk_blocks,
               os.path.join(work, f"long_capture_{secs:g}s.pcm"))


def main(argv=None) -> int:
    ap = torch_studies.parser(__doc__)
    ap.add_argument("--durations", default="60,120")
    ap.add_argument("--chunk-blocks", type=int, default=64)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        print(json.dumps(one(float(a.durations), a.device, a.chunk_blocks)))
        return 0
    record = torch_studies.device_record(a.device)
    print(f"device: {record}", flush=True)
    rows = []
    for secs in a.durations.split(","):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--durations", secs, "--device", a.device, "--chunk-blocks",
             str(a.chunk_blocks)], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"the {secs} s run failed:\n{proc.stderr}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(f"{row['duration_s']:.1f} s, {row['blocks']} blocks: "
              f"{row['wall_s']:.2f} s wall, {row['x_real_time']:.1f}x real "
              f"time, {row['iq_msamples_per_s']:.2f} IQ Msamples/s, peak RSS "
              f"{row['peak_rss_mb']:.0f} MB (+{row['peak_rss_growth_mb']:.0f}"
              f" MB during the run), max allocated on the device "
              f"{row['max_memory_allocated_bytes']}", flush=True)
    mc = cfg.get_mode_config(0)
    torch_studies.write("torch_long_capture.json", a.device, a.out, {
        **record, "script": "scripts/torch_long_capture_demo.py", "mode": 0,
        "stereo": True, "rds": True, "chunk_blocks": a.chunk_blocks,
        "scan_blocks": SCAN_BLOCKS,
        "block_bytes": mc.default_block_size(True), "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
