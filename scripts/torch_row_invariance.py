#!/usr/bin/env python3
"""Find the first op of the receiver block whose output for one row depends
on the batch it runs in, on one card.

Runs a mode-0 stereo+RDS u8 batch of ``--rows`` channels (4 by default)
and its row 0 alone through ``models.receiver.process_block`` for
``--blocks`` blocks, each side carrying its own state, and prints for each
op of the block, in the block's order, the max absolute difference of row
0 between the two runs:

 1. K1, the u8 front-end (``fir_frontend_u8``);
 2. the FM demod (``fm_demod_quad``);
 3. the 3-band band-pass (``fir_block_multi_mm``, an einsum);
 4. the RDS carrier band-pass on chan^2 (``fir_block_decim_mm`` at D=1);
 5. the PLL kernel (K2 below 1,024 lanes, K3 at and above);
 6. the audio low-pass (``fir_block_decim_mm`` at D=5);
 7. the RDS resampler (``fir_block_resample_mm``);
 8. the RDS matched filter (``fir_block_decim_mm`` at D=1);

then the block's outputs (fm_demod, mono, left, right, rds_symbols), and
the first op whose row 0 is not bit-equal.  Each draw takes the rows of
the batch from random whole-I/Q-pair offsets of a synthesized capture
(row 0 at a different offset each draw), so that over several draws a
place near a detector sign change is likely to turn up.  With
``--rows 512`` the batch takes K3 and row 0 alone K2.

    python3 scripts/torch_row_invariance.py --draws 8

The card's name and power limit come first.  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess

import numpy as np
import torch

from sdr_tpu_torch.models import receiver as rx
from sdr_tpu_torch.ops import demod as tdemod
from sdr_tpu_torch.ops import fir as tfir
from sdr_tpu_torch.ops import fir_frontend, pll_cuda
from sdr_tpu_torch.utils import synth

SEED = 20261016
OUTPUTS = ("fm_demod", "mono", "left", "right", "rds_symbols")


def _ops() -> list[tuple[object, str]]:
    """(module, function name) of every op the hooks record."""
    return [(fir_frontend, "fir_frontend_u8"), (tdemod, "fm_demod_quad"),
            (tfir, "fir_block_multi_mm"), (tfir, "fir_block_decim_mm"),
            (tfir, "fir_block_resample_mm"),
            (pll_cuda, "pll_block_fused_kernel"),
            (pll_cuda, "pll_mixer_fused_kernel")]


def _label(name: str, args: tuple) -> str:
    if name == "fir_block_decim_mm":
        decim = args[3] if len(args) > 3 else 1
        return ("audio fir_block_decim_mm" if decim == 5
                else f"fir_block_decim_mm D={decim}")
    return name


class Hooks:
    """Record the first output of each hooked op, call by call."""

    def __init__(self) -> None:
        self.calls: list[tuple[str, torch.Tensor]] = []
        self._saved = []
        for mod, name in _ops():
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        @functools.wraps(fn)        # keeps a wrapper's launch count
        def hooked(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append((_label(name, args), out[0]))
            return out
        return hooked

    def restore(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _run(iq: np.ndarray, blocks: int, hooks: Hooks):
    """Blocks of ``iq`` (rows, blocks * bs) or (blocks * bs,) through
    process_block; returns per block the hooked calls and the outputs."""
    mc = rx.cfg.get_mode_config(0)
    bs = mc.default_block_size(True)
    coeffs = rx.design_coeffs(mc, device="cuda")
    batch = iq.shape[:-1]
    state = rx.init_state(mc, batch, device="cuda")
    x = torch.from_numpy(np.ascontiguousarray(iq)).cuda()
    per_block = []
    for b in range(blocks):
        hooks.calls = []
        out, state = rx.process_block(x[..., b * bs:(b + 1) * bs], coeffs,
                                      state, mc, stereo=True, with_rds=True)
        per_block.append((hooks.calls, out))
    torch.cuda.synchronize()
    return per_block


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--draws", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    rx.pin_fp32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi} | torch {torch.__version__} | {args.rows} rows x "
          f"{args.blocks} blocks, {args.draws} draws")
    mc = rx.cfg.get_mode_config(0)
    n_bytes = args.blocks * mc.default_block_size(True)
    cap = synth.synthesize_fm(duration_s=2.0, mode=0, seed=SEED,
                              with_rds=True).iq_u8
    rng = np.random.default_rng(SEED)
    hooks = Hooks()
    report = {"card": smi, "rows": args.rows, "draws": []}
    try:
        for d in range(args.draws):
            offs = 2 * rng.integers(0, (len(cap) - n_bytes) // 2,
                                    size=args.rows)
            batch = np.stack([cap[o:o + n_bytes] for o in offs])
            many = _run(batch, args.blocks, hooks)
            one = _run(batch[0], args.blocks, hooks)
            ops: dict[str, float] = {}
            first = None
            for (calls_m, out_m), (calls_1, out_1) in zip(many, one):
                for (name, ym), (name1, y1) in zip(calls_m, calls_1):
                    # the batch takes K3 at 1,024 lanes, row 0 alone K2
                    key = "PLL" if name.startswith("pll_") else name
                    if ym[0].shape != y1.shape:   # K3's mixers, K2's NCOs
                        ops[key] = float("nan")
                        continue
                    err = float((ym[0] - y1).abs().max())
                    ops[key] = max(ops.get(key, 0.0), err)
                    if first is None and not err == 0.0:
                        first = key
                for f in OUTPUTS:
                    err = float((getattr(out_m, f)[0]
                                 - getattr(out_1, f)).abs().max())
                    ops[f] = max(ops.get(f, 0.0), err)
            report["draws"].append({"offset0": int(offs[0]), "max_abs": ops,
                                    "first_differing_op": first})
            print(f"draw {d} (row 0 at byte {offs[0]}): first differing op "
                  f"{first}; max abs diff of row 0: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in ops.items()))
    finally:
        hooks.restore()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
