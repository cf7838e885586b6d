"""The readings that the limits of ``limits/<workload>.json`` are set from,
the control that has to fail them, and the faults that have to; not run
by the benchmark's own runs:

    python3 benchmark/calibrate.py --workload <name> [--seeds 1,2,...] \
        [--control-seeds 7,8,9] [--faults rds_pll_reset,...] \
        [--fault-seeds 4,5,6] [--out <file.json>]

In one process, for each seed, it makes the cell's traffic, runs the
cell's driver for the shortest window that produces every compared block
(two chunks of a monitor, the compared blocks of a listener at the
signal's own rate) and reads each arm's gap to the float64 reference, as
a run does (``harness/check.py``), under each statistic, and each number
of the cell's limits.  The program's seeds give the lower readings.  Then
the two controls, the next precision below the float32 that the
configuration states: the program with TF32 switched on for its matrix
products (the port turns TF32 off when a receiver is made; the control
turns it back on before the receiver's graphs are captured), and, for
the arms that no matrix product reaches, the reference's own answers
stored in bfloat16 put in the program's place.  Then each fault of
``harness/faults.py`` named, planted underneath the program.  It prints
the readings and each arm's lower reading (the program's largest) and
upper readings (each control's and fault's smallest).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import run


STATISTICS = ("max", "p99")


def _bf16(refs: list[dict], last: list[int], arm: str) -> list:
    """The reference's answers stored in bfloat16, in the program's place
    (a block beyond a row's last compared block is never read)."""
    import torch
    out = []
    for k in range(max(last) + 1):
        rows = [ref[arm][min(k, b)] for ref, b in zip(refs, last)]
        t = torch.from_numpy(np.stack(rows)).to(torch.bfloat16)
        out.append(t.to(torch.float64).numpy())
    return out


def readings(workload: str, seeds: list[int], control: bool,
             fault: str | None = None) -> list[dict]:
    """Each seed's readings, every arm under each statistic and each
    number of the cell's limits, as a run of the cell reads them;
    ``control`` turns TF32 on before the receiver's graphs are captured,
    and adds the bfloat16 control's readings; ``fault`` names a fault of
    ``harness/faults.py`` to plant for these seeds."""
    if not seeds:
        return []
    run._paths_and_caches()
    import pytest
    import torch

    from harness import cells, check, drivers, faults, reference, stations

    run._load_library()
    c = cells.cell(workload)
    cfg, mix = c["config"], c["mix"]
    limit = check.limits(workload)
    numbers = {n: (v["arm"], v["statistic"]) for n, v in limit.items()}
    arms = [a for a in reference.ARMS if cfg["rds"] or a != "rds_symbols"]
    every = {stat: {a: (a, stat) for a in arms} for stat in STATISTICS}
    out = []
    with pytest.MonkeyPatch.context() as mp:
        if fault:
            faults.FAULTS[fault](mp, mix)
        rx, shape = drivers.make_receiver(cfg, mix, run.DEVICE)
        if control:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        for seed in seeds:
            ring = stations.make_ring(cfg, mix, seed, run.DEVICE)
            rows, last = check.sample(seed, mix)
            kept = drivers.Kept(rows, max(last))
            drivers.DRIVERS[mix["driver"]](rx, shape, ring, cfg, mix, 0.0,
                                           kept, False)
            refs = check.reference_rows(ring, rows, last, cfg,
                                        mix["reference_workers"])
            rec = {"seed": seed, "rows": rows, "last": last}
            for stat in STATISTICS:
                rec[stat] = check.compare(kept.arms, refs, last, every[stat])
                if control:
                    bf = {a: _bf16(refs, last, a) for a in arms}
                    rec["bf16_" + stat] = check.compare(bf, refs, last,
                                                        every[stat])
            rec["numbers"] = check.compare(kept.arms, refs, last, numbers)
            rec["correct"] = check.judge(rec["numbers"], limit)[0]
            out.append(rec)
            print(json.dumps(rec), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        del rx
        torch.cuda.empty_cache()
    return out


def _seeds(text: str | None) -> list[int]:
    return [int(s) for s in text.split(",")] if text else []


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds")
    ap.add_argument("--control-seeds")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds")
    ap.add_argument("--out")
    args = ap.parse_args()
    prog = readings(args.workload, _seeds(args.seeds), False)
    ctrl = readings(args.workload, _seeds(args.control_seeds), True)
    broken = {f: readings(args.workload, _seeds(args.fault_seeds), False, f)
              for f in args.faults.split(",") if f}
    first = (prog or ctrl or next(iter(broken.values()), []))
    summary = {}
    for stat in STATISTICS + ("numbers",):
        summary[stat] = {}
        for a in (first[0][stat] if first else {}):
            s = {}
            if prog:
                s["lower"] = max(r[stat][a] for r in prog)
            if ctrl:
                s["upper_tf32"] = min(r[stat][a] for r in ctrl)
            if ctrl and stat != "numbers":
                s["upper_bf16"] = min(r["bf16_" + stat][a] for r in ctrl)
            for f, rs in broken.items():
                s["fault_" + f] = min(r[stat][a] for r in rs)
            summary[stat][a] = s
    summary["correct"] = {"program": [r["correct"] for r in prog],
                          "control": [r["correct"] for r in ctrl],
                          **{f: [r["correct"] for r in rs]
                             for f, rs in broken.items()}}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "program": prog,
                       "control": ctrl, "faults": broken,
                       "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
