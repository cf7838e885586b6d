"""The readings that the limits of ``limits/<workload>.json`` are set from,
the control that has to fail them, and the faults that have to; not run
by the benchmark's own runs:

    python3 benchmark/calibrate.py --workload <name> [--seeds 1,2,...] \
        [--control-seeds 7,8,9] [--faults rds_pll_reset,...] \
        [--fault-seeds 4,5,6] [--pilot-input] [--out <file.json>]

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

With ``--pilot-input`` the program's seeds also read the reading that
``reference.TAU`` is set from: the program's own pilot-PLL input (read
inside its block program, :class:`PilotInput`) against the reference's
``v`` on the same rows and blocks, as |v32 - v64| / s, the widest sample
(also once the pilot band-pass has filled); and, per row, the
reference's ambiguous decisions at ``TAU``.  The summary gives the
widest reading and the power of two at or above 4 times it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

import run


STATISTICS = ("max", "p99")


class PilotInput:
    """The program's own pilot-PLL input on the compared rows, by block of
    the stream: ``blocks[k]`` (rows, N).  It hooks the PLL kernels'
    wrappers (``faults.pilot_input_hook``): on the card each call under a
    graph's capture copies the input's rows into the graph's memory, read
    back after each replay; on the CPU each direct call's copy is kept.
    The stream's blocks are counted as ``faults``' PLL reset counts them:
    a state that the program did not return starts a stream."""

    def __init__(self, mp, n_rows: int, device):
        import torch

        from harness import faults
        from sdr_tpu_torch.models import program
        self.blocks: dict[int, np.ndarray] = {}
        self._rows = torch.zeros(n_rows, dtype=torch.long, device=device)
        self._graph: list = []
        self._done: list = []
        self._quiet = False
        faults.pilot_input_hook(mp, self._record)
        capture, step = program.Program._capture, program.Program._run
        seen: dict[int, tuple] = {}

        def hooked_capture(prog, entry, params, state):
            n0, self._quiet = len(self._graph), True
            try:
                replay = capture(prog, entry, params, state)
            finally:
                self._quiet = False
            bufs = self._graph[n0:]
            if not bufs:
                return replay

            def replay_and_keep():
                replay()
                self._done.extend(bufs)
            return replay_and_keep

        def hooked_run(prog, x, params, state, blocks):
            last = seen.get(id(prog))
            pos = last[1] if last is not None and state is last[0] else 0
            self._done = []
            out, new = step(prog, x, params, state, blocks)
            for i, t in enumerate(self._done):
                self.blocks[pos + i] = t.cpu().numpy()
            seen[id(prog)] = (new, pos + (blocks or 1))
            return out, new
        mp.setattr(program.Program, "_capture", hooked_capture)
        mp.setattr(program.Program, "_run", hooked_run)

    def use(self, rows: list[int]) -> None:
        """Read these rows from now on (a graph captured before reads
        them too: it reads the index in place)."""
        import torch
        self._rows.copy_(torch.tensor(rows))
        self.blocks = {}

    def _record(self, x):
        import torch
        rows = x.reshape(-1, x.shape[-1]).index_select(0, self._rows)
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            self._graph.append(rows)
        elif not self._quiet:
            self._done.append(rows)
        return x


def pilot_reading(blocks: dict, refs: list[dict], last: list[int],
                  taps: int) -> dict:
    """Per row: the widest |v32 - v64| / s over its compared blocks and
    where it lies ([block, index, |v64| / s there, s there over the
    row's median s]); the widest once the pilot band-pass has filled
    (from the stream's sample ``taps`` on); and the reference's ambiguous
    decisions at ``TAU``."""
    widest, at, filled = [], [], []
    for i, (ref, b) in enumerate(zip(refs, last)):
        v32 = np.stack([blocks[k][i] for k in range(b + 1)])
        v, s = ref["pilot"]["v"], ref["pilot"]["s"]
        safe = np.where(s > 0, s, np.inf)
        gap = np.abs(v32.astype(np.float64) - v) / safe
        k, n = np.unravel_index(int(np.argmax(gap)), gap.shape)
        widest.append(float(gap[k, n]))
        at.append([int(k), int(n), float(abs(v[k, n]) / safe[k, n]),
                   float(s[k, n] / np.median(s))])
        gap[0, :taps] = 0.0
        filled.append(float(gap.max()))
    return {"widest": widest, "widest_at": at, "widest_filled": filled,
            "ambiguous": [ref["pilot"]["ambiguous"] for ref in refs]}


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
             fault: str | None = None, pilot: bool = False) -> list[dict]:
    """Each seed's readings, every arm under each statistic and each
    number of the cell's limits, as a run of the cell reads them;
    ``control`` turns TF32 on before the receiver's graphs are captured,
    and adds the bfloat16 control's readings; ``fault`` names a fault of
    ``harness/faults.py`` to plant for these seeds; ``pilot`` adds the
    pilot-input reading (:func:`pilot_reading`)."""
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
        if pilot:
            hook = PilotInput(mp, len(check.sample(seeds[0], mix)[0]),
                              run.DEVICE)
        rx, shape = drivers.make_receiver(cfg, mix, run.DEVICE)
        if control:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        for seed in seeds:
            ring = stations.make_ring(cfg, mix, seed, run.DEVICE)
            rows, last = check.sample(seed, mix)
            kept = drivers.Kept(rows, max(last))
            if pilot:
                hook.use(rows)
            drivers.DRIVERS[mix["driver"]](rx, shape, ring, cfg, mix, 0.0,
                                           kept, False)
            refs = check.reference_rows(ring, rows, last, cfg,
                                        mix["reference_workers"],
                                        keep_pilot=pilot)
            rec = {"seed": seed, "rows": rows, "last": last}
            if pilot:
                rec["pilot_input"] = pilot_reading(hook.blocks, refs, last,
                                                   cfg["stereo_taps"])
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
    ap.add_argument("--pilot-input", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    prog = readings(args.workload, _seeds(args.seeds), False,
                    pilot=args.pilot_input)
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
    if args.pilot_input and prog:
        read = [r["pilot_input"] for r in prog]
        widest = max(max(p["widest"]) for p in read)
        summary["pilot_input"] = {
            "widest": widest, "tau": 2.0 ** math.ceil(math.log2(4 * widest)),
            "widest_filled": max(max(p["widest_filled"]) for p in read),
            "ambiguous": [a for p in read for a in p["ambiguous"]]}
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
