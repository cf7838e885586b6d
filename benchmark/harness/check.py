"""What decides ``correct``: the outputs that the timed path returned to the
host during the window, against the float64 reference on the same input
bytes.

The sample is drawn from the seed: ``check_rows`` rows spread over the
batch, and for each row every block of its stream from block 0 to a last
block drawn from the ``check_blocks_after_wrap`` blocks after the ring's
first wrap (and after the first chunk boundary, the ring being one
chunk), so that the state carried across a chunk and across the wrap is
checked.  The reference replays each row from its first block, since the
carried state depends on all of them.

Each number compared is a statistic of the gaps between the program's
samples of one arm and the reference's over the compared blocks, as a
share of the reference's largest magnitude in that row, the worst row
taken.  The numbers and their limits are a data file of the cell
(``limits/<workload>.json``): each entry names its arm (the entry's own
name where it names none), its statistic and its limit.  Every arm is
held by its widest gap ("max").  The RDS symbols are held by two
numbers: the 99th percentile of the gaps against the control's
precision, and the widest gap against a PLL that loses its state.  The
RDS carrier PLL's detector takes only the sign of its input, and a
near-zero input can round either way between float32 and float64: a
sound run then departs for a burst of about two symbols, 1e-4 to 3e-4
of the peak, which the percentile leaves alone and the widest gap's
limit sits above.

The pilot PLL's detector takes only the sign of its input too, and one
decision taken the other way moves ``left`` and ``right`` by 4e-4 to
7e-3 of the peak.  So these two arms are compared block by block
against the nearest of the reference's base run and its branches
(``harness/reference.py``): each the recurrence with one decision that
float32 cannot resolve taken the other way, and admissible from the
block of that decision on.  The nearest is the one whose widest gap on
``left`` and ``right`` together is least; the statistic is then taken as
ever, over the row, against the blocks so chosen, and over the base's
peak.  Every other arm is compared against the base alone.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from harness import reference

LIMITS_DIR = Path(__file__).resolve().parent.parent / "limits"


def sample(seed: int, mix: dict) -> tuple[list[int], list[int]]:
    """(rows, last compared block of each row) drawn from ``seed``."""
    rng = np.random.default_rng([seed, 0x434845434B])
    n = min(mix["check_rows"], mix["channels"])
    rows = sorted(int(r) for r in rng.choice(mix["channels"], size=n,
                                             replace=False))
    last = [mix["ring_blocks"] + int(rng.integers(
        0, mix["check_blocks_after_wrap"])) for _ in rows]
    return rows, last


def limits(workload: str) -> dict[str, dict]:
    """{number: {"arm" (default: the number's name), "statistic" ("max"
    or "p<q>"), "limit": share}}."""
    out = json.loads((LIMITS_DIR / f"{workload}.json").read_text())
    for name, v in out.items():
        v.setdefault("arm", name)
    return out


def statistic(diff: np.ndarray, name: str) -> float:
    """The widest gap ("max") or a high percentile of the gaps ("p99")
    of one row's compared samples."""
    if name == "max":
        return float(diff.max())
    return float(np.percentile(diff, float(name[1:])))


def _have(got: list | None, i: int, want: np.ndarray) -> np.ndarray | None:
    """Row ``i`` of the program's blocks of one arm, as many as ``want``
    has, or None where the arm is missing, short, at another length or
    not finite."""
    if got is None or len(got) < len(want):
        return None
    have = np.stack([blk[i] for blk in got[: len(want)]]).astype(np.float64)
    if have.shape != want.shape or not np.isfinite(have).all():
        return None
    return have


def nearest(haves: dict, ref: dict, n: int) -> tuple[dict, list]:
    """(want, matched): for each arm of ``haves`` the reference's blocks
    0..n-1 it is compared against, and the (block, branch) pairs at which
    ``left`` and ``right`` take a branch's blocks, being nearer to the
    program's (``haves[arm]``, None where unreadable) than the base's and
    every other admissible branch's."""
    want = {a: ref[a][:n] for a in haves}
    if any(haves.get(a) is None for a in reference.PILOT_ARMS):
        return want, []
    want.update({a: want[a].copy() for a in reference.PILOT_ARMS})
    peak = {a: float(np.abs(want[a]).max()) or 1.0
            for a in reference.PILOT_ARMS}
    branches = ref["pilot"]["branches"]

    def gap(k: int, blocks: dict) -> float:
        return max(float(np.abs(haves[a][k] - blocks[a]).max()) / peak[a]
                   for a in reference.PILOT_ARMS)
    matched = []
    for k in range(n):
        best = gap(k, {a: want[a][k] for a in reference.PILOT_ARMS})
        pick = None
        for j, br in enumerate(branches):
            i = k - br["block"]
            if 0 <= i < len(br["left"]):
                g = gap(k, {a: br[a][i] for a in reference.PILOT_ARMS})
                if g < best:
                    best, pick = g, j
        if pick is not None:
            br = branches[pick]
            for a in reference.PILOT_ARMS:
                want[a][k] = br[a][k - br["block"]]
            matched.append((k, pick))
    return want, matched


def compare(arms: dict, refs: list[dict], last: list[int],
            numbers: dict[str, tuple[str, str]]) -> dict[str, float]:
    """Per number (arm, statistic): the statistic of |program -
    reference| over each row's compared blocks, over the reference's
    largest magnitude there; the worst row.  ``left`` and ``right`` are
    compared against the nearest branch (:func:`nearest`).  ``arms[name]``
    is a list of (rows, length) blocks in stream order.  An arm missing,
    short, at another length or not finite reads inf."""
    out = {name: 0.0 for name in numbers}
    used = {arm for arm, _ in numbers.values()} | set(reference.PILOT_ARMS)
    for i, (ref, b) in enumerate(zip(refs, last)):
        haves = {a: _have(arms.get(a), i, ref[a][: b + 1])
                 for a in used if a in ref}
        want = nearest(haves, ref, b + 1)[0]
        for name, (arm, stat) in numbers.items():
            have = haves.get(arm)
            if have is None:
                out[name] = math.inf
                continue
            scale = float(np.abs(ref[arm][: b + 1]).max()) or 1.0
            out[name] = max(out[name], statistic(np.abs(have - want[arm]),
                                                 stat) / scale)
    return out


def branch_report(arms: dict, refs: list[dict], last: list[int],
                  rows: list[int]) -> list[dict]:
    """Per compared row: the ambiguous pilot decisions that the reference
    found, the branches it followed and those it left out, and the
    blocks at which left and right matched a branch rather than the base
    ([block, the branch's block, its index in that block])."""
    out = []
    for i, (ref, b, r) in enumerate(zip(refs, last, rows)):
        pilot = ref["pilot"]
        haves = {a: _have(arms.get(a), i, ref[a][: b + 1])
                 for a in reference.PILOT_ARMS}
        matched = nearest(haves, ref, b + 1)[1]
        br = pilot["branches"]
        out.append({"row": r, "ambiguous": pilot["ambiguous"],
                    "followed": len(br),
                    "left_out": pilot["ambiguous"] - len(br),
                    "matched": [[k, br[j]["block"], br[j]["index"]]
                                for k, j in matched]})
    return out


def reference_rows(ring: np.ndarray, rows: list[int], last: list[int],
                   cfg: dict, workers: int, **kw) -> list[dict]:
    return reference.run_rows([ring[r] for r in rows], cfg,
                              [b + 1 for b in last], workers, **kw)


def judge(values: dict[str, float], limit: dict[str, dict]
          ) -> tuple[bool, dict]:
    """(correct, {number: {"arm", "statistic", "value", "limit"}}): every
    number at or under its limit, and every limited number read."""
    checks = {n: {"arm": v["arm"], "statistic": v["statistic"],
                  "value": values.get(n, math.inf), "limit": v["limit"]}
              for n, v in limit.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
