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


def compare(arms: dict, refs: list[dict], last: list[int],
            numbers: dict[str, tuple[str, str]]) -> dict[str, float]:
    """Per number (arm, statistic): the statistic of |program -
    reference| over each row's compared blocks, over the reference's
    largest magnitude there; the worst row.  ``arms[name]`` is a list of
    (rows, length) blocks in stream order.  An arm missing, short, at
    another length or not finite reads inf."""
    out = {}
    for name, (arm, stat) in numbers.items():
        got = arms.get(arm)
        worst = 0.0
        for i, (ref, b) in enumerate(zip(refs, last)):
            want = ref[arm][: b + 1]
            if got is None or len(got) < b + 1:
                worst = math.inf
                break
            have = np.stack([blk[i] for blk in got[: b + 1]])
            if have.shape != want.shape:
                worst = math.inf
                break
            diff = np.abs(have.astype(np.float64) - want)
            if not np.isfinite(diff).all():
                worst = math.inf
                break
            scale = float(np.abs(want).max()) or 1.0
            worst = max(worst, statistic(diff, stat) / scale)
        out[name] = worst
    return out


def reference_rows(ring: np.ndarray, rows: list[int], last: list[int],
                   cfg: dict, workers: int) -> list[dict]:
    return reference.run_rows([ring[r] for r in rows], cfg,
                              [b + 1 for b in last], workers)


def judge(values: dict[str, float], limit: dict[str, dict]
          ) -> tuple[bool, dict]:
    """(correct, {number: {"arm", "statistic", "value", "limit"}}): every
    number at or under its limit, and every limited number read."""
    checks = {n: {"arm": v["arm"], "statistic": v["statistic"],
                  "value": values.get(n, math.inf), "limit": v["limit"]}
              for n, v in limit.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
