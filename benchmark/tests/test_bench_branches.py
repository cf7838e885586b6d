"""The reference's branches of the pilot PLL's ambiguous decisions, and
the check that compares ``left`` and ``right`` against the nearest of
them.  A "program" here is the reference itself run with one pilot
decision taken the other way, so that only the decision differs."""

import numpy as np
import pytest

from harness import cells, check, reference, stations

#: a row whose pilot input comes within 1e-5 of its scale at a few
#: samples (at 19 kHz in 240 kS/s the pilot alone never does: only its
#: noise and the audio's leakage bring it there)
SEED = 2 ** 33 + 25
WORKLOAD = "m0_listener_c1"
N_BLOCKS = 12


@pytest.fixture(scope="module")
def row():
    """(configuration, one seeded row of N_BLOCKS blocks, |v|/s of every
    pilot decision (blocks, samples), the base run)."""
    c = cells.cell(WORKLOAD)
    cfg = c["config"]
    ring = stations.make_ring(cfg, {**c["mix"], "ring_blocks": N_BLOCKS},
                              SEED, "cpu")
    base = reference.run_row(ring[0], cfg, N_BLOCKS, tau=0.0,
                             keep_pilot=True)
    v, s = base["pilot"]["v"], base["pilot"]["s"]
    ratio = np.where(s > 0, np.abs(v) / np.where(s > 0, s, 1.0), np.inf)
    return cfg, ring[0], ratio, base


def _tau(ratio: np.ndarray, n: int) -> float:
    """A threshold that makes the n smallest decisions ambiguous."""
    r = np.sort(ratio, axis=None)
    return float((r[n - 1] + r[n]) / 2)


def _judge(prog: dict, ref: dict) -> tuple[bool, dict]:
    limit = check.limits(WORKLOAD)
    arms = {a: [x[None] for x in prog[a]] for a in reference.ARMS
            if a in prog}
    numbers = {n: (v["arm"], v["statistic"]) for n, v in limit.items()}
    return check.judge(check.compare(arms, [ref], [N_BLOCKS - 1], numbers),
                       limit)


def test_no_branch_at_tau_zero_and_the_base_is_unchanged(row):
    cfg, r, _, base = row
    assert base["pilot"] == {"ambiguous": 0, "branches": [], "v": base[
        "pilot"]["v"], "s": base["pilot"]["s"]}
    ref = reference.run_row(r, cfg, N_BLOCKS)
    for arm in reference.ARMS:
        np.testing.assert_array_equal(base[arm], ref[arm])


def test_a_flipped_ambiguous_decision_reads_correct_and_a_clear_one_not(row):
    cfg, r, ratio, _ = row
    tau = _tau(ratio, 2)
    ref = reference.run_row(r, cfg, N_BLOCKS, tau=tau)
    branches = ref["pilot"]["branches"]
    assert ref["pilot"]["ambiguous"] == len(branches) == 2
    no_branch = {**ref, "pilot": {"ambiguous": 0, "branches": []}}
    for br in branches:
        flip = (br["block"], br["index"])
        assert ratio[flip] < tau
        prog = reference.run_row(r, cfg, N_BLOCKS, tau=0.0, flip=flip)
        ok, checks = _judge(prog, ref)
        assert ok, checks
        assert not _judge(prog, no_branch)[0]
        report = check.branch_report(
            {a: [x[None] for x in prog[a]] for a in reference.PILOT_ARMS},
            [ref], [N_BLOCKS - 1], [0])
        assert [m[1:] for m in report[0]["matched"]] and all(
            m[1:] == list(flip) for m in report[0]["matched"])
    block = branches[0]["block"]
    clear = (block, int(np.argmax(np.where(np.isfinite(ratio[block]),
                                           ratio[block], 0.0))))
    assert ratio[clear] >= 1e3 * tau
    ok, checks = _judge(reference.run_row(r, cfg, N_BLOCKS, tau=0.0,
                                          flip=clear), ref)
    assert not ok
    assert {n for n, c in checks.items() if c["value"] > c["limit"]} & {
        "left", "right"}


def test_beyond_the_cap_the_smallest_are_followed_and_the_rest_named(row):
    cfg, r, ratio, base = row
    n = reference.MAX_BRANCHES + 2
    ref = reference.run_row(r, cfg, N_BLOCKS, tau=_tau(ratio, n))
    p = ref["pilot"]
    assert p["ambiguous"] == n
    assert len(p["branches"]) == reference.MAX_BRANCHES
    assert [b["ratio"] for b in p["branches"]] == pytest.approx(
        np.sort(ratio, axis=None)[:reference.MAX_BRANCHES].tolist())
    arms = {a: [x[None] for x in base[a]] for a in reference.PILOT_ARMS}
    (report,) = check.branch_report(arms, [ref], [N_BLOCKS - 1], [0])
    assert report == {"row": 0, "ambiguous": n,
                      "followed": reference.MAX_BRANCHES, "left_out": 2,
                      "matched": []}
