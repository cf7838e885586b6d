"""Everything a cell needs, found by the names in ``BENCHMARK.json``: its
configuration file, its traffic file (``traffic/<traffic>.json``), its
limits (``limits/<workload>.json``) and the readers of its per-layer
metrics (``metrics/<metric>.py``)."""

from __future__ import annotations

import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
SPEC = BENCH_DIR.parent / "BENCHMARK.json"


def load_spec() -> dict:
    return json.loads(SPEC.read_text())


def _metrics_of(spec: dict, kind: str, workload: str,
                e2e: set[str]) -> list[dict]:
    """The metrics of ``kind`` that the cell reports: those that list it,
    and those without a list whose end-to-end metric it reports."""
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def cell(workload: str, spec: dict | None = None) -> dict:
    """{"workload", "config" (the file's dict), "mix" (the traffic file's
    dict), "end_to_end", "per_layer"} of one cell; KeyError for a name
    that BENCHMARK.json does not hold."""
    spec = spec or load_spec()
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg = json.loads((BENCH_DIR.parent / c["file"]).read_text())
    mix = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    e2e = _metrics_of(spec, "end_to_end", workload, set())
    per = _metrics_of(spec, "per_layer", workload, {m["name"] for m in e2e})
    return {"workload": w, "config": cfg, "mix": mix, "end_to_end": e2e,
            "per_layer": per}
