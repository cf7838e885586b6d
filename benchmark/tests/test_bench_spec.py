"""``BENCHMARK.json`` against the benchmark's contract, and every cell
finding its files by name."""

import json
import re
from pathlib import Path

import pytest

from harness import cells

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for word in SPEC["command"]:
        assert LINE.match(word) and not word.startswith("/")


def test_run_seconds_fits_the_check_with_24_cells():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_lines():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert LINE.match(e[key]), (e["name"], key)
    assert len(names) == len(set(names))
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_finds_its_files(workload):
    c = cells.cell(workload, SPEC)
    w = c["workload"]
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert (BENCH / "limits" / f"{workload}.json").is_file()
    for m in c["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    arms = {v.get("arm", n) for n, v in limits.items()}
    assert arms == {"fm_demod", "mono", "left", "right", "rds_symbols"}
    for n, v in limits.items():
        assert NAME.match(n) and set(v) - {"arm"} == {"statistic", "limit"}
        # every arm is held by its widest gap
        assert any(w.get("arm", m) == v.get("arm", n)
                   and w["statistic"] == "max" for m, w in limits.items())


def test_metric_workloads_name_cells():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in layer for layer in layers)
