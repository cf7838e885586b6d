"""``bench_torch.py``, the port of ``bench.py``, on the CPU.

* (a) its blocks are ``bench.py``'s (``_make_scan``), byte for byte;
* (b) its step over two blocks at C=2 gives the JAX package's
  ``run_blocks_scan`` outputs within ``sdr_tpu``'s tolerances (2e-4 on
  fm_demod and mono, 5e-3 on left, right and rds_symbols), chunked or not;
* (c) ``main(["--device", "cpu", "--detail", tmp])`` prints ``bench.py``'s
  record as its last line and writes the detail to ``tmp`` only;
* (d) without CUDA and without ``--device cpu`` it exits non-zero and
  prints no record;
* (e) an out-of-memory error ends the channel sweep as its knee; any other
  error propagates;
* (f) the gates: row 0 of a batch against the single stream, finite
  outputs, and the launch counts the card must show.

Small sizes: one or two blocks a call, one timed call, one latency call.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu import config as cfg
from sdr_tpu.models import receiver as jrx
from sdr_tpu_torch import config as pcfg
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.utils import synth

# tier-1 runs several pytest workers on one host: one thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MC, PMC = cfg.get_mode_config(0), pcfg.get_mode_config(0)
BS = PMC.default_block_size(True)
FM_ATOL, PLL_ARM_ATOL = 2e-4, 5e-3
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "platform",
               "device"}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bt = _load("bench_torch")


@pytest.fixture(scope="module")
def station():
    return synth.synthesize_fm(duration_s=bt.STATION_S, mode=0,
                               with_stereo=True, with_rds=True,
                               seed=bt.SEED).iq_u8


@pytest.mark.parametrize("c", [1, 3])
def test_blocks_are_bench_py_blocks(station, c):
    bench = _load("bench")
    _, want = bench._make_scan(jrx, MC, jrx.design_coeffs(MC), station, BS,
                               6, c)
    got = bt.make_blocks(station, BS, 6, c, "cpu")
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def jax_two_blocks(station):
    blocks = bt.make_blocks(station, BS, 2, 2, "cpu")
    outs, _ = jrx.run_blocks_scan(
        jnp.asarray(blocks.numpy()), jrx.design_coeffs(MC),
        jrx.init_state(MC, batch_shape=(2,)), 0, True, True)
    return blocks, outs


@pytest.mark.parametrize("chunk", [bt.CHANNEL_CHUNK, 1])
def test_step_matches_jax_run_blocks_scan(jax_two_blocks, chunk):
    """bench.py's chunk of 512 falls through to one ``process_block`` at
    C=2; a chunk of 1 runs the two channels as sequential blocks."""
    blocks, want = jax_two_blocks
    got, _ = prx.run_blocks(blocks, prx.design_coeffs(PMC),
                            prx.init_state(PMC, (2,)), PMC, True, True,
                            fn=bt.make_program(PMC, True, chunk))
    for arm in bt.ARM_ATOL:
        tol = FM_ATOL if arm in ("fm_demod", "mono") else PLL_ARM_ATOL
        np.testing.assert_allclose(getattr(got, arm).numpy(),
                                   np.asarray(getattr(want, arm)), rtol=0,
                                   atol=tol, err_msg=arm)


def test_main_on_cpu_prints_the_record(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("SDR_BENCH_N2", "1")
    monkeypatch.setenv("SDR_BENCH_REPS", "1")
    monkeypatch.delenv("SDR_BENCH_SWEEP", raising=False)
    monkeypatch.setattr(bt, "LATENCY_CALLS", 1)
    before = sorted(p.name for p in ROOT.iterdir())
    detail_path = tmp_path / "detail.json"
    assert bt.main(["--device", "cpu", "--detail", str(detail_path)]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    record = json.loads(last)
    assert set(record) == RECORD_KEYS
    assert record["metric"] == "stereo_rds_sustained_iq_throughput"
    assert record["unit"] == "Msamples/s"
    assert record["platform"] == "cpu" and record["device"] == "cpu"
    assert record["value"] > 0
    assert record["vs_baseline"] == round(record["value"] / 2.4, 1)
    assert sorted(p.name for p in ROOT.iterdir()) == before

    detail = json.loads(detail_path.read_text())
    assert [r["channels"] for r in detail["aggregate_sweep"]] == [4, 8]
    assert list(detail["modes"]) == ["0"]
    assert detail["modes"]["0"]["aggregate_channels"] == 4
    assert detail["unchunked"] == [] and detail["sweep_knee"] is None
    assert len(detail["dispatch_latency"]["turns_ms"]) == 1
    assert "single_stream_ms_per_block_host" in detail
    assert not any(k.endswith("_device") for k in detail)
    for row in detail["aggregate_sweep"] + [detail["single_stream"]]:
        assert len(row["turns_ms"]) == 1
        # two calls (warm-up and timed) of one block each; no kernel on
        # the CPU
        assert row["launches"]["blocks"] == 2
        assert row["launches"]["fir_frontend_u8"] == 0
    for row in detail["aggregate_sweep"]:
        assert set(row["row0_max_abs_err"]) == set(bt.ARM_ATOL)
    assert detail["headline_msps"] == max(
        [detail["single_stream_msps"]]
        + [r["msps"] for r in detail["aggregate_sweep"]])


def test_no_cuda_exits_non_zero_without_a_record(monkeypatch, capsys,
                                                 tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bt.main(["--detail", str(tmp_path / "d.json")])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""
    assert not (tmp_path / "d.json").exists()


def test_out_of_memory_ends_the_sweep():
    seen = []

    def measure(c):
        seen.append(c)
        if c == 8:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried "
                                              "to allocate 2.00 GiB")
        return {"channels": c}

    rows, knee = bt.sweep([4, 8, 16], measure)
    assert rows == [{"channels": 4}] and seen == [4, 8]
    assert knee["channels"] == 8 and "out of memory" in knee["error"]
    assert bt.sweep([4], measure) == ([{"channels": 4}], None)


@pytest.mark.parametrize("error", [RuntimeError("CUDA error: an illegal "
                                                "memory access"),
                                   bt.GateError("C=8: left is not finite")])
def test_other_errors_propagate_from_the_sweep(error):
    def measure(c):
        if c == 8:
            raise error
        return {"channels": c}

    with pytest.raises(type(error)):
        bt.sweep([4, 8, 16], measure)


def _outputs(rng, lead: tuple) -> prx.BlockOutputs:
    return prx.BlockOutputs(*[
        torch.from_numpy(rng.standard_normal(lead + (m,)).astype(np.float32))
        for m in (40, 8, 8, 8, 10, 0)])


def _batch_of(single: prx.BlockOutputs, c: int, rng) -> prx.BlockOutputs:
    """(N, c, out): row 0 is ``single``, the other rows noise."""
    return prx.BlockOutputs(*[
        torch.cat([a[:, None], torch.from_numpy(rng.standard_normal(
            (a.shape[0], c - 1, a.shape[1])).astype(np.float32))], dim=1)
        for a in single])


@pytest.mark.parametrize("arm,delta,passes", [
    ("left", 4e-3, True), ("left", 6e-3, False), ("right", 6e-3, False),
    ("rds_symbols", 6e-3, False), ("fm_demod", 5e-6, True),
    ("fm_demod", 2e-5, False), ("mono", 2e-5, False),
    ("left", float("nan"), False)])
def test_row0_gate(arm, delta, passes):
    rng = np.random.default_rng(3)
    single = _outputs(rng, (2,))
    batch = _batch_of(single, 4, rng)
    errs = bt.check_row0(batch, single, "C=4")
    assert errs == dict.fromkeys(bt.ARM_ATOL, 0.0)
    getattr(batch, arm)[1, 0, 3] += delta
    if passes:
        assert bt.check_row0(batch, single, "C=4")[arm] == pytest.approx(
            delta, abs=1e-6)
    else:
        with pytest.raises(bt.GateError, match=arm):
            bt.check_row0(batch, single, "C=4")


def test_row0_gate_refuses_a_shape_mismatch():
    rng = np.random.default_rng(4)
    single = _outputs(rng, (2,))
    batch = _batch_of(_outputs(rng, (3,)), 4, rng)
    with pytest.raises(bt.GateError, match="shape"):
        bt.check_row0(batch, single, "C=4")


@pytest.mark.parametrize("arm", sorted(bt.ARM_ATOL))
def test_finite_gate(arm):
    outs = _outputs(np.random.default_rng(5), (2, 3))
    bt.check_finite(outs, "C=3")
    getattr(outs, arm)[1, 2, 0] = float("inf")
    with pytest.raises(bt.GateError, match=arm):
        bt.check_finite(outs, "C=3")


def _counts(k1, k2, k3, blocks, warm_ups):
    return {"fir_frontend_u8": k1, "pll_angles": k2, "pll_mixer": k3,
            "blocks": blocks, "warm_ups": warm_ups, "replays": 1,
            "captures": 1}


@pytest.mark.parametrize("c,arms,chunk,counts,ok", [
    # mode 0 (two arms): K2 below 1,024 lanes, K3 from C=512
    (1, 2, 512, _counts(17, 17, 0, 16, 1), True),
    (256, 2, 512, _counts(17, 17, 0, 16, 1), True),
    (512, 2, 512, _counts(17, 0, 17, 16, 1), True),
    (1024, 2, 512, _counts(34, 0, 34, 16, 1), True),
    (1024, 2, 1024, _counts(17, 0, 17, 16, 1), True),
    # one arm (modes 1 and 3): K3 at every C
    (1, 1, 512, _counts(17, 0, 17, 16, 1), True),
    (512, 2, 512, _counts(17, 17, 0, 16, 1), False),
    (1024, 2, 512, _counts(17, 0, 17, 16, 1), False),
    (1, 2, 512, _counts(16, 17, 0, 16, 1), False),
    (1, 2, 512, _counts(0, 0, 0, 0, 0), False)])
def test_launch_gate(c, arms, chunk, counts, ok):
    if ok:
        bt.check_launches(counts, c, arms, chunk, "regime")
    else:
        with pytest.raises(bt.GateError):
            bt.check_launches(counts, c, arms, chunk, "regime")
