"""The port's utilities: the MAC model against report Table 1, stage
timing, the per-arm profile, the torch.profiler trace, generators, log
emitters, plots, and the per-stage profile measured on the card.

The counterpart of ``tests/test_utils.py`` for ``sdr_tpu_torch.utils``.
``profile_stages`` runs here on the CPU (host clock) and must refuse to
run without a card unless the CPU is asked for.  The artifacts
``docs/torch_profile_stages_m<mode>_c<C>.json`` are written on the card by
``scripts/torch_profile_stages.py``; no sweep runs here (an eager CPU PLL
costs ~0.8 s a block), their gates do.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_tpu_torch import config as cfg
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.utils import gen, logfiles, profiling, synth

torch.set_num_threads(1)

DOCS = Path(__file__).resolve().parents[1] / "docs"
# the sweep's cases (mode, C): scripts/torch_profile_stages.py CASES
PROFILE_CASES = [(0, 1), (0, 128), (0, 512), (0, 1024), (1, 1), (1, 512),
                 (2, 1), (2, 512), (3, 1), (3, 512)]


@pytest.fixture
def no_cuda(monkeypatch):
    """torch as built for the CPU only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


class TestMacModel:
    """Report Table 1 (BASELINE.md rows 1-2): exact for the integer modes,
    to rounding for the rational ones."""

    @pytest.mark.parametrize("mode,expected", [(0, 1111), (1, 1313),
                                               (2, 1200), (3, 1567)])
    def test_mono(self, mode, expected):
        mc = cfg.get_mode_config(mode)
        got = profiling.mac_per_audio_sample(mc, stereo=False, taps=101)
        assert abs(got - expected) < 3, (got, expected)

    @pytest.mark.parametrize("mode,expected", [(0, 2121), (1, 2525),
                                               (2, 2300), (3, 3033)])
    def test_stereo(self, mode, expected):
        mc = cfg.get_mode_config(mode)
        got = profiling.mac_per_audio_sample(mc, stereo=True, taps=101)
        assert abs(got - expected) < 6, (got, expected)

    def test_macs_per_second(self):
        mc = cfg.get_mode_config(0)
        assert profiling.macs_per_second(mc, stereo=True) == 2121 * 48e3


class TestStageTimer:
    def test_accumulates_and_reports(self):
        t = profiling.StageTimer()
        for _ in range(3):
            with t.span("front_end"):
                pass
        with t.span("audio"):
            pass
        assert t.counts["front_end"] == 3 and t.counts["audio"] == 1
        rep = t.report()
        assert "front_end" in rep and "audio" in rep


class TestStageProfile:
    def test_profile_stages_reports_arms(self):
        r = profiling.profile_stages(mode=0, n_blocks=2, device="cpu")
        for k in ("mono_ms", "stereo_ms", "stereo_arm_ms",
                  "stereo_rds_ms", "rds_arm_ms", "realtime_budget_ms"):
            assert k in r, k
        assert r["mono_ms"] > 0 and r["realtime_budget_ms"] == 24.0

    def test_profile_stages_needs_a_card_by_default(self, no_cuda):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiling.profile_stages(mode=1, n_blocks=1)


class TestTrace:
    def test_trace_to_writes_a_chrome_trace(self, tmp_path):
        with profiling.trace_to(str(tmp_path / "tr")) as path:
            x = torch.arange(1000.0)
            (x * x).sum()
        assert Path(path).parent == tmp_path / "tr"
        events = json.loads(Path(path).read_text())["traceEvents"]
        assert any("mul" in e.get("name", "") for e in events)


class TestLogfiles:
    def test_dat_format(self, tmp_path):
        path = logfiles.log_vector("vec", [1.5, -2.25], out_dir=str(tmp_path))
        lines = open(path).read().strip().split("\n")
        assert len(lines) == 2
        i, v = lines[1].split("\t")
        assert float(i) == 1.0 and float(v) == -2.25
        assert np.array_equal(logfiles.gen_index_vector(3), [0.0, 1.0, 2.0])


class TestGenerators:
    def test_generate_sin(self):
        x = gen.generate_sin(1000.0, 100.0, 1000)
        assert abs(x).max() <= 1.0
        xf = np.fft.rfft(x)
        assert np.argmax(np.abs(xf)) == 100

    def test_add_sin_superposition(self):
        x = gen.add_sin(1000.0, [50.0, 120.0], 1000)
        xf = np.abs(np.fft.rfft(x))
        peaks = set(np.argsort(xf)[-2:])
        assert peaks == {50, 120}

    def test_random_range(self):
        x = gen.random_samples(1000, 5.0, seed=1)
        assert abs(x).max() <= 5.0


class TestPlots:
    def test_psd_and_constellation_pngs(self, tmp_path):
        pytest.importorskip("matplotlib")
        from sdr_tpu_torch.utils import plotting
        x = gen.add_sin(240e3, [19e3, 38e3], 8192)
        p1 = plotting.save_psd_png(str(tmp_path / "psd.png"), x, 240e3)
        p2 = plotting.save_constellation_png(
            str(tmp_path / "c.png"),
            np.random.default_rng(0).normal(size=200),
            np.random.default_rng(1).normal(size=200))
        assert os.path.getsize(p1) > 1000 and os.path.getsize(p2) > 1000


class TestAnim:
    def test_gif_render(self, tmp_path):
        """Per-block PSD animation renders headless through the port's
        block program (ref model/fmMonoAnim.py)."""
        pytest.importorskip("matplotlib")
        from sdr_tpu_torch.utils import anim
        res = synth.synthesize_fm(duration_s=0.1, mode=0, with_rds=False,
                                  seed=4)
        iq = synth.u8_to_float(res.iq_u8)
        p = anim.animate_psd(iq, 0, arm="fm_demod",
                             out_path=str(tmp_path / "psd.gif"),
                             max_blocks=3, device="cpu")
        assert os.path.getsize(p) > 5000

    def test_needs_a_card_by_default(self, no_cuda, tmp_path):
        from sdr_tpu_torch.utils import anim
        with pytest.raises(RuntimeError, match="device='cpu'"):
            anim.animate_psd(np.zeros(200_000, np.float32), 0,
                             out_path=str(tmp_path / "x.gif"))

    def test_refuses_rds_arm_without_rds(self):
        from sdr_tpu_torch.utils import anim
        with pytest.raises(ValueError, match="no RDS"):
            anim.animate_psd(np.zeros(100, np.float32), 1, arm="rds_symbols",
                             device="cpu")


# --- the per-stage profile measured on the card ---------------------------


def _profile(mode: int, c: int) -> dict:
    return json.loads(
        (DOCS / f"torch_profile_stages_m{mode}_c{c}.json").read_text())


def test_profile_artifacts_cover_every_case():
    have = sorted(p.name for p in DOCS.glob("torch_profile_stages_*.json"))
    want = sorted(f"torch_profile_stages_m{m}_c{c}.json"
                  for m, c in PROFILE_CASES)
    assert have == want


@pytest.mark.parametrize("mode,c", PROFILE_CASES)
def test_profile_artifact_measured_on_the_card(mode, c):
    p = _profile(mode, c)
    assert p["platform"] == "gpu" and p["device"].startswith("cuda")
    # the card's name and power limit, as nvidia-smi gives them
    assert "," in p["card"] and p["card"].rstrip().endswith("W")
    assert p["torch"] and p["methodology"]
    assert (p["mode"], p["channels"]) == (mode, c)
    assert p["with_rds"] == (mode in (0, 2))
    t = p["timings_ms"]
    assert p["stage_sum_default_kernels_ms"] > 0
    assert t["block_graph"] > 0 and t["chunk_graph"] > 0
    assert all(t[n] > 0 for n in p["default_stages"])
    assert p["stage_sum_default_kernels_ms"] == pytest.approx(
        sum(t[n] for n in p["default_stages"]))
    assert p["pll_kernel"] == ("K3" if prx.fused_mixer_policy(
        c, 1 + p["with_rds"]) else "K2")
