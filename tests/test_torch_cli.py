"""The port's CLI (``sdr_tpu_torch.cli``, ``--device cpu``) against the JAX
package's (``sdr_tpu.cli``) on the same small captures, both driven in
process.

* Audio is compared within the receiver tolerances scaled to 16-bit PCM
  (full scale 16384): 2e-4 -> 7 LSB on mono, 5e-3 -> 164 LSB on the
  PLL-driven left/right.  The RDS reports (frame count, first offsets,
  station) must be equal.
* The port's output bytes do not depend on ``--inflight``.
* A ``--save-state``/``--resume`` split run is byte-identical to an
  uninterrupted run, single-station and wideband, as tests/test_io_cli.py
  and tests/test_wideband_streaming.py hold the JAX CLI.
* A checkpoint written by either CLI resumes in the other, within the
  same tolerances.
* Without a GPU, the port's CLI refuses to run unless given
  ``--device cpu``.
* ``--trace DIR`` writes a Chrome trace holding the block program's
  spans, and ``--stats`` prints the programs' counts.
"""

import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_tpu import cli as jcli
from sdr_tpu import config as cfg
from sdr_tpu.utils import synth
from sdr_tpu_torch import cli as pcli

# tier-1 runs several pytest workers on one host: one thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MONO_LSB = 7
STEREO_LSB = 164
BS = cfg.get_mode_config(0).default_block_size(True)     # 115,200 bytes
OFFSETS = "--offsets=-1500000,2000000"
STEREO_RDS = ["--mode", "0", "--stereo", "--rds", "--wav"]


def _run(cli, argv, decoders=None) -> str:
    """One in-process CLI run; returns its stderr.  The port runs on the
    CPU."""
    err = io.StringIO()
    if cli is pcli:
        argv = ["--device", "cpu", *argv]
    with contextlib.redirect_stderr(err):
        rc = (cli.main(argv) if decoders is None
              else cli.main(argv, rds_decoders=decoders))
    assert rc == 0, err.getvalue()
    return err.getvalue()


def _pcm(path) -> np.ndarray:
    """The int16 samples of a wav written by either CLI (44-byte header)."""
    return np.frombuffer(Path(path).read_bytes()[44:], np.int16)


def _rds_lines(stderr: str) -> list[str]:
    return [ln for ln in stderr.splitlines() if ln.startswith("RDS")]


def _station_lines(stderr: str) -> list[str]:
    return [ln.split("|", 1)[1] for ln in stderr.splitlines()
            if ln.startswith("station ")]


def _close(a: np.ndarray, b: np.ndarray, lsb: int) -> None:
    assert a.shape == b.shape and len(a) > 0
    assert np.abs(a.astype(np.int32) - b).max() <= lsb


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 0.15 s mode-0 stereo+RDS station (6 blocks) and a 0.15 s 9.6 MS/s
    capture of two stations (6 wideband blocks), each whole and split in
    two halves at a block boundary."""
    d = tmp_path_factory.mktemp("cli")
    st = synth.synthesize_fm(duration_s=0.15, mode=0, with_stereo=True,
                             with_rds=True, seed=13).iq_u8[:6 * BS]
    wb = synth.synthesize_wideband(duration_s=0.15, fs_wide=9.6e6,
                                   offsets_hz=[-1.5e6, 2.0e6], mode=0,
                                   seed=3, with_rds=True).iq_u8[:24 * BS]
    out = {"dir": d}
    for name, iq, half in (("st", st, 3 * BS), ("wb", wb, 12 * BS)):
        for part, data in (("", iq), ("_a", iq[:half]), ("_b", iq[half:])):
            (d / f"{name}{part}.raw").write_bytes(data.tobytes())
            out[name + part] = str(d / f"{name}{part}.raw")
    return out


@pytest.fixture(scope="module")
def stereo_runs(files):
    """Both CLIs, stereo + RDS to wav, on the whole station."""
    d = files["dir"]
    decs: list = []
    return {"port_err": _run(pcli, [*STEREO_RDS, files["st"], "-o",
                                    str(d / "port.wav")], decs),
            "jax_err": _run(jcli, [*STEREO_RDS, files["st"], "-o",
                                   str(d / "jax.wav")]),
            "port": _pcm(d / "port.wav"), "jax": _pcm(d / "jax.wav"),
            "decoders": decs}


def test_mono_pcm_matches_jax(files):
    d = files["dir"]
    _run(pcli, ["--mode", "0", files["st"], "-o", str(d / "mono_p.pcm")])
    _run(jcli, ["--mode", "0", files["st"], "-o", str(d / "mono_j.pcm")])
    p = np.fromfile(d / "mono_p.pcm", np.int16)
    j = np.fromfile(d / "mono_j.pcm", np.int16)
    mono_bs = cfg.get_mode_config(0).default_block_size(False)
    assert len(p) == 6 * BS // mono_bs * mono_bs // 2 // 50   # 48 kHz
    _close(p, j, MONO_LSB)


def test_stereo_wav_and_rds_match_jax(stereo_runs):
    _close(stereo_runs["port"], stereo_runs["jax"], STEREO_LSB)
    port_rds = _rds_lines(stereo_runs["port_err"])
    assert port_rds == _rds_lines(stereo_runs["jax_err"])
    (dec,) = stereo_runs["decoders"]
    assert port_rds[0].startswith(f"RDS: {dec.n_matches} frames")
    assert dec.n_matches >= 4


def test_output_invariant_under_inflight(files, stereo_runs):
    out = files["dir"] / "inflight1.wav"
    _run(pcli, [*STEREO_RDS, files["st"], "-o", str(out), "--inflight",
                "1"])
    assert np.array_equal(_pcm(out), stereo_runs["port"])


def test_resume_split_is_byte_identical(files, stereo_runs):
    d = files["dir"]
    ck = str(d / "port_ck.npz")
    _run(pcli, [*STEREO_RDS, files["st_a"], "-o", str(d / "pa.wav"),
                "--save-state", ck])
    err = _run(pcli, [*STEREO_RDS, files["st_b"], "-o", str(d / "pb.wav"),
                      "--resume", ck])
    whole = stereo_runs["port"]
    assert np.array_equal(np.concatenate([_pcm(d / "pa.wav"),
                                          _pcm(d / "pb.wav")]), whole)
    n_frames = re.findall(r"RDS: (\d+) frames", err)
    assert n_frames == re.findall(r"RDS: (\d+) frames",
                                  stereo_runs["port_err"])


def test_checkpoints_resume_across_packages(files, stereo_runs):
    """First half in one CLI, second half in the other, both ways: the
    second half agrees with the uninterrupted runs."""
    d = files["dir"]
    half = len(stereo_runs["jax"]) // 2
    for first, second in ((jcli, pcli), (pcli, jcli)):
        tag = "jp" if first is jcli else "pj"
        ck = str(d / f"{tag}.npz")
        _run(first, [*STEREO_RDS, files["st_a"], "-o",
                     str(d / f"{tag}_a.wav"), "--save-state", ck])
        err = _run(second, [*STEREO_RDS, files["st_b"], "-o",
                            str(d / f"{tag}_b.wav"), "--resume", ck])
        tail = _pcm(d / f"{tag}_b.wav")
        _close(tail, stereo_runs["jax"][half:], STEREO_LSB)
        _close(tail, stereo_runs["port"][half:], STEREO_LSB)
        assert re.findall(r"RDS: (\d+) frames", err) == re.findall(
            r"RDS: (\d+) frames", stereo_runs["jax_err"])


def test_wideband_matches_jax_and_resumes(files):
    d = files["dir"]
    wide = [*STEREO_RDS, "--wideband", "9600000", OFFSETS]
    port_err = _run(pcli, [*wide, files["wb"], "-o", str(d / "wp")])
    jax_err = _run(jcli, [*wide, files["wb"], "-o", str(d / "wj")])
    assert _station_lines(port_err) == _station_lines(jax_err)
    assert "RDS" in _station_lines(port_err)[0]
    for k in range(2):
        _close(_pcm(d / f"wp_{k}.wav"), _pcm(d / f"wj_{k}.wav"), STEREO_LSB)
    ck = str(d / "wck.npz")
    _run(pcli, [*wide, files["wb_a"], "-o", str(d / "wa"), "--save-state",
                ck])
    err = _run(pcli, [*wide, files["wb_b"], "-o", str(d / "wb"), "--resume",
                      ck])
    assert _station_lines(err) == _station_lines(port_err)
    for k in range(2):
        split = np.concatenate([_pcm(d / f"wa_{k}.wav"),
                                _pcm(d / f"wb_{k}.wav")])
        assert np.array_equal(split, _pcm(d / f"wp_{k}.wav"))


def test_refuses_to_run_without_a_gpu(files):
    """``--device`` defaults to cuda: with no GPU the CLI exits non-zero
    with a message instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    proc = subprocess.run(
        [sys.executable, "-m", "sdr_tpu_torch.cli", "--mode", "0",
         files["st_a"], "-o", str(files["dir"] / "none.pcm")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not (files["dir"] / "none.pcm").exists()


def test_trace_and_stats_read_the_spans_and_counts(files):
    """``--trace DIR`` writes a Chrome trace of the decode loop holding
    the block program's spans, one replay a block, and ``--stats`` prints
    the programs' counts of the run, single-station and wideband (mono:
    a CPU profile records each op of the PLLs' plain per-sample loops)."""
    d = files["dir"]
    for name, argv, blocks in (
            ("st", ["--mode", "0", files["st"], "-o", str(d / "tr.pcm")], 6),
            ("wb", ["--mode", "0", "--wav", "--wideband", "9600000", OFFSETS,
                    files["wb"], "-o", str(d / "trw")], 6)):
        err = _run(pcli, [*argv, "--stats", "--trace", str(d / name)])
        path, = re.findall(r"^trace: (.+)$", err, re.M)
        assert Path(path).parent == d / name
        events = json.loads(Path(path).read_text())["traceEvents"]
        names = [e.get("name") for e in events]
        # the wideband loop replays the channelizer's program too
        assert names.count("sdr.program.replay") >= blocks
        assert names.count("sdr.program.copy_out") >= blocks
        counts = dict(re.findall(r"(\w+) (\d+)", re.search(
            r"^programs: (.+)$", err, re.M).group(1)))
        assert set(counts) == {"captures", "warm_ups", "replays", "blocks"}
        assert int(counts["replays"]) == names.count("sdr.program.replay")
