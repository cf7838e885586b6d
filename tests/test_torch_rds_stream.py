"""The port's streaming RDS decoder against the JAX package's.

Both are numpy on the host, so the comparison is exact: the same soft
symbols, fed in the same uneven chunks, must give the same frame matches,
groups and station information, and a decoder's carry saved by one
package must resume in the other with the same stream.  The symbols are
the JAX receiver's RRC output on a synthesized station (1.2 s, structured
programme information, light noise), as tests/test_rds_streaming.py makes
them.
"""

import dataclasses

import numpy as np
import pytest

from sdr_tpu import config as cfg
from sdr_tpu.models import rds_decode as jrds
from sdr_tpu.utils import synth
from sdr_tpu_torch.models import rds_decode as prds

SPS = cfg.get_mode_config(0).rds.sps
STATION = synth.StationConfig(pi=0x54B1, pty=9, ps="CUDA FM ",
                              radiotext="HELLO H100", tp=True)


@pytest.fixture(scope="module")
def symbols():
    from sdr_tpu.models.receiver import Receiver

    res = synth.synthesize_fm(duration_s=1.2, mode=0, seed=3,
                              with_rds=True, noise_std=0.02,
                              rds_station=STATION)
    outs = Receiver(0, stereo=True, with_rds=True).run(res.iq_u8)
    return np.asarray(outs.rds_symbols).reshape(-1)


def _chunks(x: np.ndarray, seed: int = 0) -> list[np.ndarray]:
    """Uneven chunks, from 1 sample to ~3 blocks' worth."""
    rng = np.random.default_rng(seed)
    cuts = np.cumsum(rng.integers(1, 3000, size=len(x) // 500))
    return np.split(x, cuts[cuts < len(x)])


def _same(p, j) -> None:
    """Two decoders (of either package) in the same state."""
    pa, pm = p.state_dict()
    ja, jm = j.state_dict()
    # the list of assembled groups restarts on resume: summary, not carry
    pm.pop("n_groups_assembled")
    jm.pop("n_groups_assembled")
    assert pm == jm
    assert pa.keys() == ja.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], ja[k], k)
    ps, js = p.station_info(), j.station_info()
    for f in dataclasses.fields(ps):
        np.testing.assert_array_equal(getattr(ps, f.name),
                                      getattr(js, f.name), f.name)


@pytest.mark.parametrize("algo", ["robust", "reference", "tracking"])
def test_uneven_chunks_match_jax(symbols, algo):
    p = prds.StreamingRdsDecoder(SPS, algo)
    j = jrds.StreamingRdsDecoder(SPS, algo)
    for chunk in _chunks(symbols):
        assert p.feed(chunk) == j.feed(chunk)
    assert p.flush() == j.flush()
    _same(p, j)
    assert [(g.bit_pos, g.gtype, g.version) for g in p.groups] == \
        [(g.bit_pos, g.gtype, g.version) for g in j.groups]
    assert p.n_matches >= 20
    if algo != "reference":
        st = p.station_info()
        assert (st.pi, st.ps_name) == (STATION.pi, STATION.ps)


@pytest.mark.parametrize("algo", ["robust", "tracking"])
def test_state_dict_resumes_across_packages(symbols, algo):
    """Half the stream in one package, the rest in the other, both ways:
    the frame stream continues as in an uninterrupted run."""
    chunks = _chunks(symbols, seed=1)
    half = len(chunks) // 2
    whole = jrds.StreamingRdsDecoder(SPS, algo)
    want = [m for c in chunks for m in whole.feed(c)]
    for first, second in ((prds, jrds), (jrds, prds)):
        d = first.StreamingRdsDecoder(SPS, algo)
        got = [m for c in chunks[:half] for m in d.feed(c)]
        d = second.StreamingRdsDecoder.load_state_dict(*d.state_dict())
        got += [m for c in chunks[half:] for m in d.feed(c)]
        assert got == want
        _same(d, whole)


def test_decode_reference_matches_jax(symbols):
    n = len(symbols) // 960 * 960
    blocks = symbols[:n].reshape(-1, 960)
    p = prds.decode_reference(blocks, SPS)
    j = jrds.decode_reference(blocks, SPS)
    assert p.frames.matches == j.frames.matches
    np.testing.assert_array_equal(p.bits, j.bits)
    np.testing.assert_array_equal(p.info_words, j.info_words)


def test_unknown_algo_is_refused():
    with pytest.raises(ValueError):
        prds.StreamingRdsDecoder(SPS, "fast")
