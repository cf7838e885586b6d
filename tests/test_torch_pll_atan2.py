"""``ops.pll.pll_block(..., use_atan2=True)``, the reference's literal PLL
recurrence, against the JAX package's and against the port's
transcendental-free form.

The tone is that of tests/test_ops.py's ``use_atan2`` test (a 19,020 Hz
pilot at 240 kHz with a 700 Hz tone under it), two chained blocks of 2,000
samples.  The tolerance is 5e-3, the one ``sdr_tpu`` gives its two forms
and the receiver's PLL-driven arms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close

from sdr_tpu.ops import pll as jpll
from sdr_tpu_torch.ops import pll as ppll

ATOL = 5e-3
FS = 240e3
N = 2000


def _tone(rows: int = 1) -> np.ndarray:
    t = np.arange(2 * N) / FS
    x = np.stack([0.4 * np.sin(2 * np.pi * (19020 + 15 * r) * t + 0.3 + r)
                  + 0.01 * np.sin(2 * np.pi * 700 * t) for r in range(rows)])
    return x.astype(np.float32)


def _port_state(batch: tuple = ()) -> ppll.PllState:
    return ppll.PllState(*[leaf.expand(batch).clone()
                           for leaf in ppll.pll_init(nco_q_last=0.0)])


@pytest.mark.parametrize("rows", [1, 2])
def test_atan2_form_matches_jax(rows):
    """Both packages' literal recurrences, chained over two blocks (one
    station, then a batch of two), on every NCO value and state leaf."""
    x = _tone(rows) if rows > 1 else _tone()[0]
    batch = (rows,) if rows > 1 else ()
    jp = jpll.PllParams(freq=19e3, fs=FS, nco_scale=2.0)
    pp = ppll.PllParams(freq=19e3, fs=FS, nco_scale=2.0)
    js = jpll.PllState(*[jnp.broadcast_to(leaf, batch)
                         for leaf in jpll.pll_init(nco_q_last=0.0)])
    ps = _port_state(batch)
    for b in range(2):
        blk = np.ascontiguousarray(x[..., b * N:(b + 1) * N])
        ji, jq, js = jpll.pll_block(jnp.asarray(blk), js, jp, use_atan2=True)
        pi, pq, ps = ppll.pll_block(torch.from_numpy(blk), ps, pp,
                                    use_atan2=True)
        assert pi.shape == ji.shape == batch + (N + 1,)
        assert_close(pi, ji, ATOL, "nco_i")
        assert_close(pq, jq, ATOL, "nco_q")
        for name in ps._fields:
            assert_close(getattr(ps, name), getattr(js, name), ATOL, name)


def test_atan2_form_tracks_transcendental_free_form():
    """The port's two forms sample for sample (tests/test_ops.py's
    ``test_transcendental_free_equals_atan2_variant`` on the port)."""
    x = _tone()[0]
    pp = ppll.PllParams(freq=19e3, fs=FS, nco_scale=2.0)
    sa, sb = _port_state(), _port_state()
    for b in range(2):
        blk = torch.from_numpy(np.ascontiguousarray(x[b * N:(b + 1) * N]))
        ia, qa, sa = ppll.pll_block(blk, sa, pp, use_atan2=True)
        ib, qb, sb = ppll.pll_block(blk, sb, pp)
        assert_close(ia, ib, ATOL, "nco_i")
        assert_close(qa, qb, ATOL, "nco_q")
    # the carried feedback: cos/sin of the last angle in both forms
    assert_close(sa.feedback_i, sb.feedback_i, ATOL)
    assert_close(sa.feedback_q, sb.feedback_q, ATOL)


def test_default_form_is_the_transcendental_free_one():
    """``use_atan2=False`` is the default and the one-arm case of
    ``pll_block_fused``, bit for bit."""
    x = torch.from_numpy(_tone()[0, :N])
    pp = ppll.PllParams(freq=19e3, fs=FS, nco_scale=2.0)
    a = ppll.pll_block(x, _port_state(), pp)
    b = ppll.pll_block(x, _port_state(), pp, use_atan2=False)
    st1 = ppll.PllState(*[leaf[None] for leaf in _port_state()])
    ci, cq, cs = ppll.pll_block_fused(x[None], st1, (pp,))
    assert torch.equal(a[0], b[0]) and torch.equal(a[0], ci[0])
    assert torch.equal(a[1], b[1]) and torch.equal(a[1], cq[0])
    for name in a[2]._fields:
        assert torch.equal(getattr(a[2], name), getattr(b[2], name))
        assert torch.equal(getattr(a[2], name), getattr(cs, name)[0])
