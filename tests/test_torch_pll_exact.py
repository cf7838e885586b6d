"""The exact shortcuts of the PLL kernels' feedback chain, on the CPU.

K2 and K3 (``csrc/pll.cu``) replace two steps of the plain loop
(``ops.pll.pll_args_loop``) by cheaper ones that must give the same bits:

* the turn count ``floor(fl(fl(arg / 2pi) + 0.5))`` becomes the number of
  host-computed breakpoints ``<= arg`` (``pll_cuda.turn_breakpoints``) for
  ``arg`` in [0, 2m];
* the phase wrap ``torch.remainder(x, m)`` becomes ``x``, ``x - m`` or
  ``x + m`` on (-m, 2m).

Both are checked here against the plain loop's own operations, exactly
(bit patterns, so the sign of zero counts), for both arms' moduli: the
pilot PLL's m = 2pi (NCO x2) and the RDS PLL's m = 4pi (NCO x0.5).  Then
the kernels' step, written here with the same arithmetic (compares as 1.0
/ 0.0, the wrap and the detector as multiply-adds rounded once, emulated
exactly in float64), equals the plain loop bit for bit over chained
blocks, and the kernels' operand layout (``LaneLayout``) is checked.
"""

import math

import numpy as np
import pytest
import torch

from sdr_tpu_torch import config as pcfg
from sdr_tpu_torch import stimulus
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.ops import pll as tpll
from sdr_tpu_torch.ops import pll_cuda

MC = pcfg.get_mode_config(0)
PARAMS = (prx.pilot_pll_params(MC), prx.rds_pll_params(MC))
MODULI = [np.float32(p.wrap_modulus) for p in PARAMS]
TWO_PI = torch.tensor(2.0 * math.pi, dtype=torch.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32)


def turns_plain(arg: torch.Tensor) -> torch.Tensor:
    """The plain loop's turn count (a 0-d tensor divisor, as it divides)."""
    return torch.floor(arg / TWO_PI + 0.5)


def turns_fast(arg: torch.Tensor) -> torch.Tensor:
    """The kernels' count: breakpoints at or below ``arg``."""
    b = torch.from_numpy(pll_cuda.turn_breakpoints())
    return (arg[..., None] >= b).sum(-1).to(torch.float32)


def wrap_fast(x: torch.Tensor, m) -> torch.Tensor:
    """The kernels' wrap: x on [0, m), x - m on [m, 2m), x + m on (-m, 0),
    torch.remainder elsewhere (``m`` a float or broadcasting tensor)."""
    r = torch.where(x >= m, x - m, torch.where(x < 0, x + m, x))
    return torch.where((x > -m) & (x < 2 * m), r, torch.remainder(x, m))


def _ulps_around(b: np.float32, k: int) -> np.ndarray:
    bits = np.int64(np.array(b, np.float32).view(np.int32))
    return np.arange(bits - k, bits + k + 1).astype(np.int32).view(np.float32)


def test_breakpoints_are_increasing_and_exact_floats():
    b = pll_cuda.turn_breakpoints()
    assert b.dtype == np.float32 and b.shape == (4,)
    assert np.all(np.diff(b) > 0)
    # each is the first float whose count reaches k: its predecessor's is k-1
    prev = np.nextafter(b, np.float32(0))
    np.testing.assert_array_equal(turns_plain(torch.from_numpy(b)).numpy(),
                                  [1, 2, 3, 4])
    np.testing.assert_array_equal(turns_plain(torch.from_numpy(prev)).numpy(),
                                  [0, 1, 2, 3])


def test_turns_near_every_breakpoint():
    """Every float within 4,096 ulps of each breakpoint."""
    a = torch.from_numpy(np.concatenate(
        [_ulps_around(b, 4096) for b in pll_cuda.turn_breakpoints()]))
    np.testing.assert_array_equal(_bits(turns_fast(a)), _bits(turns_plain(a)))


@pytest.mark.parametrize("m", MODULI, ids=["pilot", "rds"])
def test_turns_on_the_chains_range(m):
    """10^6 seeded args in [0, 2m), and 0, 2m - ulp, 2m."""
    two_m = np.float32(2) * m
    rng = np.random.default_rng(int(m * 1000))
    a = rng.uniform(0, two_m, 1_000_000).astype(np.float32)
    edges = np.array([0.0, np.nextafter(two_m, np.float32(0)), two_m],
                     np.float32)
    a = torch.from_numpy(np.concatenate([a[a < two_m], edges]))
    np.testing.assert_array_equal(_bits(turns_fast(a)), _bits(turns_plain(a)))


@pytest.mark.parametrize("m", MODULI, ids=["pilot", "rds"])
def test_wrap_edges(m):
    ulp_below = lambda v: np.nextafter(np.float32(v), np.float32(-np.inf))
    ulp_above = lambda v: np.nextafter(np.float32(v), np.float32(np.inf))
    two_m = np.float32(2) * m
    x = torch.tensor([0.0, -0.0, ulp_below(m), m, ulp_above(m),
                      ulp_below(two_m), two_m, ulp_above(-m), -m,
                      ulp_below(-m), -1e-45, -1e-38, -1e-30, -1e-8, -1e-3,
                      1e-45, np.inf, -np.inf, np.nan, 3 * m, -5.5 * m],
                     dtype=torch.float32)
    np.testing.assert_array_equal(_bits(wrap_fast(x, float(m))),
                                  _bits(torch.remainder(x, float(m))))


@pytest.mark.parametrize("m", MODULI, ids=["pilot", "rds"])
def test_wrap_on_the_chains_range(m):
    """10^6 seeded values in (-m, 2m)."""
    rng = np.random.default_rng(int(m * 100))
    x = rng.uniform(-m, 2 * m, 1_000_000).astype(np.float32)
    x = torch.from_numpy(x[(x > -m) & (x < 2 * m)])
    np.testing.assert_array_equal(_bits(wrap_fast(x, float(m))),
                                  _bits(torch.remainder(x, float(m))))


def fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (exact in float64 at these
    magnitudes: one factor is 0 or +-1)."""
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64)
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def step_fast(xk, integ, phase, psi, aw, kp, ki, w, m):
    """One step of ``csrc/pll.cu``'s ``Chain::step_fast``, op for op."""
    f = lambda cond: cond.to(torch.float32)          # set.f32: 1.0 / 0.0
    pi, two_pi = np.float32(math.pi), np.float32(2 * math.pi)
    pos = xk > 0
    up = f(aw > 0)
    c = fma(torch.where(pos, -0.0, two_pi), up, torch.where(pos, -0.0, -pi))
    e = c - aw
    far = f(aw.abs() >= np.float32(math.pi / 2))
    e0 = fma(-two_pi, up, pi) * far + 0.0
    err = torch.where(pos | (xk < 0), e, e0)
    integ = integ + ki * err
    x = phase + kp * err + integ
    y = psi + w
    phase = fma(-m, f(x >= m) - f(x < 0), x)
    psi = fma(-m, f(y >= m) - f(y < 0), y)
    arg = psi + phase
    b = torch.from_numpy(pll_cuda.turn_breakpoints())
    t = (f(arg >= b[0]) + f(arg >= b[1])) + (f(arg >= b[2]) + f(arg >= b[3]))
    aw = arg - TWO_PI * t
    in_range = ((x > -m) & (x < 2 * m) & (y > -m) & (y < 2 * m)
                & (arg >= 0) & (arg <= 2 * m))
    return arg, (integ, phase, psi, aw), bool(in_range.all())


def chain_fast(xs, integ, phase, psi, aw, kp, ki, w, m):
    """``pll_args_loop`` as the kernels step it; every step must stay in
    the shortcuts' ranges (the kernels would replay otherwise)."""
    args = torch.empty_like(xs)
    carry = (integ, phase, psi, aw)
    for t in range(xs.shape[0]):
        args[t], carry, ok = step_fast(xs[t], *carry, kp, ki, w, m)
        assert ok, t
    return args, carry


def test_fast_chain_equals_plain_loop_over_chained_blocks():
    """Two channels x (pilot, RDS) arms, PLL tones with exact zeros (the
    detector's third case) and both signs of zero in the carry, three
    chained blocks: angles and carries bit-equal to the plain loop."""
    x = torch.from_numpy(stimulus.pll_tones(7, 2, 3 * 400, MC.if_fs))
    x[..., ::37] = 0.0
    ly = pll_cuda.LaneLayout(x[..., :400], PARAMS)
    st = prx.init_state(MC, (2,), device="cpu")
    c0 = ly.carry0(tpll.stack_arms([st.pilot_pll, st.rds_pll]), False)
    c0[3, 1::2] = -0.0
    plain = fast = tuple(c0)
    consts = ly.consts(False)[:4]
    for b in range(3):
        xs = ly.time_major(x[..., b * 400:(b + 1) * 400])
        ap, plain = tpll.pll_args_loop(xs, *plain, *consts)
        af, fast = chain_fast(xs, *fast, *consts)
        np.testing.assert_array_equal(_bits(af), _bits(ap))
        for u, v in zip(fast, plain):
            np.testing.assert_array_equal(_bits(u), _bits(v))


# --- the kernels' operand layout ---------------------------------------------


@pytest.mark.parametrize("c,k", [(1, 2), (3, 2), (8, 2), (2, 1)])
def test_lane_layout_pads_rows_to_16_bytes(c, k):
    x = torch.randn(c, k, 37)
    ly = pll_cuda.LaneLayout(x, PARAMS[:k])
    xs = ly.time_major(x)
    lanes, ld = c * k, pll_cuda.lane_stride(c * k)
    assert ld % 4 == 0 and 0 <= ld - lanes < 4
    assert xs.shape == (37, lanes) and xs.stride() == (ld, 1)
    assert xs.data_ptr() % 16 == 0
    full = torch.as_strided(xs, (37, ld), (ld, 1))
    assert torch.all(full[:, lanes:] == 0)
    torch.testing.assert_close(ly.from_time_major(xs), x, rtol=0, atol=0)
    assert pll_cuda._kernel_rows(xs) is xs
    bps = torch.from_numpy(pll_cuda.turn_breakpoints())
    for mixer, rows in ((False, 8), (True, 10)):
        consts = ly.consts(mixer)
        assert consts.shape == (rows, lanes) and consts.is_contiguous()
        assert torch.equal(consts[-4:], bps[:, None].expand(4, lanes))


def test_kernel_rows_copies_other_layouts():
    a = torch.randn(9, 6)                     # rows 6 floats apart
    b = pll_cuda._kernel_rows(a)
    assert b is not a and b.stride() == (8, 1) and torch.equal(a, b)
    wide = torch.randn(9, 12)[:, 1:7]         # misaligned base
    c = pll_cuda._kernel_rows(wide)
    assert c.stride() == (8, 1) and c.data_ptr() % 16 == 0
    assert torch.equal(c, wide)


def test_chain_floor_plain_is_k2_on_its_signs():
    x = torch.zeros(1, 2, 1)
    ly = pll_cuda.LaneLayout(x, PARAMS)
    st = prx.init_state(MC, (1,), device="cpu")
    c0 = ly.carry0(tpll.stack_arms([st.pilot_pll, st.rds_pll]), False)
    signs = pll_cuda.floor_signs(300, 2)
    assert set(np.unique(signs)) == {-1.0, 1.0}
    got = pll_cuda.chain_floor(c0, ly.consts(False), 300)
    want = pll_cuda.pll_angles_plain(torch.from_numpy(signs), c0,
                                     ly.consts(False))[1]
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        pll_cuda.chain_floor(torch.zeros(4, 33), torch.zeros(8, 33), 10)
