"""What surrounds the FIR template (K5, K1, K4) and K6, checked on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py); their
geometry and layouts are Python, and are held here:

* K5's launch plan (``ops.fir_decim.plan``) at the decimations, tap counts,
  channel counts and element steps of the paths and at ragged and short
  blocks: every output of every row is computed by exactly one lane, the
  shared memory fits a block, the grid has at least 132 blocks wherever
  the outputs allow it, the staged span of every work item fits its
  stage, and for every tap count and decimation the swizzled window rows
  of a phase stay inside its row of the split buffer;
* the same for the template's one-byte instances, K1 (u8, interleaved
  I/Q: two lanes) and K4 (int8, deinterleaved: one lane), whose spans are
  staged as bytes; and the summation order of every output of a row is
  the same under the plans of C=1, C=4 and C=512, so that a row's output
  does not depend on the batch;
* K6's row-block description (``parallel.halo.RowBlocks``) of a
  ``time_sharded_receive``-style (T, S, rows, L) tensor gives the same
  source and destination addresses as the per-shard slices; layouts that
  are not 16-byte multiples go to the table entry, overlapping ones are
  refused, and the plain version of the tensor form equals the plain
  version of the lists;
* the private PyTorch binding the wrappers launch on
  (``kernels.build.current_stream``) is still declared by torch.
"""

import pathlib

import numpy as np
import pytest
import torch

from sdr_tpu_torch.kernels import build
from sdr_tpu_torch.ops import fir_decim
from sdr_tpu_torch.parallel import halo as phalo

SMS = 132


def _covered(p: fir_decim.FirPlan) -> np.ndarray:
    """How often each (row, output) is computed under plan ``p``."""
    hits = np.zeros((p.spans * p.lanes, p.n_out), np.int32)
    for block in range(p.grid):
        for row, j, count, _ in p.outputs(block):
            hits[row, j:j + count] += 1
    return hits


@pytest.mark.parametrize("decim", [3, 4, 5, 8, 10])
@pytest.mark.parametrize("k", [101, 151])
@pytest.mark.parametrize("c,lanes", [(1, 2), (2, 1), (64, 1), (512, 2)])
def test_k5_plan_covers_every_output_once(decim, k, c, lanes):
    """Ragged blocks (n_out not a multiple of any tile) and a block
    shorter than K-1, at C = 1, 2, 64, 512 with element step 2 (two
    interleaved arms per span) and step 1 (arms as spans)."""
    spans = c if lanes == 2 else 2 * c
    for n_out in (5_767, (k - 1) // decim - 3, 1):
        p = fir_decim.plan(spans, lanes, n_out * decim, k, decim, SMS)
        assert (_covered(p) == 1).all(), (n_out, p)


@pytest.mark.parametrize("decim", [3, 4, 5, 8, 10])
@pytest.mark.parametrize("k", [101, 151])
@pytest.mark.parametrize("c,lanes,n", [(1, 2, 57_600), (2, 1, 230_400),
                                       (2, 1, 460_800), (64, 1, 460_800),
                                       (512, 2, 57_600), (3, 2, 140)])
def test_k5_plan_fits_and_fills_the_card(decim, k, c, lanes, n):
    n -= n % decim
    spans = c if lanes == 2 else 2 * c
    p = fir_decim.plan(spans, lanes, n, k, decim, SMS)
    assert p.smem <= fir_decim.MAX_SHARED
    assert p.smem == fir_decim._shared_bytes(decim, p.r_pad, p.raw, p.stages,
                                             p.warps, p.spw)
    # the blocks that share an SM, and the grid
    assert p.stages in (1, 2, 3)
    per_sm = fir_decim.blocks_per_sm(p)
    assert per_sm * (p.smem + 1024) <= fir_decim.SM_SHARED
    assert p.grid == min(p.items, per_sm * SMS)
    if spans * -(-p.n_out // 32) >= SMS:
        assert p.grid >= SMS
    assert p.grid <= p.items
    # taps, window rows and a stage's span, as the kernel reads them
    assert p.r_pad % fir_decim.TAPS_STEP == 0 and p.r_pad * decim >= k
    assert p.spw % 4 == 0 and p.spw >= 32 * p.r + p.r_pad
    assert p.raw % 16 == 0
    assert p.raw >= (p.tile + p.r_pad) * decim * lanes * 4 + 32
    assert p.tile == 32 * p.r * (p.warps // lanes)


def test_k5_plan_at_the_paths_shapes():
    """The large shapes keep R = 8; the small ones take R = 1 to spread
    over the card."""
    big = [fir_decim.plan(128, 1, 460_800, 151, 8),     # channelizer C=64
           fir_decim.plan(512, 2, 57_600, 151, 10)]     # front-end C=512
    small = [fir_decim.plan(1, 2, 57_600, 151, 10),     # front-end C=1
             fir_decim.plan(4, 1, 230_400, 151, 4)]     # channelizer C=2
    assert [p.r for p in big] == [8, 8]
    assert [p.r for p in small] == [1, 8]
    assert all(p.grid >= SMS for p in big + small)


def _swizzled(m: np.ndarray) -> np.ndarray:
    """Where window row m of a phase lies in its row of the split buffer
    (csrc/fir_decim.cu, swz)."""
    return m ^ (((m >> 5) & 1) << 2)


@pytest.mark.parametrize("decim", range(2, 21))
def test_k5_swizzled_rows_stay_in_their_phase_row(decim):
    """For K = 2..400, in the R = 8 and R = 1 plans and for one and two
    interleaved arms, every window row a warp splits and reads (32 * R +
    r_pad of them, in aligned groups of 8) lies below the phase row's
    length: none spills into the next phase, the next warp or past the
    block's shared memory."""
    for k in range(2, 401):
        for lanes in (1, 2):
            big = fir_decim.plan(128 // lanes, lanes, decim * 5_760, k, decim)
            small = fir_decim.plan(1, lanes, decim * 100, k, decim)
            assert (big.r, small.r) == (8, 1), (k, lanes)
            for p in (big, small):
                rows = 32 * p.r + p.r_pad
                assert _swizzled(np.arange(rows)).max() < p.spw, (k, p)
                assert -(-rows // 8) * 8 <= p.spw, (k, p)


def test_k5_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        fir_decim.plan(1, 3, 100, 151, 10)
    with pytest.raises(ValueError):
        fir_decim.plan(1, 1, 105, 151, 10)


# --- the one-byte instances: K1 (u8) and K4 (int8) -------------------------

# the layout each takes: K1 the interleaved bytes (two lanes, a span per
# channel), K4 the deinterleaved int8 stack (one lane, a span per arm)
ONE_BYTE = {"u8": 2, "int8": 1}


def _one_byte_plan(dtype: str, c: int, n: int, k: int, decim: int
                   ) -> fir_decim.FirPlan:
    """The plan the wrapper makes for ``c`` channels of ``n`` I/Q pairs."""
    lanes = ONE_BYTE[dtype]
    return fir_decim.plan(c * (3 - lanes), lanes, n, k, decim, SMS, 1)


@pytest.mark.parametrize("dtype", ["u8", "int8"])
@pytest.mark.parametrize("decim", [3, 10])
@pytest.mark.parametrize("c", [1, 7, 512])
def test_one_byte_plan_covers_every_output_once(dtype, decim, c):
    """Ragged blocks and a block shorter than K-1, at C = 1, 7 (R = 1) and
    512 (R = 8)."""
    for n_out in (5_767, 150 // decim - 3, 1):
        p = _one_byte_plan(dtype, c, n_out * decim, 151, decim)
        assert (_covered(p) == 1).all(), (n_out, p)


@pytest.mark.parametrize("dtype", ["u8", "int8"])
@pytest.mark.parametrize("k,decim", [(151, 10), (151, 8), (125, 3),
                                     (31, 10)])
@pytest.mark.parametrize("c,n", [(1, 57_600), (4, 57_600), (512, 57_600),
                                 (3, 140)])
def test_one_byte_plan_fits_and_fills_the_card(dtype, k, decim, c, n):
    """Shared bytes within a block's, the grid, and a stage holding the
    item's span of bytes."""
    n -= n % decim
    p = _one_byte_plan(dtype, c, n, k, decim)
    assert p.smem <= fir_decim.MAX_SHARED
    assert p.smem == fir_decim._shared_bytes(decim, p.r_pad, p.raw, p.stages,
                                             p.warps, p.spw)
    per_sm = fir_decim.blocks_per_sm(p)
    assert per_sm * (p.smem + 1024) <= fir_decim.SM_SHARED
    assert p.grid == min(p.items, per_sm * SMS)
    assert p.raw % 16 == 0
    assert p.raw >= (p.tile + p.r_pad) * decim * p.lanes + 32
    assert p.r_pad % fir_decim.TAPS_STEP == 0 and p.r_pad * decim >= k
    assert p.spw % 4 == 0 and p.spw >= 32 * p.r + p.r_pad
    assert p.tile == 32 * p.r * (p.warps // p.lanes)


@pytest.mark.parametrize("dtype", ["u8", "int8"])
def test_one_byte_plan_spreads_a_single_channel(dtype):
    """At C=1 (``receive()`` and the CLI) the mode-0 block of K=151, D=10
    spreads over more work items, and blocks, than the card's 132 SMs
    (the first K1 took 23 blocks); C=512 keeps R = 8."""
    small = _one_byte_plan(dtype, 1, 57_600, 151, 10)
    big = _one_byte_plan(dtype, 512, 57_600, 151, 10)
    assert big.r == 8 and big.grid >= SMS
    assert small.r == 1 and small.items > SMS and small.grid > SMS


@pytest.mark.parametrize("dtype", ["u8", "int8"])
@pytest.mark.parametrize("decim", range(2, 21))
def test_one_byte_swizzled_rows_stay_in_their_phase_row(dtype, decim):
    """For K = 2..400, at C=1 and C=64, every window row a warp splits and
    reads lies below its phase row's length."""
    for k in range(2, 401):
        for c in (1, 64):
            p = _one_byte_plan(dtype, c, decim * 5_760, k, decim)
            rows = 32 * p.r + p.r_pad
            assert _swizzled(np.arange(rows)).max() < p.spw, (k, p)
            assert -(-rows // 8) * 8 <= p.spw, (k, p)


def _row0_order(p: fir_decim.FirPlan) -> dict:
    """output j of row 0 -> what decides its summation order under ``p``."""
    got = {}
    for item in range(p.n_tiles):               # span 0's items
        for row, j, count, order in p.item_outputs(item):
            if row == 0:
                for i in range(count):
                    got[j + i] = order
    return got


@pytest.mark.parametrize("dtype", ["f32", "u8", "int8"])
def test_summation_order_does_not_depend_on_the_plan(dtype):
    """Every output of row 0 sums in the same order under the plans of
    C=1, C=4 and C=512 (R and grid differ), which is what makes row 0 of
    a batch bit-identical to the row alone on the card."""
    k, decim, n = 151, 10, 57_600
    if dtype == "f32":
        plans = [fir_decim.plan(c, 2, n, k, decim) for c in (1, 4, 512)]
    else:
        plans = [_one_byte_plan(dtype, c, n, k, decim) for c in (1, 4, 512)]
    assert len({p.r for p in plans}) > 1
    orders = [_row0_order(p) for p in plans]
    assert sorted(orders[0]) == list(range(n // decim))
    assert orders[0] == orders[1] == orders[2]


# --- K6: row blocks -----------------------------------------------------------


def _ext(t: int, s: int, c: int, halo: int, seg: int) -> torch.Tensor:
    """A time_sharded_receive-style buffer: cells (b, k) of a t x s grid,
    b-major, each c rows of [halo | segment], random segments."""
    rng = np.random.default_rng(t * 100 + s * 10 + c)
    buf = torch.full((t * s * c, halo + seg), float("nan"))
    buf[:, halo:] = torch.from_numpy(
        rng.standard_normal((t * s * c, seg)).astype(np.float32))
    return buf


def _views(ext: torch.Tensor, t: int, s: int, c: int):
    return [[ext[(b * s + k) * c:(b * s + k + 1) * c] for k in range(s)]
            for b in range(t)]


@pytest.mark.parametrize("t,s,c", [(1, 8, 1), (1, 8, 4), (2, 4, 3),
                                   (1, 1, 2)])
def test_k6_row_blocks_match_the_shard_slices(t, s, c):
    halo, seg = 37, 100
    ext = _ext(t, s, c, halo, seg)
    views = _views(ext, t, s, c)
    rb = phalo.row_blocks_of(ext.view(t, s, c, halo + seg), halo)
    assert (rb.time_rows, rb.shards, rb.rows, rb.n, rb.length) == (
        t, s, c, halo, halo + seg)
    for b in range(t):
        for k in range(s):
            for r in range(c):
                src, dst = rb.offsets(b, k, r)
                assert dst == views[b][k][r, :halo].data_ptr()
                if k:
                    assert src == views[b][k - 1][r, -halo:].data_ptr()
                else:
                    assert src is None


def _layout(case: str) -> tuple[torch.Tensor, int]:
    """A (1, 4, 2, L) shard tensor and its halo, laid out as ``case``
    says."""
    if case == "aligned":
        return _ext(1, 4, 2, 16, 48).view(1, 4, 2, 64), 16
    if case == "odd halo":
        return _ext(1, 4, 2, 17, 47).view(1, 4, 2, 64), 17
    if case == "odd length":
        return _ext(1, 4, 2, 16, 50).view(1, 4, 2, 66), 16
    if case == "odd row stride":
        return _ext(1, 4, 2, 16, 50)[:, :64].view(1, 4, 2, 64), 16
    if case == "odd base":
        flat = torch.zeros(1 + 8 * 64)
        return flat[1:].view(1, 4, 2, 64), 16
    if case == "strided time":
        return _ext(1, 8, 1, 16, 48).view(1, 8, 1, 64)[..., ::2], 16
    # "overlap": each shard starts one row into the one before
    return torch.zeros(5, 64).as_strided((1, 4, 2, 64), (0, 64, 64, 1)), 16


@pytest.mark.parametrize("case,takes", [
    ("aligned", True), ("odd halo", False), ("odd length", False),
    ("odd row stride", False), ("odd base", False), ("strided time", None),
    ("overlap", None)])
def test_k6_irregular_layouts_take_the_table(case, takes):
    """The row-block entry takes a tensor whose addresses and lengths are
    16-byte multiples; other layouts take the table entry (``takes``
    False); a time stride other than 1 and overlapping shards are refused
    (None)."""
    buf, halo = _layout(case)
    if takes is None:
        with pytest.raises(ValueError):
            phalo.row_blocks_of(buf, halo)
        return
    assert phalo.bulk_aligned(phalo.row_blocks_of(buf, halo)) is takes


@pytest.mark.parametrize("t,s,c", [(1, 8, 1), (2, 4, 3)])
def test_k6_tensor_form_matches_the_lists(t, s, c):
    """The plain version on a (T, S, rows, L) tensor fills the halos as the
    list form does, and launches nothing on the CPU."""
    halo, seg = 37, 100
    ext = _ext(t, s, c, halo, seg)
    want = ext.clone()
    phalo.halo_fill_plain(_views(want, t, s, c), halo)
    before = (phalo.halo_shift_right.launches,
              phalo.halo_shift_right.row_block_launches)
    phalo.halo_shift_right(ext.view(t, s, c, halo + seg), halo)
    assert torch.equal(ext, want)
    assert (phalo.halo_shift_right.launches,
            phalo.halo_shift_right.row_block_launches) == before


@pytest.mark.parametrize("bad", ["dtype", "ndim", "halo"])
def test_k6_tensor_form_refuses_bad_buffers(bad):
    buf = torch.zeros(1, 4, 2, 64)
    halo, err = 16, ValueError
    if bad == "dtype":
        buf, err = buf.double(), TypeError
    elif bad == "ndim":
        buf = buf[0]
    else:
        halo = 40
    with pytest.raises(err):
        phalo.halo_shift_right(buf, halo)


def test_current_stream_binding_is_declared():
    """``build.current_stream`` calls torch's private
    ``_cuda_getCurrentRawStream`` on the card.  CPU builds lack the
    function but ship torch's stubs, which declare it: a torch that
    renames it fails here, not only on the card."""
    stubs = pathlib.Path(torch.__file__).parent / "_C" / "__init__.pyi"
    assert "def _cuda_getCurrentRawStream(" in stubs.read_text()
    if torch.cuda.is_available():
        assert build._RAW_STREAM is not None
