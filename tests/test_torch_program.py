"""The port's block programs (``sdr_tpu_torch.models.program``) on the CPU.

On the card a block program captures a CUDA graph per shape; on the CPU the
same bookkeeping runs with the capture replaced by a direct call, and that
is what these tests hold: the program's outputs and state are
``process_block``'s bit for bit over chained blocks, a returned tensor
survives the next call, a foreign state (a fresh ``init_state``, a loaded
checkpoint) is copied in and left as it was, the program's own state is
donated, a new shape makes a new key, other or changed coefficients are
copied in, and a failed capture raises.  ``Receiver.run`` against
``run_blocks`` (bit for bit) and the JAX package's ``run_blocks_scan`` at
the receiver tolerances (FM_ATOL on fm_demod/mono, PLL_ARM_ATOL on the
PLL-driven arms: XLA contracts the PLL's multiply-adds into FMAs on the
CPU).  The constants a block used to upload from the host are made once
and are bit-equal to the per-call values they replace; the time-sharded
warm-up still resets shard 0 to the exact fresh state.

Mode 0 with 19,200-byte blocks (960 IF samples, one RDS period) unless a
case says otherwise; one thread, as tier-1 runs several workers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (FM_ATOL, MC, PLL_ARM_ATOL, PMC, SHORT,
                          assert_close, np_of)

from sdr_tpu.models import receiver as jrx
from sdr_tpu_torch import checkpoint as pckpt
from sdr_tpu_torch import config as pcfg
from sdr_tpu_torch.models import channelizer as pchan
from sdr_tpu_torch.models import program as pprog
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.ops import pll as tpll
from sdr_tpu_torch.ops import pll_cuda
from sdr_tpu_torch.parallel import time_shard as pts
from sdr_tpu_torch.parallel.mesh import Mesh
from sdr_tpu_torch.utils import synth

torch.set_num_threads(1)

BLOCKS = 4


@pytest.fixture(scope="module")
def station():
    return synth.synthesize_fm(duration_s=0.12, mode=0, with_stereo=True,
                               with_rds=True, seed=23).iq_u8


def _blocks(iq: np.ndarray, n: int, size: int = SHORT) -> list:
    return [torch.from_numpy(np.ascontiguousarray(iq[..., b * size:
                                                     (b + 1) * size]))
            for b in range(n)]


def _assert_equal_trees(a, b) -> None:
    for x, y in zip(pprog.tree_leaves(a), pprog.tree_leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


# (mode, block bytes, stereo, with_rds, rds_debug_q, float input)
CASES = {
    "stereo+rds u8": (0, SHORT, True, True, False, False),
    "stereo+rds float": (0, SHORT, True, True, False, True),
    "stereo no rds": (0, SHORT, True, False, False, False),
    "rds_debug_q": (0, SHORT, True, True, True, False),
    "mode 2 stereo": (2, 16_000, True, False, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_program_equals_process_block(station, case):
    """Outputs and state bit-equal to the eager block over chained
    blocks, the state carried on each side."""
    mode, size, stereo, rds, debug_q, as_float = CASES[case]
    mc = pcfg.get_mode_config(mode)
    iq = station if mode == 0 else synth.synthesize_fm(
        duration_s=0.05, mode=mode, with_stereo=True, seed=5).iq_u8
    n = 2 if mode == 2 else BLOCKS
    blocks = _blocks(iq, n, size)
    if as_float:
        blocks = [synth.u8_to_float(b.numpy()) for b in blocks]
        blocks = [torch.from_numpy(b) for b in blocks]
    coeffs = prx.design_coeffs(mc)
    fn = prx.make_block_fn(mc, stereo, rds, rds_debug_q=debug_q)
    s_eager = s_prog = prx.init_state(mc)
    for blk in blocks:
        o_eager, s_eager = prx.process_block(blk, coeffs, s_eager, mc, stereo,
                                             rds, rds_debug_q=debug_q)
        o_prog, s_prog = fn(blk, coeffs, s_prog)
        _assert_equal_trees(o_prog, o_eager)
        _assert_equal_trees(s_prog, s_eager)
    assert len(fn.keys()) == 1


def test_returned_outputs_survive_the_next_call(station):
    coeffs, state = prx.design_coeffs(PMC), prx.init_state(PMC)
    fn = prx.make_block_fn(PMC, True, True)
    b0, b1 = _blocks(station, 2)
    out0, state = fn(b0, coeffs, state)
    kept = pprog.tree_map(torch.clone, out0)
    out1, state = fn(b1, coeffs, state)
    _assert_equal_trees(out0, kept)
    assert not torch.equal(out0.mono, out1.mono)


@pytest.mark.parametrize("source", ["init_state", "checkpoint"])
def test_foreign_state_is_copied_in(station, tmp_path, source):
    """A state that is not the program's buffers is copied into them and
    left as it was: a fresh ``init_state``, or a checkpoint saved after two
    blocks and loaded on the CPU, which resumes bit-identically."""
    coeffs = prx.design_coeffs(PMC)
    blocks = _blocks(station, 3)
    ref = prx.make_block_fn(PMC, True, True)
    st = prx.init_state(PMC)
    want = []
    for blk in blocks:
        out, st = ref(blk, coeffs, st)
        want.append(out)
    if source == "init_state":
        foreign, start = prx.init_state(PMC), 0
    else:
        st = prx.init_state(PMC)
        for blk in blocks[:2]:
            _, st = ref(blk, coeffs, st)
        path = pckpt.save(str(tmp_path / "ck"), st, 0, block_count=2,
                          input_dtype="uint8")
        foreign, _ = pckpt.load(path, expect_input_dtype="uint8",
                                device="cpu")
        start = 2
    kept = pprog.tree_map(torch.clone, foreign)
    fn = prx.make_block_fn(PMC, True, True)
    out, own = fn(blocks[start], coeffs, foreign)
    _assert_equal_trees(out, want[start])
    _assert_equal_trees(foreign, kept)
    assert not any(a is b for a, b in zip(pprog.tree_leaves(own),
                                           pprog.tree_leaves(foreign)))


def test_own_state_is_donated(station):
    """The state a call returns is the program's buffers: the next call
    returns the same tensors, overwritten in place."""
    coeffs = prx.design_coeffs(PMC)
    b0, b1 = _blocks(station, 2)
    fn = prx.make_block_fn(PMC, True, True)
    _, st0 = fn(b0, coeffs, prx.init_state(PMC))
    after0 = pprog.tree_map(torch.clone, st0)
    _, st1 = fn(b1, coeffs, st0)
    assert all(a is b for a, b in zip(pprog.tree_leaves(st0),
                                      pprog.tree_leaves(st1)))
    _, want = prx.process_block(b1, coeffs, after0, PMC, True, True)
    _assert_equal_trees(st0, want)


def test_new_shape_makes_a_new_key(station):
    """A tail block of another length, or another batch, captures its own
    graph (here: its own entry); a shape seen before reuses its entry, and
    the tail block equals the eager block."""
    coeffs = prx.design_coeffs(PMC)
    fn = prx.make_block_fn(PMC, True, True)
    full = torch.from_numpy(station[:2 * SHORT].copy())
    tail = torch.from_numpy(station[2 * SHORT:3 * SHORT].copy())
    _, st = fn(full, coeffs, prx.init_state(PMC))
    after = pprog.tree_map(torch.clone, st)
    out, st = fn(tail, coeffs, st)
    assert len(fn.keys()) == 2
    want, _ = prx.process_block(tail, coeffs, after, PMC, True, True)
    _assert_equal_trees(out, want)
    fn(full, coeffs, st)
    assert len(fn.keys()) == 2
    fn(torch.stack([full, full]), coeffs, prx.init_state(PMC, (2,)))
    assert len(fn.keys()) == 3


@pytest.mark.parametrize("how", ["in place", "other tensors"])
def test_changed_coefficients_are_copied_in(station, how):
    """A graph never reads stale coefficients: taps changed in place, or
    other coefficient tensors, reach the next block."""
    b0, b1 = _blocks(station, 2)
    coeffs = prx.design_coeffs(PMC)
    fn = prx.make_block_fn(PMC, True, True)
    _, st = fn(b0, coeffs, prx.init_state(PMC))
    after = pprog.tree_map(torch.clone, st)
    if how == "in place":
        coeffs.audio.mul_(0.5)
        new = coeffs
    else:
        new = coeffs._replace(audio=coeffs.audio * 0.5)
    out, _ = fn(b1, new, st)
    want, _ = prx.process_block(b1, new, after, PMC, True, True)
    _assert_equal_trees(out, want)


def test_failed_capture_raises_and_runs_nothing(station, monkeypatch):
    """A capture that fails raises; the step is not run eagerly instead,
    and the key is not kept."""
    calls = []
    fn = pprog.Program(lambda x, p, s: calls.append(1))

    def refuse(self, entry, params, state):
        raise RuntimeError("capture refused")
    monkeypatch.setattr(pprog.Program, "_capture", refuse)
    with pytest.raises(RuntimeError, match="capture refused"):
        fn(_blocks(station, 1)[0], prx.design_coeffs(PMC),
           prx.init_state(PMC))
    assert not calls and not fn.keys()


def test_copy_leaves_reads_before_it_writes():
    """Sources that alias destinations (here swapped) are cloned first."""
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    pprog.copy_leaves([a, b], [b, a])
    assert torch.equal(a, torch.arange(4.0) + 10)
    assert torch.equal(b, torch.arange(4.0))


def test_tree_helpers_round_trip():
    st = prx.init_state(PMC, (2,))
    leaves = pprog.tree_leaves(st)
    assert len(leaves) == 17 - 2 + 2 * 7
    back = pprog.tree_build(st, leaves)
    assert type(back) is prx.ReceiverState
    assert type(back.pilot_pll) is tpll.PllState
    assert all(x is y for x, y in zip(pprog.tree_leaves(back), leaves))


def test_receiver_run_equals_run_blocks_and_jax_scan(station):
    """``Receiver.run`` (one program, replayed per block) against
    ``run_blocks`` (bit for bit) and against ``run_blocks_scan`` (3 blocks
    x 2 channels; the receiver tolerances)."""
    iq2 = np.stack([station[:3 * SHORT], station[SHORT:4 * SHORT]])
    blocks = np.ascontiguousarray(np.moveaxis(iq2.reshape(2, 3, SHORT), 1, 0))
    r = prx.Receiver(0, stereo=True, with_rds=True, batch_shape=(2,),
                     device="cpu")
    ro = r.run(iq2, block_size=SHORT)
    po, ps = prx.run_blocks(torch.from_numpy(blocks), prx.design_coeffs(PMC),
                            prx.init_state(PMC, (2,)), PMC, True, True)
    _assert_equal_trees(ro, po)
    _assert_equal_trees(r.state, ps)
    jo, js = jrx.run_blocks_scan(jnp.asarray(blocks), jrx.design_coeffs(MC),
                                 jrx.init_state(MC, (2,)), 0, True, True)
    for arm in ("fm_demod", "mono", "left", "right", "rds_symbols"):
        tol = FM_ATOL if arm in ("fm_demod", "mono") else PLL_ARM_ATOL
        assert_close(getattr(ro, arm), getattr(jo, arm), tol, arm)
    np.testing.assert_array_equal(np_of(r.state.rf_i), np.asarray(js.rf_i))


def test_pll_constants_are_made_once_and_bit_equal(station):
    """The loop constants, the lane constants and the kernels' constant
    rows: bit-equal to the per-call values they replace (each computed in
    float64 on the host and rounded once), made once over several blocks."""
    pars = (prx.pilot_pll_params(PMC), prx.rds_pll_params(PMC))
    vec = lambda vals: torch.tensor(vals, dtype=torch.float32)
    want = {"kp": vec([p.norm_bandwidth * 2.666 for p in pars]),
            "ki": vec([p.norm_bandwidth ** 2 * 3.555 for p in pars]),
            "w": vec([2.0 * np.pi * p.freq / p.fs for p in pars]),
            "m": vec([p.wrap_modulus for p in pars]),
            "scale": vec([p.nco_scale for p in pars]),
            "adj": vec([p.phase_adjust for p in pars])}
    got = tpll.loop_constants(list(pars), torch.float32, "cpu")
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    for mixer, rows in ((False, 4), (True, 6)):
        c = pll_cuda.kernel_constants(pars, 3, mixer, torch.device("cpu"))
        old = torch.cat([torch.stack([want[k].repeat(3) for k in
                                      list(want)[:rows]]),
                         torch.from_numpy(pll_cuda.turn_breakpoints())[
                             :, None].expand(4, 6)])
        assert torch.equal(c, old)
    fn = prx.make_block_fn(PMC, True, True)
    coeffs, st = prx.design_coeffs(PMC), prx.init_state(PMC)
    blocks = _blocks(station, 3)
    fn(blocks[0], coeffs, st)
    made = (tpll._loop_constants.cache_info().misses,
            pll_cuda.kernel_constants.cache_info().misses,
            pll_cuda.breakpoints_on.cache_info().misses)
    for blk in blocks[1:]:
        _, st = fn(blk, coeffs, st)
    assert (tpll._loop_constants.cache_info().misses,
            pll_cuda.kernel_constants.cache_info().misses,
            pll_cuda.breakpoints_on.cache_info().misses) == made


def test_channelizer_constants_are_made_once_and_bit_equal(monkeypatch):
    """``w_k``, ``w_b`` once per channelizer, the phase step once per block
    length, each bit-equal to the per-call value it replaces; and the
    channelizer's program bit-equal to its eager block over 3 blocks."""
    offsets, fs = (-1.5e6, 2.0e6), 9.6e6
    made = []
    real = pchan.phase_step
    monkeypatch.setattr(pchan, "phase_step",
                        lambda *a: made.append(a[2]) or real(*a))
    ch = pchan.Channelizer(offsets, fs, 0, device="cpu")
    w64 = 2.0 * np.pi * np.asarray(offsets, np.float64) / fs
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    assert torch.equal(ch.mixer[0], f32((w64 * 1024) % (2 * np.pi))[:, None,
                                                                     None])
    assert torch.equal(ch.mixer[1], f32(w64 % (2 * np.pi))[:, None, None])
    rng = np.random.default_rng(3)
    n = 4 * 1200
    st = ch.state
    for _ in range(3):
        blk = torch.from_numpy(rng.integers(0, 256, 2 * n, dtype=np.uint8))
        out = ch.process(blk)
        step = ch.phase_step(n)
        assert torch.equal(step, f32((w64 * n) % (2 * np.pi)))
        want, st = pchan._channelize_block(blk, ch.coeffs, st, *ch.mixer,
                                           step, ch.decim)
        assert torch.equal(out, want)
        _assert_equal_trees(ch.state, st)
    assert made == [n]


def test_time_sharded_warm_up_resets_shard0_exactly(station):
    """After the warm-up (two halo blocks, donated into the programs'
    buffers) shard 0's rows equal ``init_state``'s exactly and the other
    shards carry their warmed state, also when the warm-up starts from the
    programs' own buffers (a second warm-up), which it overwrites: the
    fresh state must not be kept from before it."""
    s, block_if = 4, 960
    block_raw = block_if * 2 * MC.rf_decim
    iq = synth.u8_to_float(station)[: s * 3 * block_raw]
    mesh = Mesh(["cpu"] * s, ("time",))
    mc, with_rds, sh, segs = pts._prepare(iq, mesh, 0, True, True,
                                          2 * block_if, "time", None,
                                          block_if)
    runner = pts._Runner(sh, mc, True, with_rds)
    grp = sh.groups[0]
    halos = [torch.from_numpy(sh.halos(grp.cells, segs))]
    fresh = prx.init_state(mc, (s,))
    for _ in range(2):
        runner.warm_up(halos)
        for got, want in zip(pprog.tree_leaves(runner.states[0]),
                             pprog.tree_leaves(fresh)):
            assert torch.equal(got[0], want[0])
        assert not torch.equal(runner.states[0].rf_i[1], fresh.rf_i[1])
        # the next warm-up starts from the programs' own buffers
        _, own = runner.fns[0](halos[0][:, :block_raw], runner.coeffs[0],
                               runner.states[0])
        runner.states = [own]


# --- the scan form: K chained blocks as one program (a chunk graph) --------


def _stack(outs):
    return prx.map_state(lambda *a: torch.stack(a), *outs)


@pytest.mark.parametrize("case", list(CASES))
def test_scan_equals_chained_calls(station, case):
    """``Program.scan`` over K=3 blocks against three calls of the
    per-block program on the same blocks: stacked outputs and the final
    state bit-equal, and the state is the same buffers a call returns."""
    mode, size, stereo, rds, debug_q, as_float = CASES[case]
    mc = pcfg.get_mode_config(mode)
    iq = station if mode == 0 else synth.synthesize_fm(
        duration_s=0.05, mode=mode, with_stereo=True, seed=5).iq_u8
    blocks = torch.stack(_blocks(iq, 3, size))
    if as_float:
        blocks = torch.from_numpy(synth.u8_to_float(blocks.numpy()))
    coeffs = prx.design_coeffs(mc)
    one = prx.make_block_fn(mc, stereo, rds, rds_debug_q=debug_q)
    st = prx.init_state(mc)
    outs = []
    for blk in blocks:
        out, st = one(blk, coeffs, st)
        outs.append(out)
    fn = prx.make_block_fn(mc, stereo, rds, rds_debug_q=debug_q)
    got, own = fn.scan(blocks, coeffs, prx.init_state(mc))
    _assert_equal_trees(got, _stack(outs))
    _assert_equal_trees(own, st)
    _, again = fn(blocks[0], coeffs, own)
    assert all(a is b for a, b in zip(pprog.tree_leaves(own),
                                      pprog.tree_leaves(again)))


def test_scan_and_calls_interleave(station):
    """call, scan, call, scan on one stream of blocks, from one program,
    against the blocks one by one; the scan's outputs survive the next
    scan."""
    coeffs = prx.design_coeffs(PMC)
    blocks = torch.stack(_blocks(station, 8))
    ref = prx.make_block_fn(PMC, True, True)
    st = prx.init_state(PMC)
    want = []
    for blk in blocks:
        out, st = ref(blk, coeffs, st)
        want.append(out)
    fn = prx.make_block_fn(PMC, True, True)
    got, s = [], prx.init_state(PMC)
    for lo, hi in ((0, 1), (1, 4), (4, 5), (5, 8)):
        if hi - lo == 1:
            out, s = fn(blocks[lo], coeffs, s)
            out = prx.map_state(lambda a: a[None], out)
        else:
            out, s = fn.scan(blocks[lo:hi], coeffs, s)
        got.append(out)
    _assert_equal_trees(prx.map_state(lambda *a: torch.cat(a), *got),
                        _stack(want))
    _assert_equal_trees(s, st)
    assert len(fn.keys()) == 2


@pytest.mark.parametrize("source", ["init_state", "checkpoint"])
def test_scan_copies_a_foreign_state_in(station, tmp_path, source):
    """A scan from a state that is not the program's buffers (a fresh one,
    a checkpoint saved after two blocks) copies it in, leaves it as it
    was, and resumes bit-identically."""
    coeffs = prx.design_coeffs(PMC)
    blocks = torch.stack(_blocks(station, 5))
    ref = prx.make_block_fn(PMC, True, True)
    st, want = prx.init_state(PMC), []
    for blk in blocks:
        out, st = ref(blk, coeffs, st)
        want.append(out)
    if source == "init_state":
        foreign, start = prx.init_state(PMC), 0
    else:
        st = prx.init_state(PMC)
        for blk in blocks[:2]:
            _, st = ref(blk, coeffs, st)
        path = pckpt.save(str(tmp_path / "ck"), st, 0, block_count=2,
                          input_dtype="uint8")
        foreign, _ = pckpt.load(path, expect_input_dtype="uint8",
                                device="cpu")
        start = 2
    kept = pprog.tree_map(torch.clone, foreign)
    fn = prx.make_block_fn(PMC, True, True)
    got, _ = fn.scan(blocks[start:start + 3], coeffs, foreign)
    _assert_equal_trees(got, _stack(want[start:start + 3]))
    _assert_equal_trees(foreign, kept)


def test_scan_keys_count_and_outputs(station):
    """A scan's key holds K: K=2 and K=3 are two entries, and a call on a
    (3, block) channel batch is a third, not the K=3 scan.  A scan counts
    one replay and K blocks; its returned outputs are copies that survive
    the next scan."""
    coeffs = prx.design_coeffs(PMC)
    blocks = torch.stack(_blocks(station, 5))
    fn = prx.make_block_fn(PMC, True, True)
    pprog.reset_counts()
    out3, st = fn.scan(blocks[:3], coeffs, prx.init_state(PMC))
    assert pprog.counts == {"warm_ups": 0, "captures": 0, "replays": 1,
                            "blocks": 3}
    kept = pprog.tree_map(torch.clone, out3)
    fn.scan(blocks[3:5], coeffs, st)
    fn.scan(blocks[:3], coeffs, prx.init_state(PMC))
    _assert_equal_trees(out3, kept)
    assert pprog.counts["replays"] == 3 and pprog.counts["blocks"] == 8
    fn(blocks[:3], coeffs, prx.init_state(PMC, (3,)))
    assert len(fn.keys()) == 3
    assert out3.mono.shape[0] == 3 and out3.mono.shape[1:] == kept.mono[0].shape


def test_scan_pads_the_block_stride_to_16_bytes():
    """A block whose byte length is not a multiple of 16 (mode 1's default
    u8 block, 50,040 bytes) sits in the scan's static input 50,048 bytes
    apart, every block's view contiguous and 16-byte aligned; its scan
    equals the blocks one by one."""
    mc = pcfg.get_mode_config(1)
    bs = mc.default_block_size(False)
    assert bs % 16 and pprog.block_stride((bs,), torch.uint8) == bs + 8
    assert pprog.block_stride((2, bs), torch.uint8) == 2 * bs
    assert pprog.block_stride((7,), torch.float32) == 8
    blocks = torch.from_numpy(synth.synthesize_fm(
        duration_s=0.06, mode=1, with_stereo=True, seed=6).iq_u8[:3 * bs]
        .reshape(3, bs).copy())
    coeffs = prx.design_coeffs(mc)
    ref = prx.make_block_fn(mc, True, False)
    st, want = prx.init_state(mc), []
    for blk in blocks:
        out, st = ref(blk, coeffs, st)
        want.append(out)
    fn = prx.make_block_fn(mc, True, False)
    got, own = fn.scan(blocks, coeffs, prx.init_state(mc))
    _assert_equal_trees(got, _stack(want))
    _assert_equal_trees(own, st)
    (entry,) = fn._entries.values()
    assert entry.x.stride() == (bs + 8, 1)
    assert all(entry.x[k].is_contiguous()
               and entry.x[k].data_ptr() % 16 == 0 for k in range(3))


def test_scan_counts_k_blocks_of_launches(station):
    """The step's launches as a replay sees them: K per scan of K blocks
    (on the CPU a scan is K direct calls; on the card the capture records
    K blocks' launches, which each replay adds, tests/test_torch_cuda.py)."""
    counter = pprog.COUNTED[0]
    before = counter.launches

    def step(x, params, state):
        counter.launches += 1
        return x * 2, state + x.sum()
    fn = pprog.Program(step)
    xs = torch.arange(12.0).reshape(4, 3)
    out, st = fn.scan(xs, torch.ones(1), torch.zeros(()))
    assert counter.launches == before + 4
    assert torch.equal(out, xs * 2) and float(st) == float(xs.sum())
    counter.launches = before


def test_failed_scan_capture_raises_and_runs_nothing(station, monkeypatch):
    """A chunk graph whose capture fails raises: no block runs eagerly in
    its place, and the key is not kept."""
    calls = []
    fn = pprog.Program(lambda x, p, s: calls.append(1))

    def refuse(self, entry, params, state):
        raise RuntimeError("capture refused")
    monkeypatch.setattr(pprog.Program, "_capture", refuse)
    with pytest.raises(RuntimeError, match="capture refused"):
        fn.scan(torch.stack(_blocks(station, 3)), prx.design_coeffs(PMC),
                prx.init_state(PMC))
    assert not calls and not fn.keys()
