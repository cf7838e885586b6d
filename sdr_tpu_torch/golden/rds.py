"""Golden RDS symbol/bit/frame chain (numpy).

The RDS (Radio Data System) back end decodes the 57 kHz BPSK sub-carrier:
RRC-filtered soft symbols -> clock/data recovery -> Manchester decode ->
differential decode -> frame synchronization against the RDS block code
(26-bit blocks = 16 info + 10 check bits, offset words A/B/C/C'/D).

Reference: model/fmSupportLib.py —
  CDR :103-201, manchestering :203-220, symbolToBit :222-230,
  diff_decoding :241-249, matrixMult (GF(2)) :14-27, framesync :30-100.

This layer is host-side by design (SURVEY.md section 7 step 5): the symbol
rate is 2375 S/s, ~micro-scale work, while everything at IF rate and above
runs on the TPU.  The GF(2) syndrome computation is nevertheless exposed as a
batched matrix product so the TPU path can compute all sliding-window
syndromes in one int32 matmul.

The port's own copy of ``sdr_tpu/golden/rds.py``, behaviour
unchanged, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# 26x10 parity-check matrix of the RDS shortened cyclic block code, laid out
# for s = window(26) @ H (mod 2) on the received bit window
# (model/fmSupportLib.py:32-57; the matrix itself is RDS-spec data).
PARITY_MATRIX = np.array([
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 1, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 1, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 0, 1, 1, 0, 1, 1, 1, 0, 0],
    [0, 1, 0, 1, 1, 0, 1, 1, 1, 0],
    [0, 0, 1, 0, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 0, 0, 0, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 1, 1, 1],
    [1, 1, 0, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1],
    [1, 1, 0, 1, 1, 1, 0, 1, 1, 0],
    [0, 1, 1, 0, 1, 1, 1, 0, 1, 1],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    [1, 1, 1, 1, 0, 1, 1, 1, 0, 0],
    [0, 1, 1, 1, 1, 0, 1, 1, 1, 0],
    [0, 0, 1, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 1, 0, 0, 0, 1, 1, 1, 1],
    [1, 1, 0, 0, 0, 1, 1, 0, 1, 1],
], dtype=np.int64)

# Offset-word syndromes (model/fmSupportLib.py:65-90).
SYNDROMES = {
    "A":      np.array([1, 1, 1, 1, 0, 1, 1, 0, 0, 0], dtype=np.int64),
    "B":      np.array([1, 1, 1, 1, 0, 1, 0, 1, 0, 0], dtype=np.int64),
    "C":      np.array([1, 0, 0, 1, 0, 1, 1, 1, 0, 0], dtype=np.int64),
    "C_apos": np.array([1, 1, 1, 1, 0, 0, 1, 1, 0, 0], dtype=np.int64),
    "D":      np.array([1, 0, 0, 1, 0, 1, 1, 0, 0, 0], dtype=np.int64),
}

# Canonical RDS block sequence within a group.
OFFSET_SEQUENCE = ("A", "B", "C", "D")

#: next expected offset word when synchronized (C' substitutes for C in
#: version-B groups; after either comes D)
NEXT_OFFSET = {"A": "B", "B": "C", "C": "D", "C_apos": "D", "D": "A"}


def gf2_syndrome(bits: np.ndarray) -> np.ndarray:
    """Syndromes of one or many 26-bit windows: (..., 26) @ (26, 10) mod 2.

    The reference computes this bit-by-bit (model/fmSupportLib.py:14-27);
    as a batched integer matmul it is one MXU op for every window at once.
    """
    bits = np.asarray(bits, dtype=np.int64)
    return (bits @ PARITY_MATRIX) % 2


def _build_correction_table(max_burst: int = 5) -> dict[int, np.ndarray]:
    """Syndrome -> error-pattern lookup for the RDS block code's design
    correction capability: any single error burst spanning <= ``max_burst``
    bits (the shortened cyclic code guarantees distinct syndromes for
    these — the property the spec's burst-trapping decoder relies on).
    Patterns are inserted shortest-burst-first; a duplicate syndrome from
    a longer pattern is dropped (corrections resolve to the most probable
    error).  26 + 25 + 48 + 92 + 176 = 367 of the 1023 nonzero syndromes
    become correctable."""
    tbl: dict[int, np.ndarray] = {}
    for length in range(1, max_burst + 1):
        n_inner = length - 2
        for start in range(0, 26 - length + 1):
            for inner in range(1 << max(n_inner, 0)):
                e = np.zeros(26, dtype=np.int64)
                e[start] = 1
                e[start + length - 1] = 1
                for b in range(n_inner):
                    if (inner >> b) & 1:
                        e[start + 1 + b] = 1
                key = int("".join(map(str, gf2_syndrome(e))), 2)
                tbl.setdefault(key, e)
    return tbl


_CORRECTION_TABLE = _build_correction_table()


def correct_block(window: np.ndarray, offset: str
                  ) -> tuple[np.ndarray, int] | None:
    """Try to correct one received 26-bit block against ``offset``.

    Returns ``(corrected_window, n_bits_flipped)`` — ``(window, 0)`` for a
    clean block — or ``None`` when the error is outside the code's
    burst-<=5 correction capability.  This is capability the reference
    never had: its framesync requires exact syndrome matches
    (model/fmSupportLib.py:30-100), dropping every block a real receiver's
    burst-trapping decoder would save.  Meaningful only in synchronized
    operation (the caller knows which offset to expect): applied to
    arbitrary windows it would 'correct' ~36% of random garbage into
    false blocks, which is why frame acquisition stays exact-match.
    """
    window = np.asarray(window, dtype=np.int64)
    d = gf2_syndrome(window) ^ SYNDROMES[offset]
    if not d.any():
        return window, 0
    e = _CORRECTION_TABLE.get(int("".join(map(str, d)), 2))
    if e is None:
        return None
    return window ^ e, int(e.sum())


def sliding_syndromes(bits: np.ndarray) -> np.ndarray:
    """Syndromes of every 26-bit sliding window of a bit vector:
    output shape (len(bits) - 25, 10)."""
    n = len(bits) - 25
    if n <= 0:
        return np.zeros((0, 10), dtype=np.int64)
    win = np.lib.stride_tricks.sliding_window_view(
        np.asarray(bits, dtype=np.int64), 26)
    return gf2_syndrome(win)


@dataclasses.dataclass
class FrameSyncResult:
    matches: list[tuple[int, str]]  # (start bit index, offset type)
    consumed: int                   # bits consumed from the stream
    last_offset: str                # last matched offset type ('' if none)


def frame_sync(bits: np.ndarray) -> FrameSyncResult:
    """Sliding 26-bit syndrome search (ref: model/fmSupportLib.py:30-100).

    Walks the stream one bit at a time; on a syndrome match the cursor jumps
    a whole block.  Divergence from the reference, documented: the reference
    returns only the *last* offset type and consumes ``n+26`` bits even when
    the scan slid past the last match (losing un-examined bits,
    model/fmSupportLib.py:94-98).  We return every match and consume only up
    to the end of the last matched block (or keep a 25-bit tail when nothing
    matched) so no data is dropped.
    """
    bits = np.asarray(bits)
    synd = sliding_syndromes(bits)
    keys = list(SYNDROMES.keys())
    table = np.stack([SYNDROMES[k] for k in keys])          # (5, 10)
    # match[n] = index into keys, or -1
    eq = (synd[:, None, :] == table[None, :, :]).all(-1)     # (N, 5)
    match = np.where(eq.any(1), eq.argmax(1), -1)

    matches: list[tuple[int, str]] = []
    n = 0
    consumed = 0
    while n < len(match):
        m = match[n]
        if m >= 0:
            matches.append((n, keys[m]))
            n += 26
            consumed = n
        else:
            n += 1
    if not matches:
        consumed = max(0, len(bits) - 25)
    return FrameSyncResult(matches, consumed,
                           matches[-1][1] if matches else "")


# ---------------------------------------------------------------------------
# Frame sync with burst error correction (round 5; exceeds the reference)
# ---------------------------------------------------------------------------

#: consecutive corrected blocks accepted before an exact match is required
#: again — bounds the correction table's ~36% (367/1023) false-accept rate
#: on random windows during an unnoticed sync loss
MAX_CORRECTION_STREAK = 2


@dataclasses.dataclass
class SyncScanState:
    """Carry of :func:`frame_sync_ec` across streamed bit chunks."""
    synced: bool = False
    expect: str = ""          # expected next offset while synchronized
    streak: int = 0           # consecutive corrected blocks


@dataclasses.dataclass
class FrameSyncEcResult:
    #: (start bit index, offset type, corrected 26-bit window, bits flipped)
    matches: list[tuple[int, str, np.ndarray, int]]
    consumed: int
    state: SyncScanState


def frame_sync_ec(bits: np.ndarray,
                  state: SyncScanState | None = None) -> FrameSyncEcResult:
    """:func:`frame_sync` plus burst error correction while synchronized.

    Acquisition is EXACT-match, identical to :func:`frame_sync` (applying
    correction to arbitrary windows would sync onto garbage — see
    :func:`correct_block`).  Once synchronized, a window that fails the
    exact match is tried against the burst-<=5 correction toward the
    EXPECTED offset in the A,B,C|C',D sequence — the blocks the
    reference's exact-match framesync (model/fmSupportLib.py:30-100)
    drops and a standards-compliant receiver saves.  At most
    ``MAX_CORRECTION_STREAK`` consecutive corrected blocks are accepted
    before an exact match is required again; a failed correction drops
    sync and resumes the bit-by-bit search.

    Streaming-safe: feeding chunks with the carried ``state`` emits the
    same accepts as one contiguous scan (a failed correction attempt is
    deterministic, so not re-attempting it on the re-scanned tail cannot
    change the outcome).
    """
    bits = np.asarray(bits, dtype=np.int64)
    st = dataclasses.replace(state) if state is not None else SyncScanState()
    synd = sliding_syndromes(bits)
    keys = list(SYNDROMES.keys())
    table = np.stack([SYNDROMES[k] for k in keys])
    eq = (synd[:, None, :] == table[None, :, :]).all(-1)
    match = np.where(eq.any(1), eq.argmax(1), -1)

    out: list[tuple[int, str, np.ndarray, int]] = []
    n = 0
    consumed = -1
    while n < len(match):
        m = match[n]
        if m >= 0:
            off = keys[m]
            out.append((n, off, bits[n:n + 26].copy(), 0))
            n += 26
            consumed = n
            st = SyncScanState(True, NEXT_OFFSET[off], 0)
            continue
        if st.synced and st.streak < MAX_CORRECTION_STREAK:
            cands = ((st.expect, "C_apos") if st.expect == "C"
                     else (st.expect,))
            # when both C and C' are candidates, keep the MINIMUM-weight
            # correction: a 1-bit-damaged C' block is also "correctable"
            # toward C through the burst pattern whose syndrome is
            # e ^ (S_C ^ S_C') — first-hit-wins silently rewrote such
            # blocks into bogus C frames with wrong info words
            hit = None
            for o in cands:
                r = correct_block(bits[n:n + 26], o)
                if r is not None and (hit is None or r[1] < hit[1][1]):
                    hit = (o, r)
            if hit is not None:
                o, (win, ne) = hit
                out.append((n, o, win, ne))
                n += 26
                consumed = n
                st = SyncScanState(True, NEXT_OFFSET[o], st.streak + 1)
                continue
        st = SyncScanState()
        n += 1
    if consumed < 0:
        consumed = max(0, len(bits) - 25)
    return FrameSyncEcResult(out, consumed, st)


# ---------------------------------------------------------------------------
# Symbol-level decode
# ---------------------------------------------------------------------------

def manchester_decode(samples: np.ndarray) -> np.ndarray:
    """Pairwise Manchester decode: (L,H)->0, (H,L)->1, degenerate pairs -> 0
    (ref: model/fmSupportLib.py:203-220; odd trailing sample dropped)."""
    n = len(samples) // 2
    a = samples[: 2 * n : 2]
    b = samples[1 : 2 * n : 2]
    return ((a > 0) & (b < 0)).astype(np.int64)


def diff_decode(bits: np.ndarray, prev_bit: int | None = None) -> np.ndarray:
    """Differential decode: out[i] = bits[i] XOR bits[i-1]; the first output
    is bits[0] itself when no previous bit is carried
    (ref: model/fmSupportLib.py:241-249)."""
    bits = np.asarray(bits, dtype=np.int64)
    if len(bits) == 0:
        return bits
    first = bits[0] if prev_bit is None else bits[0] ^ int(prev_bit)
    return np.concatenate([[first], bits[1:] ^ bits[:-1]])


def _symbol_to_bit(prev_sample: float) -> int:
    """Bit carried by a (prev, cur) symbol pair is the sign of the first
    sample (ref: model/fmSupportLib.py:222-230)."""
    return 1 if prev_sample > 0 else 0


@dataclasses.dataclass
class CdrState:
    """Inter-block CDR carry (ref: to_pass_on_state, model/fmSupportLib.py:104-106)."""

    pair_prev: float = 0.0   # last sampling point of the previous block
    start: int = 0           # sampling grid offset into the next block
    prev_size: int = 0       # number of sampling points taken last block


def cdr(x: np.ndarray, sps: int, state: CdrState,
        block_count: int) -> tuple[np.ndarray, CdrState]:
    """Clock/data recovery, faithful to the reference algorithm
    (model/fmSupportLib.py:103-201).

    Samples the RRC output every ``sps`` samples from ``state.start``;
    flips the third of three consecutive same-sign samples; repairs
    "irregular" same-sign Manchester pairs by inverting whichever sample is
    below ``limit`` in magnitude, and when neither is, restarts the whole
    sampling grid one ``sps`` later (emitting a cross-pair bit).  Returns the
    decoded Manchester bits for this block and the carried state.
    """
    limit = 0.3
    start = state.start
    entry_start = state.start
    pair_prev = state.pair_prev
    emitted: list[int] = []

    while True:
        # --- sampling pass ---------------------------------------------
        spa = np.zeros(len(x))
        size = 0
        i = start
        first_special_done = False
        while i < len(x):
            if (i == start and start == entry_start
                    and state.prev_size % 2 == 1 and not first_special_done):
                # pair the dangling last sample of the previous block
                emitted.append(_symbol_to_bit(pair_prev))
                pair_prev = x[i]
                start = start + sps
                first_special_done = True
                i += sps
                continue
            v = x[i]
            if i >= start + 2 * sps:
                a, b = spa[i - 2 * sps], spa[i - sps]
                if (a > 0 and b > 0 and v > 0) or (a < 0 and b < 0 and v < 0):
                    v = -v
            spa[i] = v
            size += 1
            i += sps

        samples = spa[start::sps][:size].copy()

        # --- irregular-pair repair -------------------------------------
        restart = False
        for j in range(0, len(samples) - 1, 2):
            a, b = samples[j], samples[j + 1]
            if (a < 0 and b < 0) or (a > 0 and b > 0):
                if abs(a) < limit:
                    samples[j] = -a
                elif abs(b) < limit:
                    samples[j + 1] = -b
                else:
                    start = start + sps
                    if block_count != 0:
                        emitted.append(_symbol_to_bit(pair_prev))
                        pair_prev = samples[0]
                    restart = True
                    break
        if not restart:
            break

    new_state = CdrState(
        pair_prev=float(samples[-1]) if len(samples) else pair_prev,
        start=sps - (len(x) - (((size - 1) * sps) + start)),
        prev_size=size,
    )
    bits = np.concatenate([
        np.asarray(emitted, dtype=np.int64),
        manchester_decode(samples),
    ])
    return bits, new_state


@dataclasses.dataclass
class TrackState:
    """Carry of the drift-tracking CDR: a second-order timing loop.

    ``pos`` is the next sampling position relative to the start of the
    next window (fractional); ``step`` is the current samples-per-symbol
    estimate (init: nominal sps, tracks the transmit clock in ppm);
    ``carry_sym`` holds an unpaired first-of-Manchester-pair sample across
    the window boundary so the pairing parity NEVER re-derives (the
    round-3 per-window parity vote slipped at boundaries under drift,
    direction-asymmetrically — VERDICT r3 #6).  ``locked`` is False until
    the first window establishes phase and parity."""

    pos: float = 0.0
    step: float = 0.0
    carry_sym: float | None = None
    locked: bool = False


# timing-loop gains: err is the measured window-center phase offset in
# samples; pos absorbs G_POS of it immediately, step absorbs G_STEP spread
# over the window's symbols (a damped 2nd-order loop; lock in ~3 windows
# at 400 ppm, stable to the +-0.5-sample measurement noise floor)
_G_POS = 0.7
_G_STEP = 0.3


def _frac_peak(energies: np.ndarray) -> float:
    """Circular argmax with parabolic interpolation -> fractional phase."""
    p0 = int(np.argmax(energies))
    n = len(energies)
    y1, y2, y3 = energies[(p0 - 1) % n], energies[p0], energies[(p0 + 1) % n]
    denom = y1 - 2.0 * y2 + y3
    delta = 0.5 * (y1 - y3) / denom if denom < 0 else 0.0
    return p0 + float(np.clip(delta, -0.5, 0.5))


def cdr_tracking(x: np.ndarray, sps: int,
                 window_symbols: int = 256) -> np.ndarray:
    """Clock-drift-tracking CDR: a windowed second-order timing loop.

    Real transmit oscillators drift against the receiver grid (tens of ppm
    accumulate to whole samples over seconds); a single global sampling
    phase then walks off the symbol peaks.  This decoder measures the
    fractional symbol phase per ``window_symbols`` window (energy peak
    over the sps grid, parabolically interpolated) and closes a
    proportional + clock-rate loop on it, then samples at the CONTINUOUS
    positions ``pos + j*step`` — so the sample stream never slips a symbol
    at a window boundary and the Manchester pairing parity is established
    once and carried, not re-voted (re-voting was direction-asymmetric
    under drift, VERDICT r3 #6).
    """
    x = np.asarray(x)
    w = window_symbols * sps
    out: list[np.ndarray] = []
    st = TrackState()
    for w0 in range(0, len(x), w):
        win = x[w0:w0 + w]
        if len(win) < 4 * sps:
            break
        manch, st = cdr_tracking_window(win, sps, st)
        out.append(manch)
    return (np.concatenate(out) if out else np.zeros(0, np.int64))


def cdr_tracking_window(win: np.ndarray, sps: int,
                        state: TrackState | None
                        ) -> tuple[np.ndarray, TrackState]:
    """One window of the tracking CDR (shared by the offline
    :func:`cdr_tracking` and the streaming decoder so the two emit
    identical bits on identical windows).  Returns (bits, new_state)."""
    st = state if state is not None else TrackState()
    win = np.asarray(win)
    energies = np.array([np.abs(win[p::sps]).mean() for p in range(sps)])
    phi = _frac_peak(energies)

    if not st.locked:
        pos, step = phi, float(sps)
        # establish the Manchester pairing parity once, by sign alternation
        # — on the SAME rounded grid the sampler below uses (no % sps wrap:
        # _frac_peak can push phi to sps-0.5, which would wrap the vote one
        # symbol early and invert the pairing for the whole stream,
        # ADVICE r4)
        s0 = win[int(round(pos))::sps]
        n2 = (len(s0) - 1) // 2
        alt0 = np.mean(np.sign(s0[0:2 * n2:2]) != np.sign(s0[1:2 * n2:2]))
        alt1 = np.mean(np.sign(s0[1:1 + 2 * n2:2])
                       != np.sign(s0[2:2 + 2 * n2:2]))
        parity = 0 if alt0 >= alt1 else 1
        pos += parity * step          # pairing starts at the chosen symbol
        carry: float | None = None
    else:
        pos, step, carry = st.pos, st.step, st.carry_sym
        # phase error measured against the loop's prediction at window
        # CENTER (the energy grid averages the whole window, and under
        # drift the true phase slides (J/2)*(step-sps) by mid-window)
        n_sym = len(win) / step
        pred_mid = (pos + (n_sym / 2.0) * (step - sps)) % sps
        err = (phi - pred_mid + sps / 2.0) % sps - sps / 2.0
        # pos stays the estimate of the SAME next symbol (a correction is
        # never a symbol skip): cap it against noisy phase measurements,
        # and when it lands just before the window start, clamp — index 0
        # samples that symbol off-peak; wrapping would skip it and flip
        # the Manchester pairing for the rest of the stream
        pos += float(np.clip(_G_POS * err, -3.0, 3.0))
        pos = max(pos, -0.499)
        step += _G_STEP * err / max(n_sym, 1.0)
        step = float(np.clip(step, sps * 0.995, sps * 1.005))

    # continuous sampling: every position pos + j*step that rounds inside
    # this window, then carry the overhang to the next window
    j_max = int(np.floor((len(win) - 0.5 - pos) / step))
    idx = np.round(pos + np.arange(j_max + 1) * step).astype(np.int64)
    # CLAMP rather than filter: round-half-to-even can land exactly on
    # len(win) (pos + j*step == len-0.5); dropping that sample would
    # desynchronize the (j_max+1)-based new_pos accounting from the
    # emitted count and flip the Manchester pairing downstream (ADVICE
    # r4).  pos >= -0.499 guarantees idx >= 0 already.
    idx = np.clip(idx, 0, len(win) - 1)
    samples = win[idx] if len(idx) else np.zeros(0, win.dtype)
    new_pos = (pos + (j_max + 1) * step) - len(win)

    if carry is not None:
        # prepend unconditionally: a zero-sample window (short flush with
        # large pos) must pass the pending half-pair through, not drop it
        # (ADVICE r4)
        samples = np.concatenate([[carry], samples])
    n2 = len(samples) // 2
    a, b = samples[0:2 * n2:2], samples[1:2 * n2:2]
    bits = ((a > 0) & (b < 0)).astype(np.int64)
    new_carry = float(samples[-1]) if len(samples) % 2 else None
    return bits, TrackState(pos=float(new_pos), step=float(step),
                            carry_sym=new_carry, locked=True)


def cdr_robust(x: np.ndarray, sps: int, phase: int | None = None,
               parity: int | None = None) -> tuple[np.ndarray, int, int]:
    """Vectorized, restart-free CDR used by the production TPU path.

    Picks the sampling phase maximizing mean |soft symbol| (the RRC output
    peaks at symbol centers), then picks the Manchester pairing parity that
    maximizes sign alternation within pairs.  Returns (bits, phase, parity).
    Unlike the reference algorithm this has no data-dependent restart loop,
    so the symbol sampling itself can run on-device.
    """
    x = np.asarray(x)
    if phase is None:
        energies = [np.abs(x[p::sps]).mean() for p in range(sps)]
        phase = int(np.argmax(energies))
    s = x[phase::sps]
    if parity is None:
        n2 = (len(s) - 1) // 2
        alt0 = np.mean(np.sign(s[0:2 * n2:2]) != np.sign(s[1:2 * n2:2]))
        alt1 = np.mean(np.sign(s[1:1 + 2 * n2:2]) != np.sign(s[2:2 + 2 * n2:2]))
        parity = 0 if alt0 >= alt1 else 1
    s = s[parity:]
    return manchester_decode(s), phase, parity
