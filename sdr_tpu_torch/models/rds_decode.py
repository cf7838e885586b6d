"""Host-side RDS symbol -> bit -> frame decode (numpy).

Port of ``sdr_tpu/models/rds_decode.py`` (whose package imports JAX):
``decode_robust`` for a whole symbol stream, ``StreamingRdsDecoder`` for
the CLI's per-block decode with carried state, and ``decode_reference``.
The chain runs at 2375 symbols/s and is control-flow heavy, so it stays on
the host; it calls the shared numpy oracle ``sdr_tpu.golden.rds`` and the
port's copy of ``rds_groups``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sdr_tpu.golden import rds as grds
from sdr_tpu_torch.models import rds_groups


@dataclasses.dataclass
class RdsDecodeResult:
    bits: np.ndarray                      # post-differential-decode bits
    frames: grds.FrameSyncResult
    info_words: np.ndarray                # (n_frames, 16) info bits per match
    n_corrected: int = 0                  # frames saved by burst correction


def _info_words(bits: np.ndarray,
                frames: grds.FrameSyncResult) -> np.ndarray:
    return np.array([bits[pos:pos + 16] for pos, _ in frames.matches],
                    dtype=np.int64).reshape(-1, 16)


def decode_robust(symbols: np.ndarray, sps: int,
                  window_symbols: int | None = None,
                  error_correction: bool = False) -> RdsDecodeResult:
    """Decode a whole soft-symbol stream (concatenated RRC outputs).

    ``symbols`` may be (n_blocks, sym_len) stacked output or a flat stream;
    blocks are concatenated in time order.  ``window_symbols`` enables the
    clock-drift-tracking CDR; ``error_correction`` applies the burst-<=5
    block correction while frame-synchronized, and info words then come
    from the corrected windows."""
    x = np.asarray(symbols).reshape(-1)
    if window_symbols:
        manch = grds.cdr_tracking(x, sps, window_symbols)
    else:
        manch, _, _ = grds.cdr_robust(x, sps)
    bits = grds.diff_decode(manch)
    if error_correction:
        ec = grds.frame_sync_ec(bits)
        matches = [(p, o) for p, o, _, _ in ec.matches]
        frames = grds.FrameSyncResult(
            matches, ec.consumed, matches[-1][1] if matches else "")
        info = (np.stack([w[:16] for _, _, w, _ in ec.matches])
                if ec.matches else np.zeros((0, 16), np.int64))
        return RdsDecodeResult(bits, frames, info,
                               sum(1 for _, _, _, ne in ec.matches if ne))
    frames = grds.frame_sync(bits)
    return RdsDecodeResult(bits, frames, _info_words(bits, frames))


class StreamingRdsDecoder:
    """Per-block host-side RDS decode with carried state (the production
    streaming path; ref block loop model/fmRDS.py:256-278).

    Feed each block's RRC soft symbols with ``feed``; host memory stays
    O(block): only the undecoded bit backlog (< 26 bits past the last
    matched frame plus one block's worth), at most 3 pending frame matches
    awaiting group assembly, and the O(1) ``StationDecoder`` accumulator
    are carried — never the whole symbol/bit stream.

    Two symbol-clock recoveries (module docstring):

    * ``algo="reference"`` — golden.rds.cdr with carried CdrState, per-block
      differential decode exactly like ``decode_reference`` (and the
      upstream model): the emitted frame stream is identical to running
      ``decode_reference`` over the stacked blocks.
    * ``algo="robust"`` (default) — the restart-free phase/parity CDR:
      phase and Manchester parity are estimated ONCE over the first
      ``min_est_symbols`` symbols (buffered across blocks — a first-block
      estimate off ~50 symbols was measurably noisier, ADVICE r2), then
      sampling, pairing, and differential decode continue seamlessly
      across block boundaries, bit-identical to ``decode_robust`` on the
      concatenated stream given the same phase/parity estimate.
    * ``algo="tracking"`` — the clock-drift-tracking CDR: a second-order
      timing loop (fractional phase + clock-rate estimate) measured per
      ``window_symbols`` window, sampling at continuous positions so no
      symbol slips at window boundaries and the Manchester pairing is
      established once, not re-voted (golden.rds.cdr_tracking_window —
      the same code the offline ``decode_robust(window_symbols=...)``
      runs, so full windows emit identical bits).  Use for real
      transmitters whose symbol clock drifts ppm-scale against the
      receiver grid; call ``flush()`` at EOF to decode the final partial
      window.

    The full carry round-trips through ``state_dict``/``load_state_dict``
    (arrays + JSON-able meta), which ``sdr_tpu_torch.checkpoint`` persists
    so a mid-stream resume reproduces the uninterrupted frame stream
    exactly (SURVEY.md §5 checkpoint/resume contract).
    """

    def __init__(self, sps: int, algo: str = "robust",
                 window_symbols: int = 256, min_est_symbols: int = 200,
                 error_correction: bool = True):
        if algo not in ("robust", "reference", "tracking"):
            raise ValueError(f"unknown RDS algorithm {algo!r}")
        self.sps = int(sps)
        self.algo = algo
        self.window_symbols = int(window_symbols)
        self.min_est_symbols = int(min_est_symbols)
        # burst-<=5 error correction while frame-synchronized
        # (golden.rds.frame_sync_ec) — capability the reference's
        # exact-match framesync lacks.  Never applied on the "reference"
        # algo, whose contract is upstream parity.
        self.error_correction = bool(error_correction)
        self.sync_scan = grds.SyncScanState()
        self.n_corrected = 0            # blocks saved by correction
        self.n_corrected_bits = 0       # total bits flipped
        self.block_count = 0
        # frame-sync carry
        self.backlog = np.zeros(0, dtype=np.int64)
        self.backlog_pos = 0            # absolute bit index of backlog[0]
        self.n_matches = 0
        self.last_offset = ""
        # reference-CDR carry
        self.cdr_state = grds.CdrState()
        # robust-CDR carry
        self.phase = -1                 # -1: not yet estimated
        self.parity = -1
        self.next_idx = 0               # next sampling point, relative
        self.sym_carry: float | None = None   # unpaired sampled symbol
        self.prev_manch: int | None = None    # diff-decode carry
        self.est_buf = np.zeros(0, dtype=np.float64)  # pre-estimate samples
        # tracking-CDR carry
        self.sample_buf = np.zeros(0, dtype=np.float64)
        self.track_state: grds.TrackState | None = None
        # group-assembly carry: (abs_pos, offset, 16 info bits)
        self.pending: list[tuple[int, str, np.ndarray]] = []
        self.station = rds_groups.StationDecoder()
        self.groups: list[rds_groups.Group] = []

    # --- symbol-clock recovery --------------------------------------------
    def _tracking_bits(self, x: np.ndarray) -> np.ndarray:
        buf = np.concatenate([self.sample_buf, x])
        w = self.window_symbols * self.sps
        out: list[np.ndarray] = []
        while len(buf) >= w:
            win, buf = buf[:w], buf[w:]
            manch, self.track_state = grds.cdr_tracking_window(
                win, self.sps, self.track_state)
            out.append(manch)
        self.sample_buf = buf
        return (np.concatenate(out) if out else np.zeros(0, np.int64))

    def _robust_bits(self, x: np.ndarray) -> np.ndarray:
        if self.phase < 0:
            self.est_buf = np.concatenate([self.est_buf, x])
            if len(self.est_buf) < self.min_est_symbols * self.sps:
                return np.zeros(0, np.int64)
            x, self.est_buf = self.est_buf, np.zeros(0, np.float64)
            _, self.phase, self.parity = grds.cdr_robust(x, self.sps)
            self.next_idx = self.phase
            first = True
        else:
            first = False
        samples = x[self.next_idx::self.sps]
        self.next_idx = (self.next_idx + len(samples) * self.sps) - len(x)
        if first:
            samples = samples[self.parity:]
        if self.sym_carry is not None:
            samples = np.concatenate([[self.sym_carry], samples])
        n2 = len(samples) // 2
        a, b = samples[0:2 * n2:2], samples[1:2 * n2:2]
        manch = ((a > 0) & (b < 0)).astype(np.int64)
        self.sym_carry = float(samples[-1]) if len(samples) % 2 else None
        return manch

    def _manchester_bits(self, x: np.ndarray) -> np.ndarray:
        if self.algo == "reference":
            manch, self.cdr_state = grds.cdr(x, self.sps, self.cdr_state,
                                             self.block_count)
            return manch
        if self.algo == "tracking":
            return self._tracking_bits(x)
        return self._robust_bits(x)

    def feed(self, symbols: np.ndarray) -> list[tuple[int, str]]:
        """Consume one block of soft symbols; returns the NEW frame matches
        as (absolute bit position, offset type)."""
        x = np.asarray(symbols, dtype=np.float64).reshape(-1)
        manch = self._manchester_bits(x)
        self.block_count += 1
        return self._advance(manch)

    def flush(self) -> list[tuple[int, str]]:
        """Decode whatever the CDR still buffers (call at EOF).

        ``tracking`` holds up to one window of samples; ``robust`` may
        still be accumulating its estimation buffer on short captures.
        ``reference`` buffers nothing.  Idempotent."""
        if self.algo == "tracking" and len(self.sample_buf) >= 4 * self.sps:
            manch, self.track_state = grds.cdr_tracking_window(
                self.sample_buf, self.sps, self.track_state)
            self.sample_buf = np.zeros(0, np.float64)
            return self._advance(manch)
        if self.algo == "robust" and self.phase < 0 and len(self.est_buf):
            x, self.est_buf = self.est_buf, np.zeros(0, np.float64)
            _, self.phase, self.parity = grds.cdr_robust(x, self.sps)
            self.next_idx = self.phase
            samples = x[self.next_idx::self.sps]
            self.next_idx = (self.next_idx
                             + len(samples) * self.sps) - len(x)
            samples = samples[self.parity:]
            n2 = len(samples) // 2
            a, b = samples[0:2 * n2:2], samples[1:2 * n2:2]
            manch = ((a > 0) & (b < 0)).astype(np.int64)
            self.sym_carry = (float(samples[-1]) if len(samples) % 2
                              else None)
            return self._advance(manch)
        return []

    def _advance(self, manch: np.ndarray) -> list[tuple[int, str]]:
        if self.algo == "reference":
            # per-block differential decode, no carry — the convention of
            # the upstream block loop (model/fmRDS.py:274) and
            # decode_reference, kept so the two emit IDENTICAL frames
            bits = grds.diff_decode(manch)
        else:
            bits = grds.diff_decode(manch, prev_bit=self.prev_manch)
            if len(manch):
                self.prev_manch = int(manch[-1])

        stream = np.concatenate([self.backlog, bits])
        if self.error_correction and self.algo != "reference":
            res = grds.frame_sync_ec(stream, self.sync_scan)
            self.sync_scan = res.state
            accepted = res.matches
            consumed = res.consumed
        else:
            frames = grds.frame_sync(stream)
            accepted = [(pos, off, stream[pos:pos + 26], 0)
                        for pos, off in frames.matches]
            consumed = frames.consumed
        new: list[tuple[int, str]] = []
        for pos, off, win, ne in accepted:
            abs_pos = self.backlog_pos + pos
            new.append((abs_pos, off))
            self.pending.append((abs_pos, off,
                                 np.asarray(win[:16], np.int64).copy()))
            if ne:
                self.n_corrected += 1
                self.n_corrected_bits += ne
        self.n_matches += len(accepted)
        if accepted:
            self.last_offset = accepted[-1][1]
        self.backlog = stream[consumed:]
        self.backlog_pos += consumed
        self._drain_groups()
        return new

    def _drain_groups(self) -> None:
        """Same acquisition rule as rds_groups.assemble_groups, incremental:
        emit a group when 4 consecutive matches form A,B,C|C',D at 26-bit
        spacing; otherwise slide by one.  At most 3 matches stay pending."""
        pend = self.pending
        while len(pend) >= 4:
            (p0, o0, w0), (p1, o1, w1), (p2, o2, w2), (p3, o3, w3) = pend[:4]
            if (o0, o1, o3) == ("A", "B", "D") \
                    and o2 in rds_groups._THIRD_BLOCK \
                    and (p1 - p0, p2 - p0, p3 - p0) == (26, 52, 78):
                words = np.stack([w0, w1, w2, w3])
                g = rds_groups.Group(
                    bit_pos=p0,
                    gtype=rds_groups.bits_to_int(words[1]) >> 12,
                    version=rds_groups._THIRD_BLOCK[o2], words=words)
                self.groups.append(g)
                self.station.update([g])
                del pend[:4]
            else:
                del pend[0]

    def station_info(self) -> "rds_groups.StationInfo":
        return self.station.info()

    # --- checkpoint/resume --------------------------------------------------
    def state_dict(self) -> tuple[dict[str, np.ndarray], dict]:
        """(arrays, json-able meta) capturing the complete carry."""
        arrays = {
            "backlog": self.backlog.astype(np.int64),
            "pending_words": (np.stack([w for _, _, w in self.pending])
                              if self.pending
                              else np.zeros((0, 16), np.int64)),
            "est_buf": self.est_buf.astype(np.float64),
            "sample_buf": self.sample_buf.astype(np.float64),
        }
        meta = {
            "sps": self.sps, "algo": self.algo,
            "window_symbols": self.window_symbols,
            "min_est_symbols": self.min_est_symbols,
            "error_correction": self.error_correction,
            "sync_scan": [self.sync_scan.synced, self.sync_scan.expect,
                          self.sync_scan.streak],
            "n_corrected": self.n_corrected,
            "n_corrected_bits": self.n_corrected_bits,
            "block_count": self.block_count,
            "backlog_pos": self.backlog_pos,
            "n_matches": self.n_matches, "last_offset": self.last_offset,
            "cdr": [self.cdr_state.pair_prev, self.cdr_state.start,
                    self.cdr_state.prev_size],
            "phase": self.phase, "parity": self.parity,
            "next_idx": self.next_idx, "sym_carry": self.sym_carry,
            "prev_manch": self.prev_manch,
            "track": (None if self.track_state is None else
                      [self.track_state.pos, self.track_state.step,
                       self.track_state.carry_sym,
                       self.track_state.locked]),
            "pending": [[p, o] for p, o, _ in self.pending],
            "station": self.station.state_json(),
            "n_groups_assembled": len(self.groups),
        }
        return arrays, meta

    @classmethod
    def load_state_dict(cls, arrays: dict[str, np.ndarray],
                        meta: dict) -> "StreamingRdsDecoder":
        d = cls(meta["sps"], meta["algo"],
                window_symbols=meta.get("window_symbols", 256),
                min_est_symbols=meta.get("min_est_symbols", 200),
                error_correction=meta.get("error_correction", False))
        ss = meta.get("sync_scan")
        if ss is not None:
            d.sync_scan = grds.SyncScanState(bool(ss[0]), str(ss[1]),
                                             int(ss[2]))
        d.n_corrected = int(meta.get("n_corrected", 0))
        d.n_corrected_bits = int(meta.get("n_corrected_bits", 0))
        d.est_buf = np.asarray(arrays.get("est_buf",
                                          np.zeros(0)), np.float64)
        d.sample_buf = np.asarray(arrays.get("sample_buf",
                                             np.zeros(0)), np.float64)
        tr = meta.get("track")
        if tr is None and "prev_phase" in meta:
            # pre-r4 checkpoints stored the tracking carry under
            # 'prev_phase' (different layout): the tracking CDR would
            # silently re-lock instead of continuing — warn instead of
            # diverging quietly (ADVICE r4)
            import sys
            print("warning: checkpoint carries the legacy 'prev_phase' "
                  "tracking-CDR state, which this revision cannot resume; "
                  "the symbol clock will re-lock (a few bits may differ "
                  "from the uninterrupted stream)", file=sys.stderr)
        d.track_state = (None if tr is None else grds.TrackState(
            pos=float(tr[0]), step=float(tr[1]),
            carry_sym=None if tr[2] is None else float(tr[2]),
            locked=bool(tr[3])))
        d.block_count = meta["block_count"]
        d.backlog = np.asarray(arrays["backlog"], dtype=np.int64)
        d.backlog_pos = meta["backlog_pos"]
        d.n_matches = meta["n_matches"]
        d.last_offset = meta["last_offset"]
        d.cdr_state = grds.CdrState(pair_prev=float(meta["cdr"][0]),
                                    start=int(meta["cdr"][1]),
                                    prev_size=int(meta["cdr"][2]))
        d.phase = meta["phase"]
        d.parity = meta["parity"]
        d.next_idx = meta["next_idx"]
        d.sym_carry = meta["sym_carry"]
        d.prev_manch = meta["prev_manch"]
        words = np.asarray(arrays["pending_words"], dtype=np.int64)
        d.pending = [(int(p), str(o), words[i])
                     for i, (p, o) in enumerate(meta["pending"])]
        d.station = rds_groups.StationDecoder.from_state_json(
            meta["station"])
        # assembled Group objects before the checkpoint are summary data,
        # not carry — the station accumulator already folded them in
        d.groups = []
        return d


def decode_reference(symbols_blocks: np.ndarray, sps: int) -> RdsDecodeResult:
    """Reference-faithful streaming decode over stacked per-block symbols
    (model/fmRDS.py:256-278 block loop)."""
    st = grds.CdrState()
    backlog = np.zeros(0, dtype=np.int64)
    all_bits: list[np.ndarray] = []
    all_matches: list[tuple[int, str]] = []
    consumed_total = 0
    for b, blk in enumerate(np.asarray(symbols_blocks)):
        manch, st = grds.cdr(blk, sps, st, b)
        bits = grds.diff_decode(manch)
        all_bits.append(bits)
        stream = np.concatenate([backlog, bits])
        frames = grds.frame_sync(stream)
        for pos, off in frames.matches:
            all_matches.append((consumed_total + pos, off))
        consumed_total += frames.consumed
        backlog = stream[frames.consumed:]
    bits = np.concatenate(all_bits) if all_bits else np.zeros(0, np.int64)
    frames = grds.FrameSyncResult(
        all_matches, consumed_total,
        all_matches[-1][1] if all_matches else "")
    return RdsDecodeResult(bits, frames, _info_words(bits, frames))
