"""RDS group assembly and program-information decode (host side).

A copy of ``sdr_tpu/models/rds_groups.py`` (numpy only), because importing
anything under ``sdr_tpu.models`` loads the JAX receiver.  The text below
is the original's.

The reference stops at frame synchronization — 26-bit blocks labelled with
offset types A/B/C/C'/D (model/fmSupportLib.py:30-100); its report's goal
was "to identify the offset types".  Real RDS receivers need the layer
above: assembling synchronized blocks into 104-bit *groups* and decoding
the program information they carry (IEC 62106 group structure):

 * block A  — PI (Programme Identification) code, 16 bits
 * block B  — group type (4 bits) + version (A/B) + TP flag + PTY (5 bits)
              + 5 group-specific bits
 * group 0A/0B — PS (Programme Service) name, 2 chars/group, 8 total
 * group 2A/2B — RadioText, 4 (2A) or 2 (2B) chars/group, up to 64

This module is pure numpy over the outputs of ``models.rds_decode`` /
``golden.rds.frame_sync``: group-rate data is ~11.4 groups/s, so host-side
decode is the right placement (same argument as the symbol-rate CDR,
SURVEY.md §7 step 5).  The matching transmit side lives in
``utils.synth.rds_encode_station`` so ground-truth round-trip tests cover
the whole chain: synthesized station -> TPU receiver -> PS/RadioText.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

from sdr_tpu.golden import rds as grds

#: offsets of the third block by group version (IEC 62106: version A
#: groups use offset C, version B groups use offset C').
_THIRD_BLOCK = {"C": "A", "C_apos": "B"}


def bits_to_int(bits: np.ndarray) -> int:
    """MSB-first bit vector -> integer (RDS transmits m15 first)."""
    out = 0
    for b in np.asarray(bits, dtype=np.int64):
        out = (out << 1) | int(b)
    return out


def _char(code: int) -> str:
    """RDS basic character table; printable-ASCII subset, else '?'.
    0x0D is kept — it is the RadioText terminator (IEC 62106 §3.1.5.3)."""
    if code == 0x0D:
        return "\r"
    return chr(code) if 0x20 <= code <= 0x7E else "?"


@dataclasses.dataclass
class Group:
    """One assembled 104-bit RDS group."""

    bit_pos: int            # stream position of block A
    gtype: int              # group type code, 0-15
    version: str            # 'A' or 'B'
    words: np.ndarray       # (4, 16) info bits of blocks A,B,C,D


@dataclasses.dataclass
class StationInfo:
    """Decoded programme information with per-segment receive masks."""

    pi: int | None
    pty: int | None
    tp: bool | None
    ps_name: str            # 8 chars; unreceived segments are spaces
    radiotext: str          # trimmed at the 0x0D terminator if received
    ps_seen: np.ndarray     # (4,) bool — PS segments received
    rt_seen: np.ndarray     # (16,) bool — RadioText segments received
    n_groups: int
    group_counts: dict[str, int]   # e.g. {"0A": 12, "2A": 24}


def assemble_groups(frames: grds.FrameSyncResult,
                    bits: np.ndarray) -> list[Group]:
    """Collect complete A,B,C|C',D runs at consecutive block positions.

    ``frames``/``bits`` are the outputs the receiver already produces
    (models.rds_decode.RdsDecodeResult.frames / .bits).  A group is kept
    only when all four blocks matched back-to-back (26 bits apart), which
    is the standard acquisition rule — isolated matches are sync noise.
    """
    bits = np.asarray(bits, dtype=np.int64)
    groups: list[Group] = []
    matches = frames.matches
    i = 0
    while i + 3 < len(matches):
        (p0, o0), (p1, o1), (p2, o2), (p3, o3) = matches[i:i + 4]
        if (o0, o1, o3) == ("A", "B", "D") and o2 in _THIRD_BLOCK \
                and (p1 - p0, p2 - p0, p3 - p0) == (26, 52, 78):
            words = np.stack([bits[p:p + 16]
                              for p in (p0, p1, p2, p3)])
            b = bits_to_int(words[1])
            groups.append(Group(bit_pos=p0, gtype=b >> 12,
                                version=_THIRD_BLOCK[o2], words=words))
            i += 4
        else:
            i += 1
    return groups


class StationDecoder:
    """Incremental programme-information decoder over assembled groups.

    PI/PTY/TP are majority-voted across groups (a single corrupted block
    that still passed the syndrome check cannot flip them); PS name and
    RadioText segments are filled in as their groups arrive, newest write
    wins (the broadcast semantics — text changes simply overwrite).

    Feed groups with ``update``; ``info()`` snapshots the current
    StationInfo.  State is O(1) regardless of stream length, and
    ``state_json``/``from_state_json`` round-trip it for checkpoint/resume
    (SURVEY.md §5) — the streaming CLI carries one of these per run.
    """

    def __init__(self) -> None:
        self.pi_votes: Counter = Counter()
        self.pty_votes: Counter = Counter()
        self.tp_votes: Counter = Counter()
        self.ps = [" "] * 8
        self.ps_seen = np.zeros(4, dtype=bool)
        self.rt = [" "] * 64
        self.rt_seen = np.zeros(16, dtype=bool)
        self.rt_char_seen = np.zeros(64, dtype=bool)
        self.rt_ab: int | None = None
        self.counts: Counter = Counter()
        self.n_groups = 0

    def update(self, groups: list[Group]) -> "StationDecoder":
        for g in groups:
            self._one(g)
        return self

    def _one(self, g: Group) -> None:
        self.n_groups += 1
        self.counts[f"{g.gtype}{g.version}"] += 1
        b = bits_to_int(g.words[1])
        self.pi_votes[bits_to_int(g.words[0])] += 1
        if g.version == "B":
            # version B carries the PI code again in block C
            self.pi_votes[bits_to_int(g.words[2])] += 1
        self.tp_votes[bool((b >> 10) & 1)] += 1
        self.pty_votes[(b >> 5) & 0x1F] += 1

        if g.gtype == 0:                         # 0A/0B: PS name
            addr = b & 0x3
            d = bits_to_int(g.words[3])
            self.ps[2 * addr] = _char(d >> 8)
            self.ps[2 * addr + 1] = _char(d & 0xFF)
            self.ps_seen[addr] = True
        elif g.gtype == 2:                       # 2A/2B: RadioText
            # Text A/B flag (block B bit 4, IEC 62106 §3.1.5.3): a flip
            # announces a NEW message — stale characters of the previous
            # one must not bleed into it
            ab = (b >> 4) & 1
            if self.rt_ab is not None and ab != self.rt_ab:
                self.rt = [" "] * 64
                self.rt_seen[:] = False
                self.rt_char_seen[:] = False
            self.rt_ab = ab
            addr = b & 0xF
            if g.version == "A":
                c = bits_to_int(g.words[2])
                d = bits_to_int(g.words[3])
                chars = [c >> 8, c & 0xFF, d >> 8, d & 0xFF]
                self.rt[4 * addr: 4 * addr + 4] = [_char(x) for x in chars]
                self.rt_char_seen[4 * addr: 4 * addr + 4] = True
            else:
                d = bits_to_int(g.words[3])
                self.rt[2 * addr: 2 * addr + 2] = [_char(d >> 8),
                                                   _char(d & 0xFF)]
                self.rt_char_seen[2 * addr: 2 * addr + 2] = True
            self.rt_seen[addr] = True

    def info(self) -> StationInfo:
        text = "".join(self.rt)
        if "\r" in text:                         # 0x0D terminates RadioText
            text = text[: text.index("\r")]
        else:
            # no terminator received: drop only trailing chars of UNRECEIVED
            # segments (rendered as filler spaces); received trailing spaces
            # are part of the message and stay
            last = int(np.max(np.nonzero(self.rt_char_seen)[0])) + 1 \
                if self.rt_char_seen.any() else 0
            text = text[:last]
        mode = lambda c: c.most_common(1)[0][0] if c else None
        return StationInfo(pi=mode(self.pi_votes), pty=mode(self.pty_votes),
                           tp=mode(self.tp_votes), ps_name="".join(self.ps),
                           radiotext=text, ps_seen=self.ps_seen.copy(),
                           rt_seen=self.rt_seen.copy(),
                           n_groups=self.n_groups,
                           group_counts=dict(self.counts))

    def state_json(self) -> dict:
        """JSON-serializable snapshot of the full decoder state."""
        return {
            "pi_votes": list(self.pi_votes.items()),
            "pty_votes": list(self.pty_votes.items()),
            "tp_votes": [[int(k), v] for k, v in self.tp_votes.items()],
            "ps": "".join(self.ps),
            "ps_seen": self.ps_seen.astype(int).tolist(),
            "rt": "".join(self.rt),
            "rt_seen": self.rt_seen.astype(int).tolist(),
            "rt_char_seen": self.rt_char_seen.astype(int).tolist(),
            "rt_ab": self.rt_ab,
            "counts": list(self.counts.items()),
            "n_groups": self.n_groups,
        }

    @classmethod
    def from_state_json(cls, st: dict) -> "StationDecoder":
        d = cls()
        d.pi_votes = Counter(dict((int(k), v) for k, v in st["pi_votes"]))
        d.pty_votes = Counter(dict((int(k), v) for k, v in st["pty_votes"]))
        d.tp_votes = Counter(dict((bool(k), v) for k, v in st["tp_votes"]))
        d.ps = list(st["ps"])
        d.ps_seen = np.asarray(st["ps_seen"], dtype=bool)
        d.rt = list(st["rt"])
        d.rt_seen = np.asarray(st["rt_seen"], dtype=bool)
        d.rt_char_seen = np.asarray(st["rt_char_seen"], dtype=bool)
        d.rt_ab = st["rt_ab"]
        d.counts = Counter(dict(st["counts"]))
        d.n_groups = st["n_groups"]
        return d


def decode_station(groups: list[Group]) -> StationInfo:
    """Decode programme information from a whole list of groups at once."""
    return StationDecoder().update(groups).info()


def decode_station_from(dec) -> StationInfo:
    """Convenience: RdsDecodeResult -> StationInfo in one call."""
    return decode_station(assemble_groups(dec.frames, dec.bits))
