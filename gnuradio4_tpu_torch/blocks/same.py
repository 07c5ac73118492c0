"""SAME / EAS model family — broadcast emergency-alert headers.

The Specific Area Message Encoding protocol (NOAA Weather Radio / EAS):
520.83 baud AFSK with mark 2083.3 Hz ('1') and space 1562.5 Hz ('0'), bytes
sent LSB-first. A transmission is three identical header bursts
(16×0xAB preamble + ``ZCZC-ORG-EEE-PSSCCC+TTTT-JJJHHMM-LLLLLLLL-`` ASCII)
separated by one second of silence; end-of-message is three bursts of
preamble + ``NNNN``.

Device/host split (the family pattern, blocks/rtty.py): synthesis is a
per-sample frequency timeline integrated into phase-continuous FM; the
:class:`SameDecoder` sink splits bursts on envelope silence, recovers the
bit clock from the preamble's alternation edges, majority-votes the three
bursts character-wise, and exposes the decoded ``headers`` list.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting
from .sstv import instantaneous_frequency

BAUD = 520.0 + 5.0 / 6.0          # 520.83...; bit = 1.92 ms exactly
F_MARK = 2083.0 + 1.0 / 3.0       # 2083.33 Hz = 4 cycles/bit
F_SPACE = 1562.5                  # 1562.5  Hz = 3 cycles/bit
PREAMBLE = b"\xab" * 16


def bytes_to_bits(data: bytes) -> np.ndarray:
    """LSB-first bit expansion (SAME byte order)."""
    arr = np.frombuffer(bytes(data), np.uint8)
    return ((arr[:, None] >> np.arange(8)) & 1).reshape(-1)


def bits_to_bytes(bits: np.ndarray) -> bytes:
    bits = np.asarray(bits, np.uint8)[: len(bits) // 8 * 8]
    return bytes((bits.reshape(-1, 8) << np.arange(8)).sum(axis=1)
                 .astype(np.uint8))


def same_burst(message: str, *, fs: float, amplitude: float = 0.8
               ) -> np.ndarray:
    """One AFSK burst: 16-byte preamble + ASCII message."""
    bits = bytes_to_bits(PREAMBLE + message.encode("ascii"))
    # sample-exact fractional bit boundaries
    bounds = np.round(np.arange(len(bits) + 1) * fs / BAUD).astype(np.int64)
    freq = np.empty(bounds[-1])
    for b, lo, hi in zip(bits, bounds[:-1], bounds[1:]):
        freq[lo:hi] = F_MARK if b else F_SPACE
    phase = 2.0 * np.pi * np.cumsum(freq) / fs
    return (amplitude * np.sin(phase)).astype(np.float32)


def same_modulate(header: str, *, fs: float = 48000.0,
                  amplitude: float = 0.8, gap_s: float = 1.0,
                  eom: bool = True) -> np.ndarray:
    """Full SAME transmission: 3× header bursts (+ optional 3× NNNN EOM),
    1 s silence between bursts."""
    gap = np.zeros(int(round(gap_s * fs)), np.float32)
    parts = [gap]
    for _ in range(3):
        parts += [same_burst(header, fs=fs, amplitude=amplitude), gap]
    if eom:
        for _ in range(3):
            parts += [same_burst("NNNN", fs=fs, amplitude=amplitude), gap]
    return np.concatenate(parts)


def demod_burst(freq: np.ndarray, fs: float) -> str:
    """Decode one burst's frequency stream to ASCII (after the preamble)."""
    mid = (F_MARK + F_SPACE) / 2.0
    mark = freq > mid
    bit_n = fs / BAUD
    # bit clock from the preamble: 0xAB LSB-first = 1,1,0,1,0,1,0,1 —
    # dense alternations whose edges all sit on bit boundaries
    edges = np.flatnonzero(np.diff(mark.astype(np.int8))) + 1
    if len(edges) < 8:
        return ""
    phase = np.median(edges[:40] % bit_n)
    # every bit whose central integration window [0.25, 0.75)·bit fits
    n_bits = int((len(freq) - phase - 0.75 * bit_n) // bit_n) + 1
    if n_bits <= 0:
        return ""
    # integrate the central half of each bit (matched-filter-ish) instead
    # of a single mid-bit sample — decisive at low SNR
    starts = phase + np.arange(n_bits) * bit_n
    lo = (starts + 0.25 * bit_n).astype(np.int64)
    hi = (starts + 0.75 * bit_n).astype(np.int64)
    csum = np.concatenate([[0.0], np.cumsum(freq)])
    mean = (csum[hi] - csum[lo]) / np.maximum(hi - lo, 1)
    bits = (mean > mid).astype(np.uint8)
    raw = bits_to_bytes(bits)
    # strip preamble: find the last 0xAB run
    k = 0
    while k < len(raw) and raw[k] == 0xAB:
        k += 1
    if k == 0:
        # clock may have locked mid-preamble with a byte-phase slip: scan
        for shift in range(8):
            raw2 = bits_to_bytes(bits[shift:])
            k2 = 0
            while k2 < len(raw2) and raw2[k2] == 0xAB:
                k2 += 1
            if k2 >= 8:
                raw, k = raw2, k2
                break
    msg = raw[k:]
    out = []
    for b in msg:
        if 32 <= b < 127:
            out.append(chr(b))
        else:
            break
    return "".join(out)


def _majority(texts: list[str]) -> str:
    """Character-wise 2-of-3 vote across burst decodes (the receiver rule
    from the EAS spec: any two agreeing bursts validate the header)."""
    texts = [t for t in texts if t]
    if not texts:
        return ""
    n = max(len(t) for t in texts)
    out = []
    for i in range(n):
        votes: dict[str, int] = {}
        for t in texts:
            if i < len(t):
                votes[t[i]] = votes.get(t[i], 0) + 1
        ch, cnt = max(votes.items(), key=lambda kv: kv[1])
        if cnt >= 2 or len(texts) == 1:
            out.append(ch)
        else:
            break
    return "".join(out)


@register_block("SameSource")
class SameSource(SourceBlock):
    """Plays a SAME/EAS transmission for a header string (test stimulus)."""

    OUT = (Port("out", dtype="float32"),)
    FEED = True
    sample_rate = Setting(default=48000.0, kind="static")

    def __init__(self, header: str = "", name=None, **settings):
        super().__init__(name=name, **settings)
        fs = float(self.settings.get("sample_rate"))
        self._wave = same_modulate(header, fs=fs) if header else \
            np.zeros(0, np.float32)

    def host_feed(self, n, abs_index):
        if abs_index >= len(self._wave):
            return None
        chunk = self._wave[abs_index:abs_index + n]
        return {"out": chunk}, len(chunk)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("SameDecoder")
class SameDecoder(SinkBlock):
    """SAME/EAS receiver sink: envelope burst splitter (≥0.25 s silence),
    per-burst AFSK demod with preamble clock recovery, character-wise
    2-of-3 majority vote. ``headers`` collects validated ZCZC headers in
    arrival order; ``eom`` flips when the NNNN end-of-message validates."""

    IN = (Port("in", dtype="float32"),)
    sample_rate = Setting(default=48000.0, kind="static")
    max_buffer_s = Setting(default=60.0, kind="static",
                           description="history bound for a continuous "
                                       "stream: once exceeded, validated "
                                       "headers are archived and the buffer "
                                       "flushes at the next quiet second")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.float32)
        self._pending = 0
        self._archived: list[str] = []
        self.headers: list[str] = []
        self.eom = False

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.asarray(arrays["in"][..., :n_valid], np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, x])
        self._pending += n_valid
        fs = float(self.settings.get("sample_rate"))
        if self._pending >= int(fs):
            self._pending = 0
            self._decode()

    def stop(self):
        self._decode()

    def _decode(self) -> None:
        fs = float(self.settings.get("sample_rate"))
        k = max(1, int(round(0.010 * fs)))
        env = np.convolve(np.abs(self._buf), np.full(k, 1.0 / k),
                          mode="same")
        if not env.size:
            return
        # silence floor vs burst level: the histogram is bimodal (quiet gaps
        # + active bursts), so the p10/p90 midpoint separates them even when
        # channel noise raises the floor well above zero
        lo, hi = np.percentile(env, [10.0, 90.0])
        if hi <= 1.5 * lo:
            # no bursts present — drop dead air so silence can't grow the
            # buffer unboundedly (keep a second for a burst straddling it)
            if len(self._buf) > 2 * fs:
                self._buf = self._buf[-int(fs):]
            return
        act = env > (lo + hi) / 2.0
        # burst segmentation: rising/falling pairs
        rises = np.flatnonzero(act[1:] & ~act[:-1]) + 1
        falls = np.flatnonzero(~act[1:] & act[:-1]) + 1
        if act[0]:
            rises = np.concatenate([[0], rises])
        if len(falls) < len(rises):
            falls = np.concatenate([falls, [len(act)]])
        texts = []
        min_burst = int(0.1 * fs)
        # envelope smoothing erodes burst tails: pad the end (the head must
        # stay on-signal — preamble edges drive the bit-clock recovery)
        pad = int(0.02 * fs)
        for r, f in zip(rises, falls):
            if f - r < min_burst:
                continue
            seg = self._buf[r: min(len(self._buf), f + pad)]
            freq = instantaneous_frequency(seg, fs)
            kk = max(1, int(round(0.0004 * fs)))
            if kk > 1:
                freq = np.convolve(freq, np.full(kk, 1.0 / kk), mode="same")
            texts.append(demod_burst(freq, fs))
        headers: list[str] = []
        group: list[str] = []
        eom = False

        def _flush():
            nonlocal eom
            if not group:
                return
            msg = _majority(group)
            if msg.startswith("NNNN"):
                eom = True
            elif msg.startswith("ZCZC"):
                headers.append(msg)
            group.clear()

        kind = None
        for t in texts:
            this = "N" if t.startswith("NNNN") else \
                ("Z" if t.startswith("ZCZC") else None)
            if this is None:
                # unrecognized fragment (e.g. a burst split by a dropout):
                # it votes with the current group rather than ending it
                group.append(t)
                continue
            if kind is not None and this != kind:
                _flush()
            group.append(t)
            kind = this
        _flush()
        if headers or self._archived:
            self.headers = self._archived + headers
        if eom:
            self.eom = True
        cap = int(float(self.settings.get("max_buffer_s")) * fs)
        if len(self._buf) > cap:
            # flush at a quiet tail (no burst in flight); past 2×cap flush
            # unconditionally
            lo2, hi2 = np.percentile(env, [10.0, 90.0])
            tail_quiet = (hi2 <= 1.5 * lo2
                          or not act[-int(0.5 * fs):].any())
            if tail_quiet or len(self._buf) > 2 * cap:
                self._archived = list(self.headers)
                self._buf = np.zeros(0, np.float32)
