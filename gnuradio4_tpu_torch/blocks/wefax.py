"""WEFAX / HF radiofax model family (IOC 576, 120 lines per minute).

Marine weather charts transmitted as an FM audio subcarrier on SSB: pixel
luminance maps linearly to tone frequency (1500 Hz black → 2300 Hz white,
the same luminance map as SSTV), 2 lines per second. A transmission is
framed by a 5 s **start tone** (the subcarrier square-switched at 300 Hz for
IOC 576), a **phasing** interval of white lines each carrying a 5%-width
black sync pulse (the receiver derives the line phase from these), the
image, and a 450 Hz **stop tone**.

Device/host split (the family pattern, blocks/sstv.py): synthesis is a
vectorized per-sample frequency timeline integrated into phase-continuous
FM; the :class:`WefaxDecoder` sink consumes the audio (or discriminator)
stream — analytic-signal discriminator, 300 Hz start-tone detector, phasing-
pulse line alignment, fixed-timebase line slicing with per-pixel bin
averaging — and exposes the live grayscale ``image``.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting
from .sstv import _close_gaps, instantaneous_frequency

F_BLACK = 1500.0
F_WHITE = 2300.0
LPM = 120.0                        # lines per minute (IOC 576 standard)
START_TONE_HZ = 300.0              # IOC 576 start alternation
STOP_TONE_HZ = 450.0
PHASE_PULSE_FRAC = 0.05            # black sync pulse width per phasing line


def _pixel_freq(values: np.ndarray) -> np.ndarray:
    v = np.clip(np.asarray(values, np.float64), 0.0, 255.0)
    return F_BLACK + (F_WHITE - F_BLACK) * v / 255.0


def _tone_freqs(alt_hz: float, dur_s: float, fs: float) -> np.ndarray:
    """Start/stop tone: the subcarrier square-switched black/white at
    ``alt_hz``."""
    n = int(round(dur_s * fs))
    t = np.arange(n) / fs
    sq = (np.floor(2.0 * alt_hz * t) % 2).astype(np.float64)
    return F_BLACK + (F_WHITE - F_BLACK) * sq


def phasing_line_freqs(fs: float, lpm: float = LPM) -> np.ndarray:
    """One phasing line: black pulse (5%) then white."""
    n = int(round(60.0 / lpm * fs))
    f = np.full(n, F_WHITE)
    f[: int(round(PHASE_PULSE_FRAC * n))] = F_BLACK
    return f


def wefax_modulate(image: np.ndarray, *, fs: float = 11025.0,
                   lpm: float = LPM, amplitude: float = 0.8,
                   start_s: float = 2.0, n_phasing: int = 10,
                   stop_s: float = 1.0) -> np.ndarray:
    """Phase-continuous radiofax audio for a grayscale ``[H, W]`` (or RGB,
    converted by luma) uint8 image."""
    image = np.asarray(image)
    if image.ndim == 3:
        image = image.mean(axis=-1)
    line_n = int(round(60.0 / lpm * fs))
    px = (np.arange(line_n) * image.shape[1] / line_n).astype(np.int64)
    freqs = [_tone_freqs(START_TONE_HZ, start_s, fs)]
    freqs += [phasing_line_freqs(fs, lpm)] * n_phasing
    for row in image:
        freqs.append(_pixel_freq(row)[px])
    freqs.append(_tone_freqs(STOP_TONE_HZ, stop_s, fs))
    f = np.concatenate(freqs)
    phase = 2.0 * np.pi * np.cumsum(f) / fs
    return (amplitude * np.sin(phase)).astype(np.float32)


def detect_start_tone(freq: np.ndarray, fs: float,
                      alt_hz: float = START_TONE_HZ) -> int | None:
    """Index just after the start tone, or None. The tone is the luminance
    square wave at ``alt_hz`` — detected as a dense run of black/white
    alternations at the right rate."""
    mid = (F_BLACK + F_WHITE) / 2.0
    hi = freq > mid
    flips = np.flatnonzero(np.diff(hi.astype(np.int8)))
    if len(flips) < 16:
        return None
    gaps = np.diff(flips)
    want = fs / (2.0 * alt_hz)
    good = np.abs(gaps - want) < 0.25 * want
    # longest consecutive run of on-rate alternations
    best_len, best_end, run = 0, -1, 0
    for i, g in enumerate(good):
        run = run + 1 if g else 0
        if run > best_len:
            best_len, best_end = run, i
    if best_len < 16:
        return None
    return int(flips[best_end + 1])


@register_block("WefaxSource")
class WefaxSource(SourceBlock):
    """Plays the radiofax audio for an image (test stimulus / TX)."""

    OUT = (Port("out", dtype="float32"),)
    FEED = True
    sample_rate = Setting(default=11025.0, kind="static")
    lpm = Setting(default=LPM, kind="static")

    def __init__(self, image=None, name=None, **settings):
        super().__init__(name=name, **settings)
        fs = float(self.settings.get("sample_rate"))
        self._wave = (wefax_modulate(np.asarray(image), fs=fs,
                                     lpm=float(self.settings.get("lpm")))
                      if image is not None else np.zeros(0, np.float32))

    def host_feed(self, n, abs_index):
        if abs_index >= len(self._wave):
            return None
        chunk = self._wave[abs_index:abs_index + n]
        return {"out": chunk}, len(chunk)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("WefaxDecoder")
class WefaxDecoder(SinkBlock):
    """Radiofax receiver sink: analytic-signal discriminator, 300 Hz
    start-tone gate, phasing-pulse alignment, fixed-timebase line slicing
    (the line clock is exact at 60/lpm s — fax receivers free-run on it)
    with per-pixel bin averaging. ``image`` is the live ``[lines, width]``
    uint8 chart."""

    IN = (Port("in", dtype="float32"),)
    sample_rate = Setting(default=11025.0, kind="static")
    lpm = Setting(default=LPM, kind="static")
    width = Setting(default=800, kind="static")
    max_lines = Setting(default=1200, kind="static")
    max_buffer_s = Setting(default=900.0, kind="static",
                           description="history bound (a 1200-line chart "
                                       "is 600 s); the buffer freezes once "
                                       "full")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.float32)
        self._pending = 0
        self._lines: list[np.ndarray] = []
        self.started = False

    @property
    def image(self) -> np.ndarray:
        if not self._lines:
            return np.zeros((0, int(self.settings.get("width"))), np.uint8)
        return np.stack(self._lines)

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        fs = float(self.settings.get("sample_rate"))
        cap = int(float(self.settings.get("max_buffer_s")) * fs)
        if len(self._buf) >= cap:
            return
        x = np.asarray(arrays["in"][..., :n_valid], np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, x])[:cap]
        self._pending += n_valid
        if self._pending >= int(fs):
            self._pending = 0
            self._decode()

    def stop(self):
        self._decode()

    def _decode(self) -> None:
        fs = float(self.settings.get("sample_rate"))
        lpm = float(self.settings.get("lpm"))
        line_n = int(round(60.0 / lpm * fs))
        if len(self._buf) < 2 * line_n:
            return
        freq = instantaneous_frequency(self._buf, fs)
        k = max(1, int(round(0.0005 * fs)))
        if k > 1:
            freq = np.convolve(freq, np.full(k, 1.0 / k), mode="same")
        pos = detect_start_tone(freq, fs)
        if pos is None:
            return
        self.started = True
        # phasing: black pulses (≥2% of a line) on white lines; the LAST
        # pulse start before image content is the line phase origin
        mid = (F_BLACK + F_WHITE) / 2.0
        black = _close_gaps(freq[pos:] < mid, int(0.001 * fs))
        edges = np.flatnonzero(black[1:] & ~black[:-1]) + 1
        pulse_starts = []
        min_w = int(0.6 * PHASE_PULSE_FRAC * line_n)
        max_w = int(3.0 * PHASE_PULSE_FRAC * line_n)
        for e in edges:
            run = e
            while run < len(black) and black[run]:
                run += 1
            if min_w <= run - e <= max_w:
                pulse_starts.append(e)
        if not pulse_starts:
            return
        # consecutive phasing pulses are exactly line_n apart; the first
        # IMAGE line starts one line after the last pulse in that train
        train_end = pulse_starts[0]
        for s in pulse_starts[1:]:
            if abs((s - train_end) - line_n) <= int(0.02 * line_n):
                train_end = s
            else:
                break
        first = pos + train_end + line_n
        width = int(self.settings.get("width"))
        n_scan = line_n
        fpos = np.arange(n_scan) * width / n_scan
        px = fpos.astype(np.int64)
        frac = fpos - px
        keep = (frac >= 0.25) & (frac < 0.75)
        lines: list[np.ndarray] = []
        s = first
        max_lines = int(self.settings.get("max_lines"))
        while s + line_n <= len(freq) and len(lines) < max_lines:
            seg = freq[s:s + line_n]
            # stop tone: the 450 Hz alternation flips black/white twice per
            # cycle at an EXACT rate — count only on-rate flip gaps so noise
            # jitter around mid-scale pixels cannot fake the tone
            hi = seg > mid
            flips = np.flatnonzero(np.diff(hi.astype(np.int8)))
            if len(flips) > 8:
                gaps = np.diff(flips)
                want = fs / (2.0 * STOP_TONE_HZ)
                on_rate = int(np.count_nonzero(np.abs(gaps - want)
                                               < 0.3 * want))
                if on_rate > STOP_TONE_HZ * line_n / fs:
                    break
            sums = np.bincount(px[keep], weights=seg[keep], minlength=width)
            counts = np.maximum(np.bincount(px[keep], minlength=width), 1)
            f_px = sums / counts
            row = (f_px - F_BLACK) / (F_WHITE - F_BLACK) * 255.0
            lines.append(np.clip(np.round(row), 0, 255).astype(np.uint8))
            s += line_n
        if len(lines) > len(self._lines):
            self._lines = lines
