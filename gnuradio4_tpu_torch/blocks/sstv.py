"""SSTV (slow-scan television) model family — Martin M1 mode.

Amateur-radio image transmission as an FM audio signal: pixel luminance maps
linearly to tone frequency (1500 Hz black → 2300 Hz white), each image line
carries a 1200 Hz sync pulse and the three G/B/R colour scans, and the
transmission opens with the calibration header + 7-bit VIS mode code (1100 Hz
= '1', 1300 Hz = '0', even parity). Martin M1 geometry (the classic 320-wide
mode): 4.862 ms sync, 0.572 ms porches, 146.432 ms per colour scan.

Device/host split (the APT pattern, blocks/apt.py): waveform synthesis is
vectorized math (phase-continuous FM over a per-sample frequency timeline);
the receiver consumes an FM-discriminator/instantaneous-frequency stream and
does O(lines) host work — sync-run detection, line slicing, per-pixel bin
averaging — in the :class:`SstvDecoder` sink with a live image property.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting

# Martin M1 timing (seconds) and tones (Hz)
SYNC_S = 0.004862
PORCH_S = 0.000572
SCAN_S = 0.146432
WIDTH = 320
F_SYNC = 1200.0
F_PORCH = 1500.0
F_BLACK = 1500.0
F_WHITE = 2300.0
VIS_MARTIN_M1 = 44
_VIS_BIT_S = 0.030
_LEADER_S = 0.300
_BREAK_S = 0.010


def _pixel_freq(values: np.ndarray) -> np.ndarray:
    v = np.clip(np.asarray(values, np.float64), 0.0, 255.0)
    return F_BLACK + (F_WHITE - F_BLACK) * v / 255.0


def vis_header_freqs(fs: float, vis: int = VIS_MARTIN_M1) -> np.ndarray:
    """Calibration header + VIS code as a frequency timeline."""
    segs: list[tuple[float, float]] = [
        (1900.0, _LEADER_S), (F_SYNC, _BREAK_S), (1900.0, _LEADER_S),
        (F_SYNC, _VIS_BIT_S),                      # start bit
    ]
    ones = 0
    for b in range(7):
        bit = (vis >> b) & 1
        ones += bit
        segs.append((1100.0 if bit else 1300.0, _VIS_BIT_S))
    segs.append((1100.0 if ones & 1 else 1300.0, _VIS_BIT_S))  # even parity
    segs.append((F_SYNC, _VIS_BIT_S))              # stop bit
    out = []
    for f, dur in segs:
        out.append(np.full(int(round(dur * fs)), f))
    return np.concatenate(out)


def line_freqs(rgb_line: np.ndarray, fs: float) -> np.ndarray:
    """One Martin M1 line: sync + porch + G/B/R scans with separators."""
    parts = [np.full(int(round(SYNC_S * fs)), F_SYNC),
             np.full(int(round(PORCH_S * fs)), F_PORCH)]
    n_scan = int(round(SCAN_S * fs))
    px = (np.arange(n_scan) * WIDTH / n_scan).astype(np.int64)
    for ch in (1, 2, 0):                           # G, B, R channel order
        parts.append(_pixel_freq(rgb_line[:, ch])[px])
        parts.append(np.full(int(round(PORCH_S * fs)), F_PORCH))
    return np.concatenate(parts)


def sstv_modulate(image: np.ndarray, *, fs: float = 48000.0,
                  amplitude: float = 0.8, vis: bool = True) -> np.ndarray:
    """Phase-continuous Martin M1 audio for an ``[H, 320, 3]`` uint8 image."""
    image = np.asarray(image)
    if image.ndim == 2:                            # grayscale → RGB
        image = np.repeat(image[..., None], 3, axis=-1)
    freqs = [vis_header_freqs(fs)] if vis else []
    for row in image:
        freqs.append(line_freqs(row, fs))
    f = np.concatenate(freqs)
    phase = 2.0 * np.pi * np.cumsum(f) / fs
    return (amplitude * np.sin(phase)).astype(np.float32)


def instantaneous_frequency(audio: np.ndarray, fs: float) -> np.ndarray:
    """Analytic-signal discriminator (host): f[n] from the phase advance of
    the Hilbert analytic signal — the audio-domain equivalent of an in-graph
    QuadratureDemod on IQ."""
    x = np.asarray(audio, np.float64)
    n = len(x)
    spec = np.fft.fft(x)
    h = np.zeros(n)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    a = np.fft.ifft(spec * h)
    dphi = np.angle(a[1:] * np.conj(a[:-1]))
    f = dphi * fs / (2.0 * np.pi)
    return np.concatenate([f[:1], f])


def _close_gaps(mask: np.ndarray, n: int) -> np.ndarray:
    """Fill False-runs shorter than ``n`` between True samples — noise
    outliers in the discriminator must not split a timing run in two."""
    if n <= 1 or not mask.any():
        return mask
    out = mask.copy()
    idx = np.flatnonzero(mask)
    gaps = np.diff(idx)
    for k in np.flatnonzero((gaps > 1) & (gaps <= n)):
        out[idx[k] + 1: idx[k + 1]] = True
    return out


def decode_vis(freq: np.ndarray, fs: float) -> tuple[int | None, int]:
    """Find + decode the VIS code; returns (vis or None, sample index just
    after the stop bit — the start of the first line)."""
    bit_n = int(round(_VIS_BIT_S * fs))
    # the start bit is the first 25-40 ms run INSIDE the 1200 Hz band (the
    # 1100 Hz '1' bits and 1300 Hz '0' bits sit outside ±60 Hz, so the run
    # ends exactly at the first data bit)
    low = _close_gaps(np.abs(freq - F_SYNC) < 60.0, int(0.002 * fs))
    i = 0
    n = len(freq)
    while i < n:
        if low[i]:
            j = i
            while j < n and low[j]:
                j += 1
            if j - i >= int(0.025 * fs) and j - i <= int(0.040 * fs):
                start = i
                bits = []
                for k in range(8):                 # 7 data + parity
                    lo = start + bit_n + k * bit_n
                    seg = freq[lo + bit_n // 4: lo + 3 * bit_n // 4]
                    if not len(seg):
                        return None, 0
                    bits.append(1 if np.median(seg) < 1200.0 else 0)
                if sum(bits) & 1:
                    return None, 0                 # even parity violated
                vis = sum(b << k for k, b in enumerate(bits[:7]))
                return vis, start + 10 * bit_n
            i = j
        else:
            i += 1
    return None, 0


@register_block("SstvSource")
class SstvSource(SourceBlock):
    """Plays the Martin M1 audio for an image (test stimulus / TX)."""

    OUT = (Port("out", dtype="float32"),)
    FEED = True
    sample_rate = Setting(default=48000.0, kind="static")

    def __init__(self, image=None, name=None, **settings):
        super().__init__(name=name, **settings)
        fs = float(self.settings.get("sample_rate"))
        self._wave = (sstv_modulate(np.asarray(image), fs=fs)
                      if image is not None else np.zeros(0, np.float32))

    def host_feed(self, n, abs_index):
        if abs_index >= len(self._wave):
            return None
        chunk = self._wave[abs_index:abs_index + n]
        return {"out": chunk}, len(chunk)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("SstvDecoder")
class SstvDecoder(SinkBlock):
    """Martin M1 receiver sink for an audio stream: analytic-signal
    discriminator, VIS decode, 1200 Hz sync-run line slicing, per-pixel bin
    averaging back to an ``[n_lines, 320, 3]`` uint8 image (``image``
    property; ``vis`` carries the decoded mode code)."""

    IN = (Port("in", dtype="float32"),)
    sample_rate = Setting(default=48000.0, kind="static")
    max_lines = Setting(default=256, kind="static")
    max_buffer_s = Setting(default=300.0, kind="static",
                           description="history bound (a full Martin M1 "
                                       "frame is ~114 s); the buffer freezes "
                                       "once full — one transmission is "
                                       "bounded by construction")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.float32)
        self.vis: int | None = None
        self._lines: list[np.ndarray] = []
        self._pending = 0

    @property
    def image(self) -> np.ndarray:
        if not self._lines:
            return np.zeros((0, WIDTH, 3), np.uint8)
        return np.stack(self._lines)

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        cap = int(float(self.settings.get("max_buffer_s"))
                  * float(self.settings.get("sample_rate")))
        if len(self._buf) >= cap:
            return
        x = np.asarray(arrays["in"][..., :n_valid], np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, x])[:cap]
        self._pending += n_valid
        fs = float(self.settings.get("sample_rate"))
        if self._pending >= int(fs):               # re-decode every ~second
            self._pending = 0
            self._decode()

    def stop(self):
        self._decode()

    def _decode(self) -> None:
        fs = float(self.settings.get("sample_rate"))
        if len(self._buf) < fs * 0.8:
            return
        freq = instantaneous_frequency(self._buf, fs)
        # two smoothing scales: timing features (4.86 ms syncs, 30 ms VIS
        # bits) tolerate a ~1.5 ms average that irons out discriminator
        # jitter under channel noise; pixel extraction (0.458 ms/px) reads
        # the raw discriminator and averages inside each pixel bin instead
        k = max(1, int(round(0.0015 * fs)))
        det = (np.convolve(freq, np.full(k, 1.0 / k), mode="same")
               if k > 1 else freq)
        kp = max(1, int(round(0.0003 * fs)))      # < one pixel period
        if kp > 1:
            freq = np.convolve(freq, np.full(kp, 1.0 / kp), mode="same")
        vis, pos = decode_vis(det, fs)
        if vis is not None:
            self.vis = vis
        # sync pulses: sync_n-length runs below 1350 Hz after the header.
        # The VIS stop bit (1200 Hz) runs straight into line 1's sync, so the
        # first line's edge is swallowed — decode_vis's end position IS the
        # first line start; a stream with no header starts low at sample 0.
        low = _close_gaps(det < 1350.0, int(0.001 * fs))
        edges = np.flatnonzero(low[1:] & ~low[:-1]) + 1
        head = [pos] if vis is not None else ([0] if low[0] else [])
        edges = np.concatenate([np.asarray(head, np.int64), edges])
        sync_n = int(round(SYNC_S * fs))
        line_n = (sync_n + int(round(PORCH_S * fs))
                  + 3 * (int(round(SCAN_S * fs)) + int(round(PORCH_S * fs))))
        starts = []
        for e in edges:
            if e < pos:
                continue
            run = e
            while run < len(freq) and low[run]:
                run += 1
            if int(0.7 * sync_n) <= run - e <= int(2.0 * sync_n) \
                    or e == pos:
                # lines are exactly line_n apart — a "sync" inside the
                # previous line's scan region is a noise artefact
                if not starts or e - starts[-1] >= int(0.9 * line_n):
                    starts.append(e)
        lines: list[np.ndarray] = []
        n_scan = int(round(SCAN_S * fs))
        porch_n = int(round(PORCH_S * fs))
        for s in starts[:int(self.settings.get("max_lines"))]:
            if s + line_n - porch_n > len(freq):
                break                              # incomplete line: wait
            base = s + sync_n + porch_n
            rgb = np.zeros((WIDTH, 3), np.float64)
            for slot, ch in enumerate((1, 2, 0)):  # G, B, R slots
                lo = base + slot * (n_scan + porch_n)
                seg = freq[lo:lo + n_scan]
                if len(seg) < n_scan:
                    seg = np.pad(seg, (0, n_scan - len(seg)), mode="edge")
                fpos = np.arange(n_scan) * WIDTH / n_scan
                px = fpos.astype(np.int64)
                frac = fpos - px
                # average only each pixel's central samples — the FM
                # discriminator rings at pixel transitions
                keep = (frac >= 0.25) & (frac < 0.75)
                sums = np.bincount(px[keep], weights=seg[keep],
                                   minlength=WIDTH)
                counts = np.maximum(np.bincount(px[keep], minlength=WIDTH), 1)
                f_px = sums / counts
                rgb[:, ch] = (f_px - F_BLACK) / (F_WHITE - F_BLACK) * 255.0
            lines.append(np.clip(np.round(rgb), 0, 255).astype(np.uint8))
        if len(lines) > len(self._lines):
            self._lines = lines
