"""NOAA APT weather-satellite imagery (Automatic Picture Transmission).

Beyond-reference model family (GNU Radio users reach for noaa-apt/wxtoimg):
APT is an analog image format — two 909-pixel video channels per 0.5 s line
at 4160 words/s, each line led by a 1040 Hz sync-A square burst, the
luminance AM-modulated (0.05..0.95) onto a 2400 Hz subcarrier which rides the
FM downlink. After FM demodulation the chain is: coherent envelope detector
(heterodyne at 2400 Hz + lowpass + magnitude), decimate to 4160 words/s,
correlate the sync-A template to find line starts, slice the image matrix.

:class:`AptDecoder` is the host-side line layer over an audio/MPX stream;
:func:`apt_modulate` synthesizes a transmission from an image for tests and
simulation.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock
from ..core.registry import register_block
from ..core.settings import Setting

WORD_RATE = 4160.0
LINE_WORDS = 2080                        # 0.5 s per line
IMAGE_A = slice(86, 86 + 909)            # video channel A within the line

# sync A: 4 quiet words, then 7 cycles of a 1040 Hz square (2 on / 2 off)
SYNC_A = np.array([0, 0, 0, 0] + [1, 1, 0, 0] * 7 + [0] * 7, np.float32)


def _line_template(image_row: np.ndarray) -> np.ndarray:
    """One 2080-word APT line: sync A + space + video A + filler."""
    line = np.zeros(LINE_WORDS, np.float32)
    line[:39] = SYNC_A
    row = np.asarray(image_row, np.float32)
    if len(row) != 909:
        raise ValueError("APT video rows are 909 pixels")
    line[IMAGE_A] = row
    # channel B carries the same row dimmed (stand-in for the IR channel)
    line[1040 + 86:1040 + 86 + 909] = 0.5 * row
    return line


def apt_modulate(image: np.ndarray, *, fs: float = 20800.0,
                 subcarrier_hz: float = 2400.0) -> np.ndarray:
    """Synthesize APT audio from an image (rows × 909, values 0..1)."""
    sps = fs / WORD_RATE
    if abs(sps - round(sps)) > 1e-9:
        raise ValueError("fs must be an integer multiple of 4160 Hz")
    words = np.concatenate([_line_template(r) for r in np.asarray(image)])
    lum = np.repeat(words, int(round(sps)))
    n = np.arange(len(lum), dtype=np.float64)
    carrier = np.sin(2 * np.pi * subcarrier_hz / fs * n)
    return ((0.05 + 0.9 * lum) * carrier).astype(np.float32)


def apt_envelope(audio: np.ndarray, *, fs: float = 20800.0,
                 subcarrier_hz: float = 2400.0) -> np.ndarray:
    """Coherent AM envelope at 4160 words/s (heterodyne + boxcar + |·|·2)."""
    from ..ops.filter_design import design_fir
    x = np.asarray(audio, np.float64)
    n = np.arange(len(x))
    z = x * np.exp(-2j * np.pi * subcarrier_hz / fs * n)
    # designed lowpass (cutoff at the word rate/2): a word-width boxcar lets
    # the 2·subcarrier image through and ripples the video
    lp = design_fir("lowpass", 31, sample_rate=fs, f_low=WORD_RATE / 2)
    z = np.convolve(z, lp, mode="same")
    env = 2.0 * np.abs(z)
    k = int(round(fs / WORD_RATE))
    return env[k // 2::k][:len(x) // k].astype(np.float32)


def find_sync_offsets(words: np.ndarray) -> list[int]:
    """Line starts via normalized correlation against the sync-A template."""
    tpl = (SYNC_A - SYNC_A.mean()).astype(np.float64)
    tpl /= np.linalg.norm(tpl)
    x = np.asarray(words, np.float64)
    if len(x) < len(tpl) + LINE_WORDS:
        return []
    corr = np.correlate(x - x.mean(), tpl, mode="valid")
    offsets = []
    pos = int(np.argmax(corr[:LINE_WORDS]))
    while pos + LINE_WORDS <= len(x):
        offsets.append(pos)
        # re-peak inside a small window around the expected next line start
        nxt = pos + LINE_WORDS
        lo, hi = max(nxt - 8, 0), min(nxt + 9, len(corr))
        if lo >= hi:
            break
        pos = lo + int(np.argmax(corr[lo:hi]))
    return offsets


def decode_image(words: np.ndarray) -> np.ndarray:
    """[rows, 909] video-A luminance (0..1) from a 4160 words/s stream."""
    offs = find_sync_offsets(words)
    rows = [np.asarray(words[o:o + LINE_WORDS], np.float32)[IMAGE_A]
            for o in offs]
    if not rows:
        return np.zeros((0, 909), np.float32)
    img = np.stack(rows)
    lo, hi = np.percentile(img, 1), np.percentile(img, 99)
    return np.clip((img - lo) / max(hi - lo, 1e-9), 0.0, 1.0)


@register_block("AptDecoder")
class AptDecoder(SinkBlock):
    """APT image decoder sink for FM-demodulated satellite audio.

    ``image`` is the decoded [rows, 909] video-A matrix (0..1), refreshed as
    lines arrive."""

    IN = (Port("in", dtype="float32"),)
    sample_rate_in = Setting(default=20800.0, kind="static", unit="Hz")
    max_lines = Setting(default=2000, kind="static",
                        description="history bound (≈ one 16 min pass)")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._audio = np.zeros(0, np.float64)
        self.image = np.zeros((0, 909), np.float32)

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.real(np.asarray(arrays["in"][..., :n_valid])).reshape(-1)
        self._audio = np.concatenate([self._audio, x.astype(np.float64)])
        fs = float(self.settings.get("sample_rate_in"))
        cap = int(int(self.settings.get("max_lines")) * 0.5 * fs)
        if len(self._audio) > cap:
            self._audio = self._audio[-cap:]
        if len(self._audio) >= 3 * 0.5 * fs:        # ≥ 3 lines buffered
            self._decode(fs)

    def stop(self):
        fs = float(self.settings.get("sample_rate_in"))
        if len(self._audio):
            self._decode(fs)

    def _decode(self, fs: float) -> None:
        words = apt_envelope(self._audio, fs=fs)
        self.image = decode_image(words)
