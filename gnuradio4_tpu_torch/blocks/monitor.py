"""ImChartMonitor — live terminal scope sink (≈ reference blocks/testing/
ImChartMonitor.hpp): renders incoming samples as a braille chart every
``refresh_every`` steps."""

from __future__ import annotations

import sys

import numpy as np

from ..core.block import Port, SinkBlock, UICategory
from ..core.registry import register_block
from ..core.settings import Setting
from ..utils.history import HistoryBuffer
from ..utils.imchart import ImChart


@register_block("ImChartMonitor")
class ImChartMonitor(SinkBlock):
    IN = (Port("in"),)
    UI_CATEGORY = UICategory.CONTENT
    window = Setting(default=2048, kind="static", limits=(16, 1 << 22))
    refresh_every = Setting(default=8, kind="static", limits=(1, 1 << 20))
    width = Setting(default=78, kind="static")
    height = Setting(default=14, kind="static")
    color = Setting(default=True, kind="static")
    stream = Setting(default="stderr", kind="static", choices=("stderr", "stdout",
                                                               "none"))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._hist = HistoryBuffer(int(self.settings.get("window")),
                                   newest_first=False)
        self._n_consumed = 0
        self._renders = 0
        self.last_render = ""

    def consume(self, arrays, tags, n_valid, abs_index):
        x = arrays["in"][..., :n_valid]
        if x.ndim > 1:
            x = x[0]
        if np.iscomplexobj(x):
            x = np.abs(x)
        self._hist.push(x)
        self._n_consumed += 1
        if self._n_consumed % int(self.settings.get("refresh_every")):
            return
        chart = ImChart(int(self.settings.get("width")),
                        int(self.settings.get("height")))
        chart.plot(self._hist.view(), label=self.name)
        self.last_render = chart.render(color=bool(self.settings.get("color")))
        self._renders += 1
        dest = self.settings.get("stream")
        if dest == "stderr":
            print("\x1b[2J\x1b[H" + self.last_render, file=sys.stderr)
        elif dest == "stdout":
            print(self.last_render)

    def draw(self, config=None):
        """Drawable protocol: render the current history on demand."""
        if len(self._hist.view()) == 0:
            return None  # nothing consumed yet (e.g. dashboard's first frame)
        chart = ImChart(int(self.settings.get("width")),
                        int(self.settings.get("height")))
        chart.plot(self._hist.view(), label=self.name)
        self.last_render = chart.render(
            color=bool((config or {}).get("color",
                                          self.settings.get("color"))))
        return self.last_render


@register_block("WaterfallMonitor")
class WaterfallMonitor(SinkBlock):
    """Scrolling spectrogram sink for the terminal / ``run --draw`` dashboard
    (beyond the reference's ImChartMonitor — the classic SDR waterfall).

    Consumes raw samples, FFTs ``fft_size`` windows host-side, keeps the last
    ``rows`` spectra, and renders them as intensity rows (ANSI 256-color
    background or a plain ASCII ramp), newest at the bottom. Complex input
    renders the full fft-shifted band; real input the positive half.
    """

    IN = (Port("in"),)
    UI_CATEGORY = UICategory.CONTENT
    fft_size = Setting(default=256, kind="static", limits=(16, 1 << 16))
    rows = Setting(default=18, kind="static", limits=(2, 512))
    width = Setting(default=78, kind="static", limits=(8, 512))
    db_range = Setting(default=60.0, kind="static",
                       description="dynamic range below the peak, dB")
    color = Setting(default=True, kind="static")

    _RAMP = " .:-=+*#%@"

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._rows: list[np.ndarray] = []
        self._carry = np.zeros(0)
        self.last_render = ""

    def consume(self, arrays, tags, n_valid, abs_index):
        x = arrays["in"][..., :n_valid]
        if x.ndim > 1:
            x = x[0]
        nfft = int(self.settings.get("fft_size"))
        buf = np.concatenate([self._carry, np.asarray(x)])
        nwin = len(buf) // nfft
        max_rows = int(self.settings.get("rows"))
        for w in range(nwin):
            seg = buf[w * nfft:(w + 1) * nfft] * np.hanning(nfft)
            if np.iscomplexobj(seg):
                spec = np.fft.fftshift(np.abs(np.fft.fft(seg)))
            else:
                spec = np.abs(np.fft.rfft(seg))
            self._rows.append(20.0 * np.log10(spec + 1e-12))
        self._carry = buf[nwin * nfft:]
        if len(self._rows) > max_rows:
            self._rows = self._rows[-max_rows:]

    def draw(self, config=None):
        if not self._rows:
            return None
        width = int(self.settings.get("width"))
        rng = float(self.settings.get("db_range"))
        use_color = bool((config or {}).get(
            "color", self.settings.get("color")))
        mat = np.stack(self._rows)
        # resample bins to the display width
        idx = np.linspace(0, mat.shape[1] - 1, width).round().astype(int)
        mat = mat[:, idx]
        top = float(mat.max())
        norm = np.clip((mat - (top - rng)) / rng, 0.0, 1.0)
        lines = []
        for row in norm:
            if use_color:
                # 256-color grayscale background ramp (232..255)
                cells = (232 + row * 23).astype(int)
                line, prev = [], -1
                for c in cells:
                    if c != prev:
                        line.append(f"\x1b[48;5;{c}m")
                        prev = c
                    line.append(" ")
                line.append("\x1b[0m")
                lines.append("".join(line))
            else:
                ramp = (row * (len(self._RAMP) - 1)).astype(int)
                lines.append("".join(self._RAMP[i] for i in ramp))
        lines.append(f"{self.name}: {len(self._rows)} x "
                     f"{int(self.settings.get('fft_size'))}-pt spectra, "
                     f"top {top:.1f} dB, range {rng:.0f} dB")
        self.last_render = "\n".join(lines)
        return self.last_render
