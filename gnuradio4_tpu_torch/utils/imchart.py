"""Terminal (ANSI/Braille) plotting — ≈ reference algorithm ImCanvas.hpp /
ImChart.hpp (the prototype's UI): XY line charts rendered as Unicode braille
dots with axes, tick labels, legends and multiple datasets.

Reference parity (algorithm/include/gnuradio-4.0/algorithm/):
- ``LinearAxisTransform`` / ``LogAxisTransform`` — ImChart.hpp:67-101
- ``optimal_tick_positions``                     — ImChart.hpp:108-124
- chart styles Braille/Bars/Marker               — ImChart.hpp:105,200-202
- ``ImChart.mountain_range`` waterfall           — ImChart.hpp:582-676
- 24-bit colour helpers (RGB/HSV interpolation,
  hex parse/format, ANSI escapes)                — ImCanvas.hpp:27-150
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

_BRAILLE_BASE = 0x2800
# braille dot bit for (col 0-1, row 0-3) within a 2×4 cell
_DOT_BITS = [[0x01, 0x08], [0x02, 0x10], [0x04, 0x20], [0x40, 0x80]]

_COLORS = ["\x1b[36m", "\x1b[33m", "\x1b[35m", "\x1b[32m", "\x1b[31m",
           "\x1b[34m"]
_RESET = "\x1b[0m"

# eighth-block bar glyphs by filled-dot count (≈ ImChart.hpp:200 kBars)
_BARS = (" ", "▁", "▂", "▃", "▄", "▅", "▆", "▇", "█")
# per-dataset point markers (≈ ImChart.hpp:202 kMarker)
_MARKERS = ("X", "O", "★", "+", "❖", "◎", "○", "■", "□")


# --------------------------------------------------------------------------
# 24-bit colour helpers (≈ ImCanvas.hpp:27-150)
# --------------------------------------------------------------------------

def interpolate_rgb(c1, c2, t: float) -> tuple[int, int, int]:
    """Linear RGB interpolation (≈ ImCanvas.hpp:53 interpolateRGB)."""
    t = min(max(float(t), 0.0), 1.0)
    return tuple(int(a + t * (b - a)) for a, b in zip(c1, c2))


def rgb_to_hsv(c) -> tuple[float, float, float]:
    """RGB(0-255) → (h∈[0,360), s∈[0,1], v∈[0,1]) (≈ ImCanvas.hpp:59)."""
    r, g, b = (x / 255.0 for x in c)
    cmax, cmin = max(r, g, b), min(r, g, b)
    diff = cmax - cmin
    h = 0.0
    if diff > 0:
        if cmax == r:
            h = 60.0 * (((g - b) / diff) % 6.0)
        elif cmax == g:
            h = 60.0 * ((b - r) / diff + 2.0)
        else:
            h = 60.0 * ((r - g) / diff + 4.0)
        h %= 360.0
    return h, (diff / cmax if cmax > 0 else 0.0), cmax


def hsv_to_rgb(h: float, s: float, v: float) -> tuple[int, int, int]:
    """(h, s, v) → RGB(0-255) (≈ ImCanvas.hpp:96 hsvToRGB)."""
    h = h % 360.0
    s = min(max(s, 0.0), 1.0)
    v = min(max(v, 0.0), 1.0)
    hn = h / 360.0

    def p(n):
        return min(max(abs(math.modf(hn + n)[0] * 6.0 - 3.0) - 1.0, 0.0), 1.0)

    r = v * ((1.0 - s) + s * p(0.0))
    g = v * ((1.0 - s) + s * p(2.0 / 3.0))
    b = v * ((1.0 - s) + s * p(1.0 / 3.0))
    return tuple(int(min(max(x, 0.0), 1.0) * 255) for x in (r, g, b))


def interpolate_hsv(c1, c2, t: float) -> tuple[int, int, int]:
    """Shortest-hue-path HSV interpolation (≈ ImCanvas.hpp:122)."""
    t = min(max(float(t), 0.0), 1.0)
    h1, s1, v1 = rgb_to_hsv(c1)
    h2, s2, v2 = rgb_to_hsv(c2)
    hdiff = h2 - h1
    if hdiff > 180.0:
        hdiff -= 360.0
    elif hdiff < -180.0:
        hdiff += 360.0
    return hsv_to_rgb((h1 + t * hdiff) % 360.0,
                      s1 + t * (s2 - s1), v1 + t * (v2 - v1))


def to_hex_rgb(c) -> str:
    """(r,g,b) → '#RRGGBB' (≈ ImCanvas.hpp:137 toHexRGB)."""
    return "#{:02X}{:02X}{:02X}".format(*c)


def parse_hex_rgb(s: str) -> tuple[int, int, int] | None:
    """'#RGB' / '#RRGGBB' → (r,g,b) or None (≈ ImCanvas.hpp:150)."""
    s = s.strip()
    if s.startswith("#"):
        s = s[1:]
    try:
        if len(s) == 3:
            return tuple(int(ch * 2, 16) for ch in s)
        if len(s) == 6:
            return tuple(int(s[i:i + 2], 16) for i in (0, 2, 4))
    except ValueError:
        return None
    return None


def ansi_rgb(c, foreground: bool = True) -> str:
    """24-bit ANSI escape (≈ ImCanvas.hpp:48 makeAnsi)."""
    return "\x1b[{};2;{};{};{}m".format(38 if foreground else 48, *c)


def reset_view() -> str:
    """ANSI clear-screen + home (≈ ImChart.hpp:126 resetView)."""
    return "\x1b[2J\x1b[H"


# --------------------------------------------------------------------------
# Axis transforms (≈ ImChart.hpp:67-101) and tick placement (:108-124)
# --------------------------------------------------------------------------

class LinearAxisTransform:
    """value ↔ integer screen coordinate, linear (ImChart.hpp:67)."""

    @staticmethod
    def to_screen(value: float, axis_min: float, axis_max: float,
                  offset: int, size: int) -> int:
        return offset + int((value - axis_min) / (axis_max - axis_min)
                            * (size - offset - 1))

    @staticmethod
    def from_screen(coord: int, axis_min: float, axis_max: float,
                    offset: int, size: int) -> float:
        return axis_min + (coord - offset) / (size - offset - 1) \
            * (axis_max - axis_min)

    @staticmethod
    def proportion(value, axis_min: float, axis_max: float):
        """Continuous [0,1] position (vectorized; internal plotting path)."""
        return (np.asarray(value, np.float64) - axis_min) / (axis_max - axis_min)


class LogAxisTransform:
    """value ↔ screen coordinate, log10 (ImChart.hpp:79); raises ValueError
    on non-positive values/ranges like the reference throws."""

    @staticmethod
    def to_screen(value: float, axis_min: float, axis_max: float,
                  offset: int, size: int) -> int:
        if value <= 0 or axis_min <= 0 or axis_max <= axis_min:
            raise ValueError(
                f"LogAxisTransform not defined for non-positive value {value} "
                f"in [{axis_min}, {axis_max}]")
        log_min = math.log10(axis_min)
        prop = (math.log10(value) - log_min) / (math.log10(axis_max) - log_min)
        return offset + int(prop * (size - offset - 1))

    @staticmethod
    def from_screen(coord: int, axis_min: float, axis_max: float,
                    offset: int, size: int) -> float:
        if axis_min <= 0 or axis_max <= axis_min:
            raise ValueError(f"LogAxisTransform not defined for non-positive "
                             f"ranges [{axis_min}, {axis_max}]")
        prop = (coord - offset) / (size - offset - 1)
        log_min = math.log10(axis_min)
        return 10.0 ** (log_min + prop * (math.log10(axis_max) - log_min))

    @staticmethod
    def proportion(value, axis_min: float, axis_max: float):
        if axis_min <= 0 or axis_max <= axis_min:
            raise ValueError(f"LogAxisTransform not defined for non-positive "
                             f"ranges [{axis_min}, {axis_max}]")
        v = np.asarray(value, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            p = (np.log10(v) - math.log10(axis_min)) \
                / (math.log10(axis_max) - math.log10(axis_min))
        return np.where(v > 0, p, np.nan)


_TRANSFORMS = {"linear": LinearAxisTransform, "log": LogAxisTransform}


def optimal_tick_positions(axis_width: int, min_gap_size: int = 1) -> list[int]:
    """Evenly-spaced tick screen positions including both endpoints
    (≈ ImChart.hpp:108 detail::optimalTickScreenPositions)."""
    if axis_width <= 1:
        return [0] if axis_width == 1 else []
    preferred_divisors = (10, 8, 5, 4, 3, 2)
    reduced = axis_width - 1  # we always require & add the '0'
    segment = reduced
    for d in preferred_divisors:
        if reduced % d == 0 and reduced // d > min_gap_size:
            segment = d if reduced < 10 else reduced // d
            break
    return [i for i in range(axis_width) if i % segment == 0]


# --------------------------------------------------------------------------
# ImCanvas — braille dot canvas with colour + glyph overlays
# --------------------------------------------------------------------------

class ImCanvas:
    """Braille dot canvas: width×height in character cells (2×4 dots each).

    Colours may be palette indices (int) or 24-bit ``(r, g, b)`` tuples
    (≈ ImCanvas.hpp Colour); glyph overlays (``text``) replace whole cells.
    """

    def __init__(self, width: int = 80, height: int = 20):
        self.width = width
        self.height = height
        self._cells = np.zeros((height, width), dtype=np.uint32)
        self._colors = np.zeros((height, width), dtype=np.int8)
        self._rgb: dict[tuple[int, int], tuple[int, int, int]] = {}
        self._texts: dict[tuple[int, int], tuple[str, object]] = {}

    def clear(self) -> None:
        self._cells[:] = 0
        self._colors[:] = 0
        self._rgb.clear()
        self._texts.clear()

    def _store_color(self, row: int, col: int, color) -> None:
        if isinstance(color, tuple):
            self._rgb[(row, col)] = color
            self._colors[row, col] = 1
        else:
            self._colors[row, col] = int(color) + 1

    def dot(self, x: float, y: float, color=0) -> None:
        """Plot a dot in dot-coordinates: x ∈ [0, 2·width), y ∈ [0, 4·height),
        y=0 at the bottom."""
        xi, yi = int(x), int(y)
        if not (0 <= xi < 2 * self.width and 0 <= yi < 4 * self.height):
            return
        row = self.height - 1 - yi // 4
        col = xi // 2
        self._cells[row, col] |= _DOT_BITS[3 - yi % 4][xi % 2]
        self._store_color(row, col, color)

    def line(self, x0: float, y0: float, x1: float, y1: float,
             color=0) -> None:
        """Dot-resolution line segment (interpolated; ≈ ImCanvas drawLine)."""
        steps = max(1, int(abs(x1 - x0)), int(abs(y1 - y0)))
        for s in range(steps + 1):
            t = s / steps
            self.dot(x0 + t * (x1 - x0), y0 + t * (y1 - y0), color)

    def hline(self, y: float, color=0) -> None:
        self.line(0, y, 2 * self.width - 1, y, color)

    def vline(self, x: float, color=0) -> None:
        self.line(x, 0, x, 4 * self.height - 1, color)

    def text(self, row: int, col: int, s: str, color=None) -> None:
        """Character-cell text overlay (≈ ImCanvas drawText); overwrites dots."""
        for i, ch in enumerate(s):
            if 0 <= row < self.height and 0 <= col + i < self.width:
                self._texts[(row, col + i)] = (ch, color)

    def _ansi(self, color) -> str:
        if isinstance(color, tuple):
            return ansi_rgb(color)
        return _COLORS[int(color) % len(_COLORS)]

    def render(self, *, color: bool = True) -> str:
        lines = []
        for r in range(self.height):
            chars = []
            for c in range(self.width):
                if (r, c) in self._texts:
                    ch, tcol = self._texts[(r, c)]
                    if color and tcol is not None:
                        ch = self._ansi(tcol) + ch + _RESET
                    chars.append(ch)
                    continue
                bits = int(self._cells[r, c])
                ch = chr(_BRAILLE_BASE + bits) if bits else " "
                if color and bits and self._colors[r, c] > 0:
                    col = self._rgb.get((r, c), int(self._colors[r, c]) - 1)
                    ch = self._ansi(col) + ch + _RESET
                chars.append(ch)
            lines.append("".join(chars))
        return "\n".join(lines)


def _nice_num(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e4 or abs(v) < 1e-3:
        return f"{v:.2e}"
    return f"{v:.4g}"


# --------------------------------------------------------------------------
# ImChart — XY chart with axes, ticks, legends, styles, waterfall
# --------------------------------------------------------------------------

class ImChart:
    """XY chart over an ImCanvas with axes + legends (≈ ImChart.hpp:190).

    ``bounds=((xmin, xmax), (ymin, ymax))`` fixes the axis ranges (≈ the
    reference's boundary constructor, ImChart.hpp:151); either pair may be
    None for auto.  ``x_transform``/``y_transform`` ∈ {'linear', 'log'}
    select the axis transforms (≈ LogAxisTransform template parameter).
    """

    def __init__(self, width: int = 80, height: int = 16, *,
                 x_label: str = "", y_label: str = "",
                 bounds=None, x_transform: str = "linear",
                 y_transform: str = "linear"):
        self.canvas = ImCanvas(width, height)
        self.x_label = x_label
        self.y_label = y_label
        self.datasets: list[tuple[str, np.ndarray, np.ndarray, str]] = []
        self._bounds_x = None
        self._bounds_y = None
        if bounds is not None:
            bx, by = bounds
            self._bounds_x = (float(bx[0]), float(bx[1])) if bx else None
            self._bounds_y = (float(by[0]), float(by[1])) if by else None
        self._tx = _TRANSFORMS[x_transform] if isinstance(x_transform, str) \
            else x_transform
        self._ty = _TRANSFORMS[y_transform] if isinstance(y_transform, str) \
            else y_transform

    def plot(self, y: Sequence[float], x: Sequence[float] | None = None,
             label: str = "", style: str = "line") -> "ImChart":
        """Add a dataset. ``style``: 'line' (interpolated braille), 'points'
        (scatter — constellations), 'bars' (eighth-block bars filled toward
        the x-axis, ≈ Style::Bars), 'marker' (per-dataset glyph from the
        reference's kMarker table, ≈ Style::Marker)."""
        if style not in ("line", "points", "bars", "marker"):
            raise ValueError(f"unknown style {style!r}")
        y = np.asarray(y, dtype=np.float64).ravel()
        x = np.arange(len(y), dtype=np.float64) if x is None \
            else np.asarray(x, dtype=np.float64).ravel()
        self.datasets.append((label, x, y, style))
        return self

    def mountain_range(self, traces, x: Sequence[float] | None = None, *,
                       base_label: str = "trace", x_offset_chars: int = 2,
                       y_offset_chars: int = 2,
                       style: str = "line") -> "ImChart":
        """Waterfall of traces offset diagonally, oldest in the background
        (≈ ImChart.hpp:582 drawMountainRange): trace[0] is the newest/front
        trace; trace[i] is drawn shifted up-right by ``i`` offsets."""
        traces = [np.asarray(t, dtype=np.float64).ravel() for t in traces]
        if not traces:
            return self
        n = len(traces)
        x = np.arange(len(traces[0]), dtype=np.float64) if x is None \
            else np.asarray(x, dtype=np.float64).ravel()
        dminx, dmaxx = float(np.min(x)), float(np.max(x))
        dminy = min(float(np.min(t)) for t in traces)
        dmaxy = max(float(np.max(t)) for t in traces)
        range_x = (dmaxx - dminx) or 1.0
        range_y = (dmaxy - dminy) or 1.0
        per_char_x = range_x / self.canvas.width
        per_char_y = range_y / self.canvas.height
        if self._bounds_x is None:
            self._bounds_x = (dminx,
                              dmaxx + x_offset_chars * (n - 1) * per_char_x)
        if self._bounds_y is None:
            pad = 0.05 * range_y
            self._bounds_y = (dminy - pad, dmaxy + pad
                              + y_offset_chars * (n - 1) * per_char_y)
        x_off = x_offset_chars * (self._bounds_x[1] - self._bounds_x[0]) \
            / self.canvas.width
        y_off = y_offset_chars * (self._bounds_y[1] - self._bounds_y[0]) \
            / self.canvas.height
        # oldest (largest index) first so the newest draws on top
        for i in reversed(range(n)):
            self.plot(traces[i] + i * y_off, x + i * x_off,
                      label=f"{base_label}[{i}]", style=style)
        return self

    def vmarker(self, x: float, label: str = "") -> "ImChart":
        """Vertical marker line at data-x (trigger/frequency markers)."""
        if not hasattr(self, "_vmarkers"):
            self._vmarkers: list[tuple[float, str]] = []
        self._vmarkers.append((float(x), label))
        return self

    def hmarker(self, y: float, label: str = "") -> "ImChart":
        """Horizontal marker line at data-y (thresholds)."""
        if not hasattr(self, "_hmarkers"):
            self._hmarkers: list[tuple[float, str]] = []
        self._hmarkers.append((float(y), label))
        return self

    # -- internal ---------------------------------------------------------

    def _resolve_bounds(self):
        all_x = np.concatenate([d[1] for d in self.datasets]) \
            if self.datasets else np.zeros(1)
        all_y = np.concatenate([d[2] for d in self.datasets]) \
            if self.datasets else np.zeros(1)
        fin = np.isfinite(all_y)
        if self._bounds_x is not None:
            x0, x1 = self._bounds_x
        else:
            x0, x1 = float(np.min(all_x)), float(np.max(all_x))
        if self._bounds_y is not None:
            y0, y1 = self._bounds_y
        else:
            y0 = float(np.min(all_y[fin])) if fin.any() else 0.0
            y1 = float(np.max(all_y[fin])) if fin.any() else 1.0
            for ym, _ in getattr(self, "_hmarkers", ()):
                y0, y1 = min(y0, ym), max(y1, ym)
        if x1 == x0:
            x1 = x0 + 1
        if y1 == y0:
            y1 = y0 + 1
        return x0, x1, y0, y1

    def render(self, *, color: bool = True, y_ticks: int = 3,
               x_ticks: bool = True) -> str:
        if not self.datasets:
            return "(empty chart)"
        self.canvas.clear()
        x0, x1, y0, y1 = self._resolve_bounds()
        w_dots = 2 * self.canvas.width
        h_dots = 4 * self.canvas.height

        def sx(x):
            return self._tx.proportion(x, x0, x1) * (w_dots - 1)

        def sy(y):
            return self._ty.proportion(y, y0, y1) * (h_dots - 1)

        # x-axis row (bars fill toward y=0 if visible, else the bottom)
        base_y = max(y0, min(0.0, y1)) if y0 <= 0.0 <= y1 else y0
        base_dots = float(sy(base_y))

        for ci, (_, x, y, style) in enumerate(self.datasets):
            px, py = np.asarray(sx(x)), np.asarray(sy(y))
            ok = np.isfinite(px) & np.isfinite(py)
            if style == "points":
                for i in np.nonzero(ok)[0]:
                    self.canvas.dot(px[i], py[i], ci)
            elif style == "marker":
                glyph = _MARKERS[ci % len(_MARKERS)]
                for i in np.nonzero(ok)[0]:
                    col = int(px[i]) // 2
                    row = self.canvas.height - 1 - int(py[i]) // 4
                    if 0 <= row < self.canvas.height \
                            and 0 <= col < self.canvas.width:
                        self.canvas.text(row, col, glyph,
                                         color=ci if color else None)
            elif style == "bars":
                for i in np.nonzero(ok)[0]:
                    col = int(px[i]) // 2
                    if not (0 <= col < self.canvas.width):
                        continue
                    lo, hi = sorted((float(py[i]), base_dots))
                    lo_i, hi_i = int(round(lo)), int(round(hi))
                    # whole cells solid, the topmost partial cell gets the
                    # eighth-block glyph by filled-dot count (kBars analog)
                    cell_lo = max(0, lo_i) // 4
                    cell_hi = min(h_dots - 1, hi_i) // 4
                    for cell in range(cell_lo, cell_hi + 1):
                        row = self.canvas.height - 1 - cell
                        filled = min(hi_i, cell * 4 + 3) \
                            - max(lo_i, cell * 4) + 1
                        if filled >= 4:
                            glyph = _BARS[8]
                        else:
                            glyph = _BARS[max(1, 2 * filled)]
                        self.canvas.text(row, col, glyph,
                                         color=ci if color else None)
            else:
                for i in range(len(px) - 1):
                    if not (ok[i] and ok[i + 1]):
                        continue
                    self.canvas.line(px[i], py[i], px[i + 1], py[i + 1], ci)
        marker_color = len(self.datasets)
        for xm, _ in getattr(self, "_vmarkers", ()):
            self.canvas.vline(float(sx(xm)), marker_color)
        for ym, _ in getattr(self, "_hmarkers", ()):
            self.canvas.hline(float(sy(ym)), marker_color)
        body = self.canvas.render(color=color)
        # axes annotation with intermediate ticks (≈ ImChart drawAxes)
        lines = body.split("\n")
        n_rows = len(lines)
        tick_rows = {0: y1, n_rows - 1: y0}
        for k in range(1, max(0, y_ticks - 1)):
            r = round(k * (n_rows - 1) / max(1, y_ticks - 1))
            tick_rows.setdefault(
                r, self._ty.from_screen(n_rows - 1 - r, y0, y1, 0, n_rows))
        out = []
        for i, ln in enumerate(lines):
            if i in tick_rows:
                prefix = f"{_nice_num(tick_rows[i]):>10s} ┤"
            else:
                prefix = " " * 11 + "│"
            out.append(prefix + ln)
        # x axis with optimally-divided tick positions (optimalTick…)
        width = self.canvas.width
        axis = ["─"] * width
        tick_cols = optimal_tick_positions(width) if x_ticks else []
        label_row = [" "] * width
        for tc in tick_cols:
            axis[tc] = "┴" if 0 < tc < width - 1 else axis[tc]
            tv = self._tx.from_screen(tc, x0, x1, 0, width)
            lbl = _nice_num(tv)
            start = min(max(0, tc - len(lbl) // 2), max(0, width - len(lbl)))
            for i, ch in enumerate(lbl):
                if start + i < width:
                    label_row[start + i] = ch
        out.append(" " * 11 + "└" + "".join(axis))
        out.append(" " * 12 + "".join(label_row).rstrip())
        legend = "   ".join(
            (_COLORS[i % len(_COLORS)] if color else "") + "⣿ " + (lbl or f"set{i}")
            + (_RESET if color else "")
            for i, (lbl, _, _, _) in enumerate(self.datasets))
        if any(d[0] for d in self.datasets):
            out.append(" " * 12 + legend)
        if self.x_label:
            out.append(" " * 12 + self.x_label)
        return "\n".join(out)


def quick_plot(y, x=None, *, width=78, height=14, label="", color=False) -> str:
    return ImChart(width, height).plot(y, x, label=label).render(color=color)
