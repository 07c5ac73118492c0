"""The port's ``utils/imchart.py``, ``utils/history.py`` and
``blocks/monitor.py`` against the JAX package's, on the CPU.

Every case of ``tests/test_imchart_golden.py`` runs on the port's module,
and each case that renders (or computes ticks, colours or bounds) also runs
on the JAX package's module and must give the same result byte for byte; so
do the monitor cases of ``tests/test_core_foundations.py`` (the Drawable
protocol, ImChart styles) through both packages' schedulers, WaterfallMonitor
and HistoryBuffer. Tolerance: none — host code, compared exactly.
"""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.utils import imchart as jim
from gnuradio4_tpu.utils.history import HistoryBuffer as JHistory
from gnuradio4_tpu_torch.utils import imchart as tim
from gnuradio4_tpu_torch.utils.history import HistoryBuffer as THistory
from gnuradio4_tpu_torch.utils.imchart import (
    ImCanvas, ImChart, LinearAxisTransform, LogAxisTransform,
    optimal_tick_positions, interpolate_rgb, interpolate_hsv, rgb_to_hsv,
    hsv_to_rgb, to_hex_rgb, parse_hex_rgb, ansi_rgb, quick_plot)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _same(fn):
    """fn(module) on the port's and the JAX package's imchart: equal results
    (strings byte for byte); returns the port's."""
    got, want = fn(tim), fn(jim)
    assert got == want
    return got

class TestAxisTransforms:
    """≈ qa_ImChart.cpp LinearAxisTransform/LogAxisTransform suites."""

    def test_linear_endpoints_and_roundtrip(self):
        xmin, xmax, off, width = 10.0, 100.0, 5, 65
        assert LinearAxisTransform.to_screen(xmin, xmin, xmax, off, width) == off
        assert LinearAxisTransform.to_screen(xmax, xmin, xmax, off, width) \
            == width - 1
        for coord in range(off, width):
            v = LinearAxisTransform.from_screen(coord, xmin, xmax, off, width)
            back = LinearAxisTransform.to_screen(v, xmin, xmax, off, width)
            assert abs(back - coord) <= 2.2  # binning limited (qa_ImChart:26)

    def test_log_endpoints_and_roundtrip(self):
        xmin, xmax, off, width = 0.1, 10000.0, 5, 65
        assert LogAxisTransform.to_screen(xmin, xmin, xmax, off, width) == off
        assert LogAxisTransform.to_screen(xmax, xmin, xmax, off, width) \
            == width - 1
        for coord in range(off, width):
            v = LogAxisTransform.from_screen(coord, xmin, xmax, off, width)
            back = LogAxisTransform.to_screen(v, xmin, xmax, off, width)
            assert abs(back - coord) <= 2.2

    def test_log_throws_on_nonpositive(self):
        # qa_ImChart.cpp:48-52
        with pytest.raises(ValueError):
            LogAxisTransform.to_screen(0.0, 10.0, 100.0, 5, 65)
        with pytest.raises(ValueError):
            LogAxisTransform.to_screen(1.0, 0.0, 100.0, 5, 65)
        with pytest.raises(ValueError):
            LogAxisTransform.to_screen(1.0, 10.0, 0.0, 5, 65)
        with pytest.raises(ValueError):
            LogAxisTransform.from_screen(40, 0.0, 100.0, 5, 65)
        with pytest.raises(ValueError):
            LogAxisTransform.from_screen(40, 10.0, 0.0, 5, 65)


class TestOptimalTicks:
    """≈ qa_ImChart.cpp optimalTickScreenPositions suite (:56-74)."""

    @pytest.mark.parametrize("width", list(range(2, 130)))
    def test_properties(self, width):
        min_gap = 1
        ticks = optimal_tick_positions(width, min_gap)
        assert ticks == jim.optimal_tick_positions(width, min_gap)
        assert ticks, f"no ticks at width {width}"
        assert len(ticks) >= 2
        assert ticks[0] == 0
        assert ticks[-1] == width - 1
        gaps = np.diff(ticks)
        assert (gaps == gaps[0]).all(), f"uneven spacing at width {width}"
        assert gaps[0] >= min_gap

    def test_preferred_divisors(self):
        # width 81 → reduced 80, first divisor 10 → segment 8 → 11 ticks
        assert optimal_tick_positions(81) == list(range(0, 81, 8))
        # width 11 → reduced 10 ≥ 10 → segment 10/10=1?  reduced%10==0,
        # reduced//10=1 which is NOT > min_gap(1) → try 8,5: 10%5==0,
        # 10//5=2>1 → segment = 10//5 = 2
        assert optimal_tick_positions(11) == [0, 2, 4, 6, 8, 10]


class TestChartStyles:
    """≈ qa_ImChart.cpp draw<Style::…> suites — all styles render without
    error and produce the expected glyph families."""

    def setup_method(self):
        self.t = np.linspace(0, 1, 120)
        self.y = np.sin(2 * np.pi * 3 * self.t)

    def test_braille(self):
        art = _same(lambda m: m.ImChart(60, 12).plot(
            self.y, self.t, label="sine-like").render(color=False))
        assert any("⠀" < ch <= "⣿" for ch in art)
        assert "⣿ sine-like" in art

    def test_bars_blocks(self):
        gauss = np.exp(-0.5 * ((self.t - 0.5) / 0.1) ** 2)
        art = _same(lambda m: m.ImChart(60, 12).plot(
            gauss, self.t, style="bars").render(color=False))
        assert "█" in art          # solid fill
        assert any(g in art for g in "▁▂▃▄▅▆▇")  # partial top cells

    def test_marker_glyphs(self):
        art = _same(lambda m: m.ImChart(60, 12)
                    .plot(self.y, self.t, style="marker")
                    .plot(0.5 * self.y, self.t, style="marker").render(color=False))
        assert "X" in art and "O" in art  # kMarker[0], kMarker[1]

    def test_empty_dataset_is_noop(self):
        # qa_ImChart.cpp:110 — drawing an empty dataset must not throw
        art = _same(lambda m: m.ImChart(40, 8).plot([], []).plot([1.0, 2.0])
                    .render(color=False))
        assert isinstance(art, str)

    def test_log_x_axis(self):
        f = np.logspace(-1, 4, 200)
        resp = -20 * np.log10(1 + (f / 100.0) ** 2)
        art = _same(lambda m: m.ImChart(70, 14, x_transform="log",
                                        bounds=((0.1, 1e4), None))
                    .plot(resp, f, label="low-pass1").render(color=False))
        assert "⣿ low-pass1" in art
        # tick labels span the log range: both small and large decades shown
        assert "0.1" in art and ("1e+04" in art or "10000" in art
                                 or "1.00e+04" in art)

    def test_fixed_bounds_clip(self):
        # points outside fixed boundaries are clipped, not wrapped
        art = _same(lambda m: m.ImChart(30, 8, bounds=((0.0, 1.0), (-1.0, 1.0)))
                    .plot([5.0, -5.0, 0.5], [0.1, 0.5, 0.9]).render(color=False))
        assert isinstance(art, str)

    def test_colour_render_has_ansi(self):
        art = _same(lambda m: m.ImChart(30, 6).plot(self.y, self.t).render(color=True))
        assert "\x1b[" in art


class TestMountainRange:
    """≈ qa_ImChart.cpp / ImChart.hpp:582 drawMountainRange."""

    def test_waterfall_renders_all_traces(self):
        t = np.linspace(0, 1, 80)
        traces = [np.exp(-0.5 * ((t - 0.3 - 0.05 * i) / 0.05) ** 2)
                  for i in range(4)]
        c = ImChart(70, 16)
        c.mountain_range(traces, t, base_label="trace")
        art = c.render(color=False)
        cj = jim.ImChart(70, 16)
        cj.mountain_range(traces, t, base_label="trace")
        assert art == cj.render(color=False)
        for i in range(4):
            assert f"trace[{i}]" in art
        # newest trace (index 0) must be drawn last → on top
        assert c.datasets[-1][0] == "trace[0]"

    def test_offsets_expand_bounds(self):
        t = np.linspace(0, 1, 50)
        c = ImChart(40, 10)
        traces = [np.sin(t), np.cos(t)]
        c.mountain_range(traces, t)
        (bx0, bx1) = c._bounds_x
        (by0, by1) = c._bounds_y
        data_min = min(float(np.min(tr)) for tr in traces)
        data_max = max(float(np.max(tr)) for tr in traces)
        assert bx1 > 1.0               # room for x offsets
        assert by1 > data_max          # room for y offsets + padding
        assert by0 < data_min          # 5% padding below the data minimum


class TestColourMath:
    """≈ qa_ImCanvas.cpp colour suites (interpolateRGB/HSV, hex)."""

    def test_rgb_interpolation_endpoints_midpoint(self):
        red, blue = (255, 0, 0), (0, 0, 255)
        assert interpolate_rgb(red, blue, 0.0) == red
        assert interpolate_rgb(red, blue, 1.0) == blue
        mid = _same(lambda m: m.interpolate_rgb(red, blue, 0.5))
        assert mid == (127, 0, 127)
        # t clamped
        assert interpolate_rgb(red, blue, -1.0) == red
        assert interpolate_rgb(red, blue, 2.0) == blue

    def test_hsv_roundtrip_primaries(self):
        for c in [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
                  (0, 255, 255), (255, 0, 255), (255, 255, 255), (0, 0, 0),
                  (128, 64, 32)]:
            h, s, v = rgb_to_hsv(c)
            back = hsv_to_rgb(h, s, v)
            assert all(abs(a - b) <= 1 for a, b in zip(c, back)), (c, back)

    def test_hsv_known_values(self):
        assert rgb_to_hsv((255, 0, 0))[0] == pytest.approx(0.0)
        assert rgb_to_hsv((0, 255, 0))[0] == pytest.approx(120.0)
        assert rgb_to_hsv((0, 0, 255))[0] == pytest.approx(240.0)

    def test_hsv_interpolation_shortest_path(self):
        # red (h=0) → blue (h=240): shortest path is backwards through
        # magenta (h=300), not forwards through green
        mid = _same(lambda m: m.interpolate_hsv((255, 0, 0), (0, 0, 255), 0.5))
        h_mid, _, _ = rgb_to_hsv(mid)
        assert 290.0 < h_mid < 310.0

    def test_hex_roundtrip(self):
        assert to_hex_rgb((255, 128, 0)) == "#FF8000"
        assert parse_hex_rgb("#FF8000") == (255, 128, 0)
        assert parse_hex_rgb("#F80") == (255, 136, 0)
        assert parse_hex_rgb("nonsense") is None
        assert parse_hex_rgb("#GG0000") is None

    def test_ansi_rgb_escape(self):
        assert ansi_rgb((1, 2, 3)) == "\x1b[38;2;1;2;3m"
        assert ansi_rgb((1, 2, 3), foreground=False) == "\x1b[48;2;1;2;3m"


class TestCanvasRgb:
    def test_rgb_dot_renders_truecolor(self):
        def draw(m):
            cv = m.ImCanvas(10, 3)
            cv.dot(2, 2, color=(10, 20, 30))
            return cv.render(color=True)
        art = _same(draw)
        assert "\x1b[38;2;10;20;30m" in art

    def test_text_with_color(self):
        cv = ImCanvas(10, 3)
        cv.text(0, 0, "hi", color=(255, 0, 0))
        art = cv.render(color=True)
        assert "\x1b[38;2;255;0;0m" in art
        assert "hi" in cv.render(color=False).replace("\x1b", "")


def test_quick_plot_back_compat():
    y = np.sin(np.linspace(0, 4 * np.pi, 400))
    out = _same(lambda m: m.quick_plot(y, width=60, height=10))
    lines = out.split("\n")
    assert len(lines) >= 12
    assert "1" in lines[0]


# -- the monitors and the Drawable protocol (tests/test_core_foundations.py) --------

def _monitor_run(pkg, btype, x, block_len=512, **settings):
    g = pkg.Graph()
    mon = pkg.global_registry.create(btype, **settings)
    g.connect(pkg.global_registry.create("VectorSource", data=x), mon)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, **kw).run_and_wait()
    return mon


def test_drawable_protocol():
    # named: an unnamed block's title is its unique name, whose counter
    # depends on how many blocks each package built before in the process
    x = np.sin(np.linspace(0, 10, 2048)).astype(np.float32)
    mon = _monitor_run(gt, "ImChartMonitor", x, stream="none", name="scope")
    assert mon.is_drawable and mon.UI_CATEGORY is gt.UICategory.CONTENT
    art = mon.draw({"color": False})
    assert art and len(art.split("\n")) > 5
    want = _monitor_run(gr, "ImChartMonitor", x, stream="none", name="scope")
    assert art == want.draw({"color": False})
    assert mon.draw() == want.draw()                      # colour, the default
    assert not gt.global_registry.create("MultiplyConst").is_drawable
    assert gt.global_registry.create("MultiplyConst").draw() is None
    assert gt.global_registry.create("ImChartMonitor").draw() is None


@pytest.mark.parametrize("refresh_every", [1, 3])
def test_imchart_monitor_renders_to_its_stream(refresh_every):
    """``stream="stdout"`` prints each render (every ``refresh_every``
    steps), the same bytes in both packages; complex input plots |x|."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    out = {}
    for pkg in (gt, gr):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mon = _monitor_run(pkg, "ImChartMonitor", x, stream="stdout",
                               refresh_every=refresh_every, window=1024,
                               color=False, name="scope")
        out[pkg] = (buf.getvalue(), mon._n_consumed, mon._renders, mon.last_render)
    assert out[gt] == out[gr]
    _, consumed, renders, last = out[gt]
    assert consumed >= 8 and renders == consumed // refresh_every and last
    assert out[gt][0].count("scope") == renders


@pytest.mark.parametrize("complex_in", [False, True])
def test_waterfall_monitor_draws_the_same_rows(complex_in):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(5000).astype(np.float32)
    if complex_in:
        x = (x + 1j * rng.standard_normal(5000)).astype(np.complex64)
    got = _monitor_run(gt, "WaterfallMonitor", x, block_len=700, fft_size=128,
                       rows=12, width=40, name="wf")
    want = _monitor_run(gr, "WaterfallMonitor", x, block_len=700, fft_size=128,
                        rows=12, width=40, name="wf")
    for cfg in ({"color": False}, {"color": True}):
        art = got.draw(cfg)
        assert art and art == want.draw(cfg)
    assert len(got._rows) == 12


def test_styles_markers_ticks_text():
    t = np.linspace(0, 1, 100)
    art = _same(lambda m: m.ImChart(40, 8)
                .plot(np.sin(2 * np.pi * t), t, label="s")
                .plot(t * 0.5, t, label="p", style="points")
                .plot(np.abs(t - 0.5), t, label="b", style="bars")
                .vmarker(0.5).hmarker(0.0)
                .render(color=False, y_ticks=4))
    assert art.count("┤") >= 3
    assert "⣿ s" in art
    cv = ImCanvas(10, 3)
    cv.text(1, 2, "xyz")
    assert "xyz" in cv.render()
    with pytest.raises(ValueError):
        ImChart().plot([1.0], style="nope")


@pytest.mark.parametrize("newest_first", [True, False])
def test_history_buffer_matches(newest_first):
    """Pushes that wrap the mirrored ring, views of every length."""
    rng = np.random.default_rng(5)
    ht, hj = THistory(100, newest_first=newest_first), JHistory(100, newest_first=newest_first)
    assert ht.capacity == hj.capacity == 128
    for n in (7, 60, 128, 300, 1, 90):
        chunk = rng.standard_normal(n)
        ht.push(chunk)
        hj.push(chunk)
        assert len(ht) == len(hj)
        for k in (None, 1, 17, 128):
            np.testing.assert_array_equal(ht.view(k), hj.view(k))
        assert ht[0] == hj[0]


def _spectrum_analyzer(pkg, steps=20):
    text = (ROOT / "examples" / "spectrum_analyzer.yaml").read_text().replace(
        "{window: 2048, refresh_every: 4}", "{window: 2048, refresh_every: 4, stream: none}")
    kw = {"device": "cpu"} if pkg is gt else {}
    s = pkg.run_grc(text, n_steps=steps, scheduler_kwargs=kw)
    return {b.name: b for b in s.graph.blocks}["scope"]


def test_spectrum_analyzer_flow():
    """examples/spectrum_analyzer.yaml for 20 steps (the scope muted): the
    monitor renders; its last FFT frame peaks (below Nyquist) at the 100 kHz
    and 230 kHz bins, 20·log10(4) = 12.04 dB apart within 0.5 dB; and the render equals
    the JAX package's."""
    mon = _spectrum_analyzer(gt)
    assert mon._renders >= 1 and mon.last_render
    frame = mon._hist.view()[-2048:]
    assert frame.shape == (2048,)
    k1, k2 = round(100e3 / 1e6 * 2048), round(230e3 / 1e6 * 2048)
    half = frame[:1024]            # a real input: bins above 1024 mirror these
    assert int(np.argmax(half)) == k1
    assert int(np.argmax(np.where(np.abs(np.arange(1024) - k1) > 8, half, -1e9))) == k2
    assert abs(frame[k1] - frame[k2] - 20 * np.log10(4.0)) < 0.5
    want = _spectrum_analyzer(gr)
    assert mon._renders == want._renders and mon.last_render == want.last_render
