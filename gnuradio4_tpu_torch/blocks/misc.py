"""Remaining reference block families: FunctionGenerator, ClockSource,
SchmittTrigger, FrequencyEstimator, SavitzkyGolayFilter, SvdDenoiser,
BurstTaper, StreamFilter, SyncBlock and the Expression blocks
(≈ blocks/basic FunctionGenerator.hpp:138, ClockSource.hpp:25,
SyncBlock.hpp:13, Trigger.hpp; blocks/filter FrequencyEstimator.hpp,
SavitzkyGolay, SvdDenoiser; blocks/math ExpressionBlocks.hpp:68).

SavitzkyGolayFilter filters through ``ops/fir.py`` ``fir_apply``: the banded
FIR kernel on the card. The gates (StreamFilter) and the skews (SyncBlock)
come from tags, so their windows and offsets are host numbers: the device work
is slices and copies, not masks over the whole step.
"""

from __future__ import annotations

import time
from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block, Port, SourceBlock
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.stream import torch_dtype
from ..core.tags import Keys, Tag
from ..core.trigger import MatchResult, match_trigger
from ..ops import noise as nz
from ..ops.estimators import (SchmittState, schmitt_device, schmitt_edges,
                              taper_edge)
from ..ops.expression import compile_expression
from ..ops.fir import fir_apply, fir_init_state
from ..ops.savgol import design_savgol
from ..ops.svd import svd_denoise
from .basic import phase_state


FUNCTION_MODES = ("Const", "LinearRamp", "ParabolicRamp", "CubicSpline",
                  "ImpulseResponse", "UniformNoise", "TriangularNoise",
                  "GaussianNoise", "Sin", "Cos", "FastSin", "FastCos")
_FG_NOISE = ("UniformNoise", "TriangularNoise", "GaussianNoise")
_FG_TONES = ("Sin", "Cos", "FastSin", "FastCos")


def _f32(v) -> float:
    """A host setting rounded to float32, as the JAX package casts it."""
    return float(np.float32(v))


def _fma(x, y, z) -> torch.Tensor:
    """float32 ``x·y + z`` with one rounding: XLA contracts a multiply that
    feeds an add into a fused multiply-add on the CPU, and the JAX package's
    FunctionGenerator runs so. The product of two float32 values is exact in
    float64; the sum rounds to float64, then to float32."""
    def f64(v):
        return v.to(torch.float64) if torch.is_tensor(v) else float(v)
    return (f64(x) * f64(y) + f64(z)).to(torch.float32)


@register_block("FunctionGenerator")
class FunctionGenerator(SourceBlock):
    """Segment-programmable function source (≈ FunctionGenerator.hpp:138).

    One segment at a time, the reference's full type list
    (FunctionGenerator.hpp:21): ramps {Const, LinearRamp, ParabolicRamp,
    CubicSpline} from ``start_value`` → ``final_value`` over ``duration``
    seconds; ``ImpulseResponse`` (``final_value`` inside [impulse_time0,
    impulse_time0+impulse_time1], ``start_value`` outside); noise types
    (``start_value`` = amplitude, device threefry, the JAX package's bits);
    tones Sin/Cos/FastSin/FastCos (``final_value`` = amplitude,
    ``start_value`` = offset; a positive ``duration`` expires the tone back to
    the offset). Segments are switched by (context) tags or Set messages —
    applying settings restarts the segment clock (state reset), matching the
    reference's context-tag-driven operation. The segment clock is a uint32
    sample counter (a 0-d int64 host tensor); ``t`` is computed in float32
    from it, as in the JAX package.
    """

    # optional clock/tag input (≈ FunctionGenerator.hpp clk_in): carries no
    # sample information here — its TAGS (CMD_BP_START contexts from a
    # ClockSource) drive the stored-settings timeline
    IN = (Port("clk_in", optional=True),)
    OUT = (Port("out", dtype="float32"),)
    signal_type = Setting(default="Const", kind="static", choices=FUNCTION_MODES)
    start_value = Setting(default=0.0)
    final_value = Setting(default=0.0)
    duration = Setting(default=1.0, unit="s", limits=(0.0, 1e12))
    round_off_time = Setting(default=0.0, unit="s",
                             description="parabolic ease-in/out time")
    impulse_time0 = Setting(default=0.0, unit="s")
    impulse_time1 = Setting(default=0.0, unit="s")
    frequency = Setting(default=0.0, unit="Hz")
    phase = Setting(default=0.0, unit="rad")
    seed = Setting(default=0, kind="static",
                   description="PRNG seed for the noise types")
    sample_rate = Setting(default=0.0, unit="Hz")
    n_samples = Setting(default=0, kind="static")

    def init_state(self, ctx):
        if str(self.settings.get("signal_type")) in _FG_NOISE:
            return nz.noise_init_state(int(self.settings.get("seed")),
                                       ctx.device)
        return phase_state()   # samples since segment start (uint32)

    def on_settings_applied(self, result):
        if result.applied:
            self._state_reset = True  # restart segment clock on any change

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        fs = float(self.settings.get("sample_rate")) or ctx.sample_rate
        a = _f32(ctx.p("start_value", 0.0))
        b = _f32(ctx.p("final_value", 0.0))
        dur = _f32(ctx.p("duration", 1.0))
        mode = str(self.settings.get("signal_type"))
        if mode in _FG_NOISE:
            fn = {"UniformNoise": nz.uniform,
                  "TriangularNoise": nz.triangular,
                  "GaussianNoise": nz.gaussian}[mode]
            y, key = fn(state, (n,))
            return key, {"out": (y * a).to(torch.float32)}
        count = int(state)
        dev = ctx.device
        # t = (count + i) / fs, which XLA computes as a multiply by the
        # float32 reciprocal of the constant fs: so does this, bit for bit
        t = (torch.arange(n, dtype=torch.float32, device=dev) + _f32(count)) \
            * _f32(np.float32(1.0) / np.float32(fs))
        nxt = phase_state(count + n)
        if mode in _FG_TONES:
            # final_value = amplitude, start_value = offset; expires to offset
            w = _f32(np.float32(2.0 * np.pi) * np.float32(ctx.p("frequency", 0.0)))
            theta = _fma(t, w, _f32(ctx.p("phase", 0.0)))
            tone = torch.sin(theta) if mode in ("Sin", "FastSin") \
                else torch.cos(theta)
            y = _fma(tone, b, a)
            if dur > 0.0:
                y = torch.where(t > dur, torch.full_like(y, a), y)
            return nxt, {"out": y}
        if mode == "ImpulseResponse":
            it0 = _f32(ctx.p("impulse_time0", 0.0))
            end = _f32(np.float32(it0) + np.float32(ctx.p("impulse_time1", 0.0)))
            y = torch.where((t < it0) | (t > end),
                            torch.full_like(t, a), torch.full_like(t, b))
            return nxt, {"out": y}
        # a true quotient on every device: CUDA divides by a host scalar as a
        # multiply by its reciprocal, so the divisor is a 0-d device tensor
        u = torch.clamp(t / torch.full((), _f32(max(np.float32(dur),
                                                    np.float32(1e-12))),
                                       device=dev), 0.0, 1.0)
        ba = _f32(np.float32(b) - np.float32(a))
        if mode == "Const":
            y = torch.full((n,), a, dtype=torch.float32, device=dev)
        elif mode == "LinearRamp":
            y = _fma(u, ba, a)
        elif mode == "CubicSpline":   # smoothstep 3u² − 2u³
            y = _fma(_fma(3.0 * u, u, -(2.0 * u * u * u)), ba, a)
        else:  # ParabolicRamp: parabolic ease for round_off_time at both ends
            f = np.float32
            rho = f(min(max(f(ctx.p("round_off_time", 0.0)) / f(dur), f(0.0)),
                        f(0.5)))
            if rho <= 0.0:
                shape = u
            else:
                # piecewise: parabola [0,ρ], linear [ρ,1−ρ], parabola [1−ρ,1]
                v = f(1.0) / max(f(1.0) - rho, f(1e-9))   # peak slope
                k = float(f(0.5) * v / max(rho, f(1e-9)))
                seg1 = k * u * u
                seg2 = (u - float(f(0.5) * rho)) * float(v)
                seg3 = _fma((1.0 - u) ** 2, -k, 1.0)
                shape = torch.where(u < float(rho), seg1,
                                    torch.where(u > float(f(1.0) - rho),
                                                seg3, seg2))
                shape = torch.clamp(shape, 0.0, 1.0)
            y = _fma(shape, ba, a)
        return nxt, {"out": y}


@register_block("ClockSource")
class ClockSource(SourceBlock):
    """Wall-clock-paced source emitting zeros + scheduled trigger tags
    (≈ ClockSource.hpp:25 + BlockingSync). ``do_zero_order_hold`` semantics: the
    sample content is a constant; the value of the block is its tag timeline.
    """

    OUT = (Port("out", dtype="uint8"),)
    FEED = True
    sample_rate = Setting(default=1000.0, unit="Hz", kind="static")
    n_samples = Setting(default=0, kind="static")
    realtime = Setting(default=False, kind="static",
                       description="pace host feed at sample_rate wall-clock")

    def __init__(self, name=None, tag_times: list[float] = (),
                 tag_values: list[dict] = (), **settings):
        super().__init__(name=name, **settings)
        self.tag_times = list(tag_times)   # seconds
        self.tag_values = [dict(v) for v in tag_values] or \
            [{Keys.TRIGGER_NAME: f"trigger{i}"} for i in range(len(self.tag_times))]
        self._t0: float | None = None

    def start(self):
        self._t0 = time.monotonic()

    def host_feed(self, n, abs_index):
        total = int(self.settings.get("n_samples"))
        fs = float(self.settings.get("sample_rate"))
        if total and abs_index >= total:
            return None
        if self.settings.get("realtime"):
            if self._t0 is None:
                self._t0 = time.monotonic()
            target = self._t0 + (abs_index + n) / fs
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        nv = n if not total else min(n, total - abs_index)
        return {"out": np.zeros(n, np.uint8)}, nv

    def emit_tags(self, ctx):
        fs = float(self.settings.get("sample_rate"))
        n = next(iter(ctx.out_len.values()), 0)
        lo, hi = ctx.abs_index, ctx.abs_index + n
        out = []
        for t_s, tmap in zip(self.tag_times, self.tag_values):
            idx = int(round(t_s * fs))
            if lo <= idx < hi:
                m = dict(tmap)
                m.setdefault(Keys.TRIGGER_TIME, t_s)
                out.append(Tag(idx - lo, m))
        return out

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("SchmittTrigger")
class SchmittTrigger(Block):
    """Hysteresis comparator (≈ blocks/basic Trigger.hpp SchmittTrigger +
    algorithm/SchmittTrigger.hpp).

    Two output modes:

    - ``output='gate'`` (default): the binary comparator state as a ±1 stream
      — the pure device form;
    - ``output='pass'``: the input passed through verbatim, as the reference
      block does (Trigger.hpp:133 copies input to output).

    Edge *tags*: when ``trigger_name_rising_edge`` / ``falling_edge`` are
    non-empty (reference defaults: "RISING"/"FALLING"; "" omits), the block
    emits trigger tags at the detected (sub-sample interpolated) edge
    positions, carrying trigger_name/trigger_time/trigger_offset/context
    (Trigger.hpp:122-130 publishTag). Edge positions are data-dependent, so
    the tags are computed host-side on the landed device results and ride the
    delivery path (scheduler ``host_emit_tags``) — enabling them costs one
    D2H copy of this block's input per step. ``interpolation``:
    'none' | 'basic_linear' | 'regression' | 'polynomial'
    (= NO/BASIC_LINEAR/LINEAR/POLYNOMIAL_INTERPOLATION).

    Thresholds: legacy ``low``/``high``, or the reference's
    ``offset``±``threshold`` pair (algorithm/SchmittTrigger.hpp:67) —
    offset/threshold win when explicitly set.
    """

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    low = Setting(default=-0.5, kind="static")
    high = Setting(default=0.5, kind="static")
    offset = Setting(default=0.0, kind="static",
                     description="trigger offset (band midpoint)")
    threshold = Setting(default=0.0, kind="static",
                        description="hysteresis half-width; band = offset±threshold")
    output = Setting(default="gate", kind="static", choices=("gate", "pass"))
    trigger_name_rising_edge = Setting(default="", kind="static")
    trigger_name_falling_edge = Setting(default="", kind="static")
    interpolation = Setting(default="basic_linear", kind="static",
                            choices=("none", "basic_linear", "regression",
                                     "polynomial"))
    forward_tag = Setting(default=True, kind="static")

    def __init__(self, name=None, **settings):
        explicit_band = "offset" in settings or "threshold" in settings
        super().__init__(name=name, **settings)
        if explicit_band:
            off = float(self.settings.get("offset"))
            thr = float(self.settings.get("threshold"))
            self.settings.set({"low": off - thr, "high": off + thr})
            self.settings.apply_staged()
        self._rise = str(self.settings.get("trigger_name_rising_edge"))
        self._fall = str(self.settings.get("trigger_name_falling_edge"))
        if self._rise or self._fall:
            # data-derived tag emission: opt into HOST_TAP delivery of this
            # block's input + the host_emit_tags hook (core/scheduler.py)
            self.HOST_TAP = True
            self.EMITS_HOST_TAGS = True
        self._edge_state = SchmittState()
        self._fs = 1.0

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        self._fs = ctx.sample_rate
        return torch.zeros(() if ch == 0 else (ch,), dtype=torch.bool,
                           device=ctx.device)

    def apply(self, state, ins, ctx):
        states, carry = schmitt_device(ins["in"], state,
                                       low=float(self.settings.get("low")),
                                       high=float(self.settings.get("high")))
        if str(self.settings.get("output")) == "pass":
            return carry, {"out": ins["in"]}
        return carry, {"out": torch.where(states, 1.0, -1.0).to(torch.float32)}

    def process_tags(self, in_tags, ctx):
        if not bool(self.settings.get("forward_tag")):
            return {"out": []}
        return super().process_tags(in_tags, ctx)

    def consume(self, arrays, tags, n_valid, abs_index):
        """No-op sink hook — present because HOST_TAP delivery feeds this
        block's input back to the host for edge extraction."""

    def host_emit_tags(self, arrays, tags, n_valid, abs_index):
        x = np.asarray(arrays["in"][..., :n_valid], np.float64)
        if x.ndim > 1:
            x = x[0]
        edges, self._edge_state = schmitt_edges(
            x, low=float(self.settings.get("low")),
            high=float(self.settings.get("high")),
            state=self._edge_state,
            method=str(self.settings.get("interpolation")))
        fs = self._fs if self._fs else 1.0
        out = []
        for pos, kind in edges:
            name = self._rise if kind > 0 else self._fall
            if not name:
                continue
            ipos = int(np.floor(pos))
            if abs_index + ipos < 0:
                # interpolation extrapolated before the stream start — the
                # reference skips out-of-range edge positions
                # (Trigger.hpp:146 edgePosition >= 0 gate)
                continue
            out.append(Tag(ipos, {
                Keys.TRIGGER_NAME: name,
                Keys.TRIGGER_TIME: int((abs_index + pos) * 1e9 / fs),
                Keys.TRIGGER_OFFSET: float(pos - ipos) / fs,
                Keys.CONTEXT: "",
            }))
        return out


@register_block("FrequencyEstimator")
class FrequencyEstimator(Block):
    """Chunked frequency estimation (≈ FrequencyEstimator.hpp, decimating).

    method 'fft': windowed FFT + parabolic peak interpolation per chunk;
    method 'zero_crossing': mean spacing of sign changes. One estimate per
    ``chunk`` samples (rate fs/chunk).

    Complex IQ input is accepted on both methods (beyond the reference's
    float/double instantiations): 'fft' searches the full signed spectrum
    [−fs/2, fs/2); 'zero_crossing' becomes the phase-slope (Kay) estimator
    fs/2π·arg Σ x[n+1]·x̄[n] — the ML tone-frequency estimator at high SNR.
    The peak bin is the first maximum (``torch.argmax``, as ``jnp.argmax``).
    """

    IN = (Port("in"),)
    OUT = (Port("out", dtype="float32"),)
    chunk = Setting(default=1024, kind="static", limits=(8, 1 << 24))
    method = Setting(default="fft", kind="static",
                     choices=("fft", "zero_crossing", "period"))
    # grid-frequency band (≈ FrequencyEstimator.hpp f_min/f_expected/f_max):
    # 'period' estimates outside [f_min, f_max] fall back to f_expected
    f_min = Setting(default=0.0)
    f_max = Setting(default=0.0, description="0 = unbounded")
    f_expected = Setting(default=0.0)

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("chunk")))

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def apply(self, state, ins, ctx):
        n = int(self.settings.get("chunk"))
        x = ins["in"]
        xw = x.reshape(*x.shape[:-1], -1, n)
        fs = ctx.sample_rate
        method = self.settings.get("method")
        if method == "fft":
            w = torch.from_numpy(np.hanning(n).astype(np.float32)).to(x.device)
            if x.is_complex():
                # full signed spectrum, fftshifted so DC sits at bin n//2
                spec = torch.fft.fftshift(torch.fft.fft(xw * w, dim=-1),
                                          dim=-1).abs()
                spec[..., n // 2] = 0.0                    # ignore DC
                half, bin0 = n - 1, -(n // 2)
            else:
                spec = torch.fft.rfft(xw * w, dim=-1).abs()
                spec[..., 0] = 0.0                         # ignore DC
                half, bin0 = n // 2, 0
            k = torch.argmax(spec, dim=-1, keepdim=True)
            # parabolic interpolation around the peak
            km = k.clamp(1, half - 1)
            a = torch.gather(spec, -1, km - 1)[..., 0]
            b = torch.gather(spec, -1, km)[..., 0]
            c = torch.gather(spec, -1, km + 1)[..., 0]
            denom = a - 2 * b + c
            d = torch.where(denom.abs() > 1e-20, 0.5 * (a - c) / denom,
                            torch.zeros_like(denom))
            freq = (km[..., 0].to(torch.float32) + d + bin0) * (fs / n)
        elif method == "period":
            # zero-crossing period regression — the reference's grid-frequency
            # time-domain estimator (FrequencyEstimator.hpp TimeDomain):
            # linear-interpolated rising crossings; f = (k−1)/(t_last−t_first).
            # First/last crossings via masked min/max.
            a = xw[..., :-1].real if xw.is_complex() else xw[..., :-1]
            b = xw[..., 1:].real if xw.is_complex() else xw[..., 1:]
            rising = (a < 0) & (b >= 0)
            base = torch.arange(n - 1, dtype=torch.float32, device=x.device)
            ab = a - b
            frac = a / torch.where(ab == 0, torch.ones_like(ab), ab)
            pos = base + frac
            big = torch.full_like(pos, 1e12)
            first = torch.amin(torch.where(rising, pos, big), dim=-1)
            last = torch.amax(torch.where(rising, pos, -big), dim=-1)
            k = torch.sum(rising, dim=-1).to(torch.float32)
            span = (last - first).clamp_min(1e-9)
            freq = torch.where(k >= 2, (k - 1.0) * fs / span,
                               torch.zeros_like(span))
            f_lo = _f32(ctx.p("f_min", 0.0))
            f_hi = _f32(ctx.p("f_max", 0.0))
            out_of_band = (freq < f_lo) | ((freq > f_hi) if f_hi > 0
                                           else torch.zeros_like(rising[..., 0]))
            freq = torch.where(out_of_band,
                               torch.full_like(freq, _f32(ctx.p("f_expected", 0.0))),
                               freq)
        elif x.is_complex():
            # phase-slope (Kay) estimator: signed, sub-bin, one arg per chunk
            acc = torch.sum(xw[..., 1:] * xw[..., :-1].conj(), dim=-1)
            freq = torch.angle(acc).to(torch.float32) * (fs / (2.0 * np.pi))
        else:
            sign = torch.signbit(xw)
            crossings = torch.sum(sign[..., 1:] != sign[..., :-1], dim=-1)
            # ÷ 2(n−1), a constant: XLA's multiply by its float32 reciprocal
            freq = crossings.to(torch.float32) * fs \
                * _f32(np.float32(1.0) / np.float32(2.0 * (n - 1)))
        return state, {"out": freq.to(torch.float32)}


@register_block("SavitzkyGolayFilter")
class SavitzkyGolayFilter(Block):
    """Polynomial smoothing / differentiation (≈ SavitzkyGolayFilter). An FIR
    with S-G designed taps (``fir_apply``: the banded FIR kernel on the card);
    the taps are designed once per setting."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    window = Setting(default=11, kind="static", limits=(3, 4097))
    poly_order = Setting(default=3, kind="static", limits=(0, 32))
    deriv = Setting(default=0, kind="static", limits=(0, 8))

    def _taps(self):
        key = tuple(int(self.settings.get(k))
                    for k in ("window", "poly_order", "deriv"))
        if getattr(self, "_taps_key", None) != key:
            self._taps_key = key
            self._taps_f32 = design_savgol(key[0], key[1], deriv=key[2]
                                           ).astype(np.float32)
        return self._taps_f32

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        return fir_init_state(ch, int(self.settings.get("window")),
                              np.float32, ctx.device)

    def apply(self, state, ins, ctx):
        y, st = fir_apply(ins["in"], self._taps(), state)
        return st, {"out": y}


@register_block("SvdDenoiser")
class SvdDenoiser(Block):
    """Truncated-SVD (Hankel) denoiser per chunk (≈ SvdDenoiser).

    ``engine='auto'`` decides from the device: ``xla`` (``torch.linalg.svd``,
    LAPACK) on the CPU, as the JAX package off the TPU; on CUDA ``jacobi``,
    the engine timed faster on the H100 at a step of 2^20 samples (chunk
    256, window 16: see ``_CUDA_AUTO``)."""

    IN = (Port("in"),)                    # polymorphic: real or complex IQ
    OUT = (Port("out"),)
    chunk = Setting(default=256, kind="static", limits=(16, 1 << 16))
    window = Setting(default=16, kind="static", limits=(2, 4096))
    rank = Setting(default=2, kind="static", limits=(1, 4096))
    energy_fraction = Setting(default=1.0, kind="static", limits=(0.0, 1.0),
                              description="keep components until this "
                                          "fraction of total σ² energy is "
                                          "covered (≈ SvdFilter.hpp:33 "
                                          "energyFraction)")
    engine = Setting(default="auto", kind="static",
                     choices=("auto", "xla", "jacobi"),
                     description="SVD kernel: XLA QR-iteration or the "
                                 "one-sided Jacobi sweep (static control "
                                 "flow, ≈ reference SVD.hpp); auto = jacobi "
                                 "on TPU (QR iteration is data-dependent "
                                 "control flow XLA lowers poorly there), "
                                 "xla elsewhere")

    # engine 'auto' on CUDA. chip_smoke.py phase 25(c), one H100 (700 W), at
    # 2^20 samples a step (4096 chunks of 256, window 16): jacobi 148.7 ms,
    # xla 2640.1 ms — torch.linalg.svd runs one cuSOLVER solve per Hankel
    # matrix (241 × 16 is above the batched solver's 32 × 32), ~90 launches
    # each, where the Jacobi sweeps batch every chunk into ~14 400 launches
    _CUDA_AUTO = "jacobi"

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def _engine(self, device: torch.device) -> str:
        eng = str(self.settings.get("engine"))
        if eng != "auto":
            return eng
        return self._CUDA_AUTO if device.type == "cuda" else "xla"

    def apply(self, state, ins, ctx):
        n = int(self.settings.get("chunk"))
        x = ins["in"]
        den = svd_denoise(
            x.reshape(-1, n), window=int(self.settings.get("window")),
            rank=int(self.settings.get("rank")),
            energy_fraction=float(self.settings.get("energy_fraction")),
            method=self._engine(x.device))
        return state, {"out": den.reshape(x.shape)}


@register_block("BurstTaper")
class BurstTaper(Block):
    """Burst ramp-up/down envelope driven by trigger tags (≈ BurstTaper.hpp).

    Tags named ``burst_start``/``burst_stop`` (per step, host sideband) are
    packed into fixed-capacity index arrays (dynamic params), as in the JAX
    package; the envelope multiplies the edge shape in at each valid entry
    (the padding entries, −2³⁰, never reach the step and are skipped).
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    ramp_len = Setting(default=64, kind="static", limits=(1, 1 << 16))
    shape = Setting(default="raised_cosine", kind="static",
                    choices=("none", "linear", "raised_cosine", "tukey",
                             "gaussian", "mushroom", "mushroom_sine"),
                    description="edge shape family "
                                "(≈ BurstTaper.hpp TaperType)")
    shape_param = Setting(default=0.0, kind="static",
                          description="shape parameter: raised_cosine power, "
                                      "tukey alpha, gaussian sigma (0 → the "
                                      "reference's default per shape)")
    max_bursts_per_step = Setting(default=8, kind="static", limits=(1, 64))

    _FAR = -(1 << 30)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._starts: list[int] = []
        self._stops: list[int] = []

    def process_tags(self, in_tags, ctx):
        self._starts = [t.index for t in in_tags.get("in", [])
                        if t.map.get(Keys.TRIGGER_NAME) == "burst_start"]
        self._stops = [t.index for t in in_tags.get("in", [])
                       if t.map.get(Keys.TRIGGER_NAME) == "burst_stop"]
        return super().process_tags(in_tags, ctx)

    def prepare_params(self, params):
        params = dict(params)
        cap = int(self.settings.get("max_bursts_per_step"))

        def pack(idxs):
            arr = np.full(cap, self._FAR, np.int32)
            for i, v in enumerate(idxs[:cap]):
                arr[i] = v
            return arr
        params["_starts"] = pack(self._starts)
        params["_stops"] = pack(self._stops)
        return params

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = x.shape[-1]
        ramp_l = int(self.settings.get("ramp_len"))
        ramp = torch.from_numpy(taper_edge(
            str(self.settings.get("shape")), ramp_l, rising=True,
            param=float(self.settings.get("shape_param"))).astype(np.float32)
        ).to(x.device)
        idx = torch.arange(n, dtype=torch.int64, device=x.device)
        env = torch.ones(n, dtype=torch.float32, device=x.device)
        far = np.full(1, self._FAR, np.int32)
        # starts ramp up FROM the index, stops ramp down INTO it
        for marks, sign in ((ctx.params.get("_starts", far), 1),
                            (ctx.params.get("_stops", far), -1)):
            for m in np.asarray(marks).tolist():
                if m == self._FAR:
                    continue
                off = (idx - m) * sign
                ramp_val = ramp[off.clamp(0, ramp_l - 1)]
                env = torch.where((off >= 0) & (off < ramp_l),
                                  env * ramp_val, env)
        rdt = x.real.dtype if x.is_complex() else x.dtype
        return state, {"out": x * env.to(rdt)}


def _gate(x: torch.Tensor, intervals: list[tuple[int, int]]) -> torch.Tensor:
    """``x`` inside the [lo, hi) intervals (host numbers, clamped to the
    step), zero elsewhere: one zero fill and a copy per interval."""
    n = x.shape[-1]
    y = torch.zeros_like(x)
    for lo, hi in intervals:
        lo, hi = max(lo, 0), min(hi, n)
        if lo < hi:
            y[..., lo:hi] = x[..., lo:hi]
    return y


def _open_intervals(level0: int, deltas: list[tuple[int, int]], n: int
                    ) -> tuple[list[tuple[int, int]], int]:
    """The [lo, hi) runs of [0, n) where ``level0`` plus the deltas at or
    before each index is positive, and that level at index n−1. ``deltas``:
    (index, ±1); an index below 0 counts from the start, one at n or beyond
    never."""
    events: dict[int, int] = {}
    level = level0
    for i, d in deltas:
        if i <= 0:
            level += d
        elif i < n:
            events[i] = events.get(i, 0) + d
    runs, start = [], 0 if level > 0 else None
    for i in sorted(events):
        level += events[i]
        if level > 0 and start is None:
            start = i
        elif level <= 0 and start is not None:
            runs.append((start, i))
            start = None
    if start is not None:
        runs.append((start, n))
    return runs, level


@register_block("StreamFilter")
class StreamFilter(Block):
    """Trigger-gated stream (≈ StreamFilter, StreamToDataSet.hpp:27).

    The reference emits a *variable-rate* stream containing only the samples
    inside start→stop trigger windows; static shapes forbid that, so the
    gated form zeroes out-of-window samples (dense stream, same rate) — pair
    with StreamToDataSet when true extraction is needed. Window state carries
    across steps. The window is open at sample i while the carried state plus
    the starts at or before i, less the stops at or before i, is positive (as
    in the JAX package); the starts and stops are host numbers, so the runs
    are found on the host and the step copies them (no [T, capacity] count).
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    filter = Setting(default="", kind="static", description="start matcher DSL")
    filter_stop = Setting(default="", kind="static",
                          description="stop matcher ('' → same as start toggles)")
    max_events_per_step = Setting(default=16, kind="static", limits=(1, 256))

    _FAR = 1 << 30

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._start = match_trigger(str(self.settings.get("filter") or "^."))
        stop = str(self.settings.get("filter_stop"))
        self._stop = match_trigger(stop) if stop else None
        self._starts: list[int] = []
        self._stops: list[int] = []

    def process_tags(self, in_tags, ctx):
        self._starts, self._stops = [], []
        toggle_open = None
        for t in sorted(in_tags.get("in", [])):
            if self._stop is None:
                if self._start(t) is MatchResult.MATCHED:
                    if toggle_open is None or not toggle_open:
                        self._starts.append(t.index)
                        toggle_open = True
                    else:
                        self._stops.append(t.index)
                        toggle_open = False
            else:
                if self._start(t) is MatchResult.MATCHED:
                    self._starts.append(t.index)
                if self._stop(t) is MatchResult.MATCHED:
                    self._stops.append(t.index)
        return super().process_tags(in_tags, ctx)

    def prepare_params(self, params):
        params = dict(params)
        cap = int(self.settings.get("max_events_per_step"))

        def pack(idxs):
            arr = np.full(cap, self._FAR, np.int32)
            for i, v in enumerate(idxs[:cap]):
                arr[i] = v
            return arr
        params["_gate_starts"] = pack(self._starts)
        params["_gate_stops"] = pack(self._stops)
        return params

    def init_state(self, ctx):
        # window open at step start? (a host bool)
        return torch.zeros((), dtype=torch.bool)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        far = np.full(1, self._FAR, np.int32)
        deltas = [(int(i), 1) for i in ctx.params.get("_gate_starts", far)] \
            + [(int(i), -1) for i in ctx.params.get("_gate_stops", far)]
        runs, level = _open_intervals(int(bool(state)), deltas, x.shape[-1])
        return torch.tensor(level > 0), {"out": _gate(x, runs)}
def _like(v, x: torch.Tensor) -> torch.Tensor:
    """A program's result as a tensor of ``x``'s dtype and shape (a constant
    result fills it)."""
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v.to(x.dtype), x.shape)
    return torch.full_like(x, v)


class _ExpressionBase(Block):
    """Shared plumbing for the ExprTk-subset expression blocks
    (≈ ExpressionBlocks.hpp:68): the expression string is parsed and compiled
    once by ``ops.expression`` and runs as torch ops on the block's tensors.
    Free parameters a/b/c mirror the reference's ``param_a/b/c`` Annotated
    settings and are *dynamic* (retunable without a recompile); they reach
    the program as host numbers."""

    expression = Setting(default="x", kind="static")
    param_a = Setting(default=1.0, description="free parameter 'a'")
    param_b = Setting(default=0.0, description="free parameter 'b'")
    param_c = Setting(default=0.0, description="free parameter 'c'")

    _ARGS: tuple[str, ...] = ("x",)
    _OUT_VAR = "y"

    # string variables (≈ ExprTk symbol_table.add_stringvar): "k=v,k2=v2";
    # host values, so a change recompiles the program like any static setting
    strings = Setting(default="", kind="static",
                      description="expression string variables as "
                                  "'name=value[,name2=value2…]' — host "
                                  "constants of the program (ExprTk "
                                  "stringvar)")

    def __init__(self, name=None, expr_string=None, functions=None,
                 string_vars=None, **settings):
        if expr_string is not None:      # reference setting-name alias
            settings.setdefault("expression", expr_string)
        if string_vars:                  # dict convenience constructor form
            settings.setdefault("strings", ",".join(
                f"{k}={v}" for k, v in string_vars.items()))
        # per-block user functions (≈ ExprTk symbol_table.add_function,
        # ExpressionBlocks.hpp:68): name -> callable (or (fn, arity)) on the
        # program's tensors; layered over the global
        # ops.expression.register_function registry
        self._user_functions = dict(functions or {})
        super().__init__(name=name, **settings)
        self._compile_expr()

    def _string_vars(self) -> dict[str, str]:
        raw = str(self.settings.get("strings")).strip()
        out: dict[str, str] = {}
        for part in (p for p in raw.split(",") if p.strip()):
            if "=" not in part:
                raise GrError(f"{self.name}: strings entry {part!r} is not "
                              f"'name=value'")
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
        return out

    def _compile_expr(self):
        self._strs = self._string_vars()
        self._fn = compile_expression(
            str(self.settings.get("expression")),
            self._ARGS + ("a", "b", "c") + tuple(self._strs),
            out_var=self._OUT_VAR, functions=self._user_functions)

    def on_settings_applied(self, result):
        if "expression" in result.applied or "strings" in result.applied:
            self._compile_expr()

    def _abc(self, ctx) -> dict:
        return {"a": float(ctx.p("param_a", 1.0)),
                "b": float(ctx.p("param_b", 0.0)),
                "c": float(ctx.p("param_c", 0.0)),
                **self._strs}


@register_block("ExpressionSISO")
class ExpressionSISO(_ExpressionBase):
    """y = f(x) per sample (≈ ExpressionSISO, ExpressionBlocks.hpp:68).

    The reference's recursive idiom ``y := y + 0.1*x`` (its doc example of
    an IIR-like update where ``y`` is the previous output) is detected
    statically and run sample by sample with ``y`` carried across scheduler
    steps; pure expressions run once over the whole block."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    extra_outputs = Setting(default="", kind="static",
                            description="comma-separated expression variables "
                                        "exposed as additional output ports "
                                        "(multi-output assignment)")

    def __init__(self, name=None, expr_string=None, functions=None,
                 **settings):
        super().__init__(name=name, expr_string=expr_string,
                         functions=functions, **settings)
        extra = [s.strip() for s in
                 str(self.settings.get("extra_outputs")).split(",")
                 if s.strip()]
        if extra:
            missing = [v for v in extra if v not in self._fn.writes]
            if missing:
                raise GrError(f"extra_outputs {missing} are never assigned "
                              f"by the expression (writes: "
                              f"{sorted(self._fn.writes)})")
            if self._fn.reads_output:
                raise GrError("extra_outputs cannot combine with the "
                              "recursive y-feedback idiom (the loop carries "
                              "only y)")
            self.out_ports = (Port("out"),
                              *(Port(v) for v in extra))
        self._extra = extra

    def init_state(self, ctx):
        if not self._fn.reads_output:
            return ()
        ch = ctx.channels.get("in", 0)
        return torch.zeros((ch,) if ch else (), dtype=torch.float32,
                           device=ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        abc = self._abc(ctx)
        if not self._fn.reads_output:
            if self._extra:
                y, env = self._fn.eval_all(x=x, **abc)
                outs = {"out": _like(y, x)}
                for v in self._extra:
                    outs[v] = _like(env[v], x)
                return state, outs
            y = self._fn(x=x, **abc)
            return state, {"out": y if isinstance(y, torch.Tensor)
                           else torch.full_like(x, y)}
        # the recursive idiom: one program run per sample, y carried
        ys = []
        y = state
        for n in range(x.shape[-1]):
            y = _like(self._fn(x=x[..., n], y=y, **abc), state)
            ys.append(y)
        return y, {"out": torch.stack(ys, dim=-1) if ys
                   else x.new_zeros(x.shape, dtype=state.dtype)}


@register_block("ExpressionDISO")
class ExpressionDISO(_ExpressionBase):
    """z = f(x, y) over two input streams (≈ ExpressionDISO; the reference
    binds in0→x, in1→y and returns z, ExpressionBlocks.hpp)."""

    IN = (Port("x"), Port("y"))
    OUT = (Port("out"),)
    expression = Setting(default="x + y", kind="static")

    _ARGS = ("x", "y")
    _OUT_VAR = "z"

    def apply(self, state, ins, ctx):
        x = ins["x"]
        z = self._fn(x=x, y=ins["y"], **self._abc(ctx))
        return state, {"out": z if isinstance(z, torch.Tensor)
                       else torch.full_like(x, z)}


@register_block("ExpressionBulk")
class ExpressionBulk(_ExpressionBase):
    """Whole-span expression over vectors vecIn → vecOut (≈ ExpressionBulk,
    ExpressionBlocks.hpp; reference example ``vecOut := a * vecIn``).

    Vector indexing and ``for (var i := 0; i < N; i += 1) { … }`` loops with
    static bounds are unrolled; out-of-range accesses raise (≈ the
    reference's vector_access_runtime_check, ExpressionBlocks.hpp:48)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    expression = Setting(default="vecOut := vecIn", kind="static")

    _ARGS = ("vecIn", "vecOut", "x")
    _OUT_VAR = "vecOut"

    def apply(self, state, ins, ctx):
        x = ins["in"]
        out = self._fn(vecIn=x, vecOut=torch.zeros_like(x), x=x,
                       **self._abc(ctx))
        return state, {"out": _like(out, x)}


@register_block("SyncBlock")
class SyncBlock(Block):
    """Multi-stream aligner (≈ SyncBlock.hpp:13): shifts each input by a per-port
    skew so matching trigger tags line up. Skews are measured host-side from the
    first matching trigger tag per port and applied on the device as a slice
    of a carried history window (± ``max_skew`` samples); the slice start is
    host arithmetic, clamped into the window as ``dynamic_slice`` clamps it.
    """

    n_inputs = Setting(default=2, kind="static", limits=(2, 64))
    max_skew = Setting(default=256, kind="static", limits=(1, 1 << 20))
    trigger = Setting(default="", kind="static",
                      description="trigger_name to align on ('' = any trigger)")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        n = int(self.settings.get("n_inputs"))
        self.in_ports = tuple(Port(f"in{i}") for i in range(n))
        self.out_ports = tuple(Port(f"out{i}") for i in range(n))
        self._skews = np.zeros(n, np.int32)

    def process_tags(self, in_tags, ctx):
        name = str(self.settings.get("trigger"))
        max_skew = int(self.settings.get("max_skew"))
        marks: dict[int, int] = {}
        for i in range(len(self.in_ports)):
            for t in in_tags.get(f"in{i}", []):
                tn = t.map.get(Keys.TRIGGER_NAME)
                if tn is not None and (not name or tn == name):
                    marks[i] = t.index
                    break
        if len(marks) == len(self.in_ports) and marks:
            latest = max(marks.values())
            for i, idx in marks.items():
                self._skews[i] = int(np.clip(latest - idx, 0, max_skew))
        out = {}
        for i in range(len(self.in_ports)):
            out[f"out{i}"] = [t.shifted(int(self._skews[i]))
                              for t in in_tags.get(f"in{i}", [])]
        return out

    def prepare_params(self, params):
        params = dict(params)
        params["_skews"] = self._skews.copy()
        return params

    def init_state(self, ctx):
        m = int(self.settings.get("max_skew"))
        return {f"h{i}": torch.zeros((m,), dtype=torch_dtype(
                    ctx.dtype(f"in{i}", np.float32)), device=ctx.device)
                for i in range(len(self.in_ports))}

    def apply(self, state, ins, ctx):
        m = int(self.settings.get("max_skew"))
        skews = ctx.params.get("_skews", np.zeros(len(self.in_ports), np.int32))
        outs = {}
        new_state = {}
        for i in range(len(self.in_ports)):
            x = ins[f"in{i}"]
            n = x.shape[-1]
            xc = torch.cat([state[f"h{i}"].to(x.dtype), x], dim=-1)
            # skew s ⇒ delay by s samples; the start stays inside [0, m]
            start = min(max(m - int(skews[i]), 0), xc.shape[-1] - n)
            outs[f"out{i}"] = xc[..., start:start + n]
            new_state[f"h{i}"] = xc[..., -m:].clone()
        return new_state, outs
