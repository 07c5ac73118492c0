"""Basic blocks (≈ reference blocks/basic/): SignalGenerator
(SignalGenerator.hpp:25), the device noise source, the Selector N×M router
(Selector.hpp:15), Interleave/Deinterleave and the converter blocks
(ConverterBlocks.hpp: Convert, ScalingConvert, Real/Imag/Arg,
complex↔interleaved/RealImag/MagPhase, deg↔rad).

The NCO phase state is a 0-d int64 *host* tensor holding a uint32 value: the
phase is a host integer wherever it is used (the start phase of a device ramp),
so keeping it on the host costs no device→host read per step.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block, Port, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.stream import canonical_dtype, torch_dtype
from ..ops import noise as noise_ops
from ..ops.signal import (MASK32, NOISE_WAVEFORMS, WAVEFORMS, complex_exp,
                          complex_exp_ramp, nco_phases, phase_increment,
                          phase_to_frac, waveform)


def phase_state(value: int = 0) -> torch.Tensor:
    """A uint32 NCO phase as a 0-d int64 host tensor."""
    return torch.tensor(int(value) & MASK32, dtype=torch.int64)


@register_block("SignalGenerator")
class SignalGenerator(SourceBlock):
    """Waveform source with drift-free integer-NCO phase (≈ SignalGenerator.hpp:25).

    settings: signal ∈ {Const,Sin,Cos,Square,Saw,Triangle,FastSin,FastCos,
    UniformNoise,TriangularNoise,GaussianNoise} (the reference's full type
    list, SignalGenerator.hpp:18), frequency [Hz], amplitude, offset,
    phase [rad], sample_rate [Hz], n_samples (0=∞), seed (noise types).
    Noise conventions match NoiseGenerator.hpp: Uniform/Triangular on
    [−A, +A) + O, Gaussian N(0, A²) + O; generated on the device from the
    threefry stream of ``ops/noise.py`` (the JAX package's bits).
    """

    OUT = (Port("out"),)
    signal = Setting(default="Sin", kind="static",
                     choices=WAVEFORMS + NOISE_WAVEFORMS)
    dtype = Setting(default="float32", kind="static",
                    choices=("float32", "int8", "int16", "int32", "uint8",
                             "uint16", "uint32", "complex64"),
                    description="output sample type: integers saturate like "
                                "the reference's SignalGeneratorCore<T>; "
                                "complex64 emits the analytic signal for the "
                                "sinusoids (|z| = amplitude) and zero "
                                "imaginary otherwise")
    seed = Setting(default=0, kind="static",
                   description="PRNG seed for the noise signal types")
    frequency = Setting(default=1.0, unit="Hz")
    amplitude = Setting(default=1.0)
    offset = Setting(default=0.0)
    phase = Setting(default=0.0, unit="rad")
    sample_rate = Setting(default=0.0, unit="Hz",
                          description="0 → inherit scheduler sample_rate")
    n_samples = Setting(default=0, kind="static", description="0 = unbounded")
    channels = Setting(default=0, kind="static")

    def out_channels(self, port, in_channels):
        return int(self.settings.get("channels"))

    def out_dtype(self, port, in_dtypes):
        return canonical_dtype(self.settings.get("dtype"))

    def _cast_out(self, y: torch.Tensor) -> torch.Tensor:
        """Saturating cast to the configured output type."""
        dt = canonical_dtype(self.settings.get("dtype"))
        if np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            y = torch.clamp(torch.round(y), float(info.min), float(info.max))
        return y.to(torch_dtype(dt))

    def _fs(self, ctx_rate: float) -> float:
        fs = float(self.settings.get("sample_rate"))
        return fs if fs > 0 else ctx_rate

    def _is_noise(self) -> bool:
        return str(self.settings.get("signal")).endswith("Noise")

    def init_state(self, ctx):
        self._ctx_rate = ctx.sample_rate
        if self._is_noise():
            return noise_ops.noise_init_state(int(self.settings.get("seed")),
                                              ctx.device)
        return phase_state()

    def prepare_params(self, params):
        params = dict(params)
        fs = self._fs(getattr(self, "_ctx_rate", 1.0))
        params["_dphi"] = phase_increment(float(self.settings.get("frequency")), fs)
        ph0 = float(self.settings.get("phase")) / (2.0 * np.pi)
        params["_phase0_u32"] = np.uint32(int((ph0 % 1.0) * 4294967296.0))
        return params

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    @staticmethod
    def _nco(state, ctx) -> tuple[int, int]:
        """(start phase of this step, increment) as host ints."""
        dphi = int(ctx.params.get("_dphi", 0))
        ph0 = int(ctx.params.get("_phase0_u32", 0))
        return (int(state) + ph0) & MASK32, dphi

    @staticmethod
    def _advance(state, dphi: int, n: int) -> torch.Tensor:
        return phase_state(int(state) + dphi * n)

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        ch = ctx.channels["out"]
        amp = float(np.float32(ctx.p("amplitude", 1.0)))
        off = float(np.float32(ctx.p("offset", 0.0)))
        if self._is_noise():
            shape = (n,) if ch == 0 else (ch, n)
            kind = str(self.settings.get("signal"))
            if kind == "UniformNoise":
                y, key = noise_ops.uniform(state, shape, low=-1.0, high=1.0)
            elif kind == "TriangularNoise":
                y, key = noise_ops.triangular(state, shape)
            else:
                y, key = noise_ops.gaussian(state, shape)
            # a*y + o rounded once, as XLA's fused multiply-add rounds it (in
            # float64, whose exact product leaves one rounding to float32)
            y = (y.to(torch.float64) * amp + off).to(torch.float32)
            return key, {"out": self._cast_out(y)}
        start, dphi = self._nco(state, ctx)
        frac = phase_to_frac(nco_phases(start, dphi, n, ctx.device))
        kind = str(self.settings.get("signal"))
        if str(self.settings.get("dtype")) == "complex64":
            # analytic signal for the sinusoids: Sin → A·e^{j(θ-π/2)}
            # (real A·sinθ), Cos → A·e^{jθ}; other types carry zero imaginary
            if kind in ("Sin", "FastSin"):
                z = off + amp * complex_exp(frac - 0.25)
            elif kind in ("Cos", "FastCos"):
                z = off + amp * complex_exp(frac)
            else:
                z = torch.complex(waveform(kind, frac, amplitude=amp, offset=off),
                                  torch.zeros_like(frac))
            z = z.to(torch.complex64)
            if ch:
                z = z.expand(ch, n).contiguous()
            return self._advance(state, dphi, n), {"out": z}
        y = waveform(kind, frac, amplitude=amp, offset=off)
        if ch:
            y = y.expand(ch, n).contiguous()
        return self._advance(state, dphi, n), {"out": self._cast_out(y)}

    def apply_sp(self, state, ins, ctx, local_ctx, axis):
        """Time-sharded lowering: the integer-NCO phase is a pure function of
        global sample position, so each shard generates its local segment from
        a position-offset start phase — no halo, no gather island (exact:
        the uint32 phase wraps identically). Noise signal types run as a
        gather island (the full-length stream drawn once and split —
        sharded == unsharded exactly), as do per-sample param ramps."""
        if self._is_noise() or any(
                np.ndim(ctx.params.get(k, 0.0))
                for k in ("_dphi", "amplitude", "offset")):
            return self.lower_sp(None, state, ins, ctx, local_ctx, axis)
        from ..parallel.halo import nco_shard_apply
        return nco_shard_apply(self, state, ins, local_ctx, axis,
                               int(ctx.params.get("_dphi", 0)),
                               local_ctx[0].out_len["out"])


@register_block("ComplexToneSource")
class ComplexToneSource(SignalGenerator):
    """Complex exponential source e^{j2πft/fs} (baseband tone)."""

    OUT = (Port("out", dtype="complex64"),)

    def out_dtype(self, port, in_dtypes):
        return np.dtype("complex64")   # always complex, ignore dtype setting

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        ch = ctx.channels["out"]
        start, dphi = self._nco(state, ctx)
        amp = float(np.float32(ctx.p("amplitude", 1.0)))
        # factored outer-product NCO: O(√n) transcendentals
        y = complex_exp_ramp(start, dphi, n, amplitude=amp, device=ctx.device)
        off = float(np.float32(ctx.p("offset", 0.0)))
        if off != 0.0:
            y = y + off
        if ch:
            y = y.expand(ch, n).contiguous()
        return self._advance(state, dphi, n), {"out": y}


@register_block("NoiseSource")
class NoiseSource(SourceBlock):
    """Gaussian/uniform noise generated on the device (≈ NoiseGenerator; here
    the JAX package's counter-based threefry stream, bit for bit in the bits:
    ops/noise.py). The state is the PRNG key, a [2] int64 device tensor, split
    once per step."""

    OUT = (Port("out"),)
    noise = Setting(default="gaussian", kind="static",
                    choices=("gaussian", "uniform", "triangular",
                             "complex_gaussian"))
    std = Setting(default=1.0, description="std-dev / half-range")
    mean = Setting(default=0.0)
    seed = Setting(default=0, kind="static")
    channels = Setting(default=0, kind="static")
    n_samples = Setting(default=0, kind="static")

    def out_channels(self, port, in_channels):
        return int(self.settings.get("channels"))

    def out_dtype(self, port, in_dtypes):
        return np.dtype(np.complex64 if self.settings.get("noise") ==
                        "complex_gaussian" else np.float32)

    def init_state(self, ctx):
        return noise_ops.noise_init_state(int(self.settings.get("seed")),
                                          ctx.device)

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        ch = ctx.channels["out"]
        shape = (n,) if ch == 0 else (ch, n)
        kind = self.settings.get("noise")
        std = np.float32(ctx.p("std", 1.0))
        mean = np.float32(ctx.p("mean", 0.0))
        if kind == "gaussian":
            y, key = noise_ops.gaussian(state, shape, std=std, mean=mean)
        elif kind == "uniform":
            y, key = noise_ops.uniform(state, shape, low=mean - std,
                                       high=mean + std)
        elif kind == "triangular":
            y, key = noise_ops.triangular(state, shape, half_range=std, mean=mean)
        else:
            y, key = noise_ops.complex_gaussian(state, shape, std=std)
        return key, {"out": y}


@register_block("Selector")
class Selector(Block):
    """N×M stream router (≈ Selector.hpp:15). ``map_in``/``map_out`` pair up
    connections; unrouted outputs emit zeros, unrouted inputs are dropped.

    Reference parity extras (Selector.hpp:83-95): an optional ``select``
    input (uint32 stream; the last sample of each step picks the monitored
    input, ≈ ``selectSpan.back()``, Selector.hpp:149) and an optional
    ``monitor`` output mirroring the selected input. ``selected_src`` is the
    message-settable equivalent when no select stream is connected.

    Fan-in (several inputs mapped to one output) *sums* here; the reference's
    round-robin interleave is the dedicated :class:`Interleave` block."""

    n_inputs = Setting(default=1, kind="static", limits=(1, 64))
    n_outputs = Setting(default=1, kind="static", limits=(1, 64))
    map_in = Setting(default=(0,), kind="static", description="routing: input idx list")
    map_out = Setting(default=(0,), kind="static", description="routing: output idx list")
    selected_src = Setting(default=0, description="input index mirrored to the "
                                                  "monitor output (≈ _selectedSrc)")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        n_in = int(self.settings.get("n_inputs"))
        n_out = int(self.settings.get("n_outputs"))
        self.in_ports = tuple(Port(f"in{i}") for i in range(n_in)) + (
            Port("select", dtype="uint32", optional=True, asynchronous=True),)
        self.out_ports = tuple(Port(f"out{i}") for i in range(n_out)) + (
            Port("monitor", optional=True),)

    def apply(self, state, ins, ctx):
        m_in = list(self.settings.get("map_in"))
        m_out = list(self.settings.get("map_out"))
        outs = {}
        n_in = int(self.settings.get("n_inputs"))
        example = ins["in0"] if "in0" in ins else next(iter(ins.values()))
        for o in range(int(self.settings.get("n_outputs"))):
            routed = [ins[f"in{i}"] for i, oo in zip(m_in, m_out) if oo == o]
            if routed:
                outs[f"out{o}"] = routed[0] if len(routed) == 1 else sum(routed)
            else:
                outs[f"out{o}"] = torch.zeros_like(example)
        # monitor: mirror the dynamically selected input (Selector.hpp:239-243)
        stacked = torch.stack([ins[f"in{i}"] for i in range(n_in)], dim=0)
        if "select" in ins:
            sel = ins["select"][..., -1].clamp(0, n_in - 1)   # selectSpan.back()
            picked = torch.index_select(stacked, 0, sel.reshape(-1))
            outs["monitor"] = picked.reshape(*sel.shape, *stacked.shape[1:])
        else:
            sel = min(max(int(ctx.p("selected_src", 0)), 0), n_in - 1)
            outs["monitor"] = stacked[sel]
        return state, outs


@register_block("Interleave")
class Interleave(Block):
    """Round-robin stream combiner — the reference Selector's synchronised
    fan-in semantics (Selector.hpp:60-66: inputs mapped to one output emit
    ``in0[0], in1[0], …, in0[1], in1[1], …``) as a dedicated block, because a
    per-port rate change rides the block-level ``ratio``. ``chunk_size``
    samples are taken from each input per visit."""

    n_inputs = Setting(default=2, kind="static", limits=(1, 64))
    chunk_size = Setting(default=1, kind="static", limits=(1, None))

    OUT = (Port("out"),)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.in_ports = tuple(
            Port(f"in{i}") for i in range(int(self.settings.get("n_inputs"))))

    @property
    def ratio(self) -> Fraction:
        return Fraction(int(self.settings.get("n_inputs")))

    @property
    def alignment(self) -> int:
        return int(self.settings.get("chunk_size"))

    def apply(self, state, ins, ctx):
        k = int(self.settings.get("n_inputs"))
        cs = int(self.settings.get("chunk_size"))
        xs = [ins[f"in{i}"] for i in range(k)]
        t = xs[0].shape[-1]
        # [..., T] per input → [..., T/cs, k, cs] → [..., k·T]
        parts = [x.reshape(*x.shape[:-1], t // cs, 1, cs) for x in xs]
        out = torch.cat(parts, dim=-2)
        return state, {"out": out.reshape(*xs[0].shape[:-1], k * t)}


@register_block("Deinterleave")
class Deinterleave(Block):
    """Round-robin stream splitter (inverse of :class:`Interleave`)."""

    n_outputs = Setting(default=2, kind="static", limits=(1, 64))
    chunk_size = Setting(default=1, kind="static", limits=(1, None))

    IN = (Port("in"),)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.out_ports = tuple(
            Port(f"out{i}") for i in range(int(self.settings.get("n_outputs"))))

    @property
    def ratio(self) -> Fraction:
        return Fraction(1, int(self.settings.get("n_outputs")))

    @property
    def alignment(self) -> int:
        return int(self.settings.get("n_outputs")) * \
            int(self.settings.get("chunk_size"))

    def apply(self, state, ins, ctx):
        k = int(self.settings.get("n_outputs"))
        cs = int(self.settings.get("chunk_size"))
        x = ins["in"]
        t = x.shape[-1]
        parts = x.reshape(*x.shape[:-1], t // (k * cs), k, cs)
        return state, {f"out{i}":
                       parts[..., i, :].reshape(*x.shape[:-1], t // k)
                       for i in range(k)}


# -- converters (≈ ConverterBlocks.hpp) ----------------------------------------

def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as the JAX package casts: complex → real keeps the
    real part."""
    dt = canonical_dtype(dtype)
    if x.is_complex() and not np.issubdtype(dt, np.complexfloating):
        x = x.real
    return x.to(torch_dtype(dt))


@register_block("Convert")
class Convert(Block):
    """dtype cast (≈ Convert<T,U>); target dtype is a static setting."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    to = Setting(default="float32", kind="static", description="target dtype")

    def out_dtype(self, port, in_dtypes):
        return self.settings.get("to")

    def apply(self, state, ins, ctx):
        return state, {"out": _cast(ins["in"], self.settings.get("to"))}


@register_block("ScalingConvert")
class ScalingConvert(Convert):
    scale = Setting(default=1.0)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        # the scale takes the input's type first, as in the JAX package
        scale = np.asarray(ctx.p("scale", 1.0)).astype(ctx.dtype("in"))
        y = x * torch.from_numpy(np.asarray(scale)).to(x.device)
        return state, {"out": _cast(y, self.settings.get("to"))}


@register_block("ComplexToReal")
class ComplexToReal(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"].real.contiguous()}


@register_block("ComplexToImag")
class ComplexToImag(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"].imag.contiguous()}


@register_block("ToRealImag")
class ToRealImag(Block):
    """Complex → (real, imag) component streams (≈ ConverterBlocks ToRealImag)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("real", dtype="float32"), Port("imag", dtype="float32"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        return state, {"real": x.real.contiguous(), "imag": x.imag.contiguous()}


@register_block("ComplexToMagPhase")
class ComplexToMagPhase(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("mag", dtype="float32"), Port("phase", dtype="float32"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        return state, {"mag": x.abs(), "phase": x.angle()}


@register_block("Arg")
class Arg(Block):
    """Complex argument/angle in radians (≈ ConverterBlocks Arg)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"].angle()}


@register_block("MagPhaseToComplex")
class MagPhaseToComplex(Block):
    """(magnitude, phase) → complex (≈ ConverterBlocks.hpp:219)."""

    IN = (Port("mag", dtype="float32"), Port("phase", dtype="float32"))
    OUT = (Port("out", dtype="complex64"),)

    def apply(self, state, ins, ctx):
        return state, {"out": torch.polar(ins["mag"], ins["phase"])}


@register_block("RealImagToComplex")
class RealImagToComplex(Block):
    IN = (Port("real", dtype="float32"), Port("imag", dtype="float32"))
    OUT = (Port("out", dtype="complex64"),)

    def apply(self, state, ins, ctx):
        return state, {"out": torch.complex(ins["real"], ins["imag"])}


@register_block("ComplexToInterleaved")
class ComplexToInterleaved(Block):
    """complex64 [T] → float32 [2T] (re,im interleaved); rate 2/1."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)

    @property
    def ratio(self):
        return Fraction(2, 1)

    def apply(self, state, ins, ctx):
        x = ins["in"].contiguous()
        return state, {"out": torch.view_as_real(x).reshape(*x.shape[:-1], -1)}


@register_block("InterleavedToComplex")
class InterleavedToComplex(Block):
    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="complex64"),)

    @property
    def ratio(self):
        return Fraction(1, 2)

    @property
    def alignment(self):
        return 2

    def apply(self, state, ins, ctx):
        x = ins["in"]
        xr = x.reshape(*x.shape[:-1], -1, 2).contiguous()
        return state, {"out": torch.view_as_complex(xr)}


@register_block("DegToRad")
class DegToRad(Block):
    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"] * float(np.float32(np.pi / 180.0))}


@register_block("RadToDeg")
class RadToDeg(Block):
    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"] * float(np.float32(180.0 / np.pi))}
