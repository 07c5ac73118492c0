"""Basic sources (≈ reference blocks/basic/SignalGenerator.hpp:25) and the
device noise source.

The NCO phase state is a 0-d int64 *host* tensor holding a uint32 value: the
phase is a host integer wherever it is used (the start phase of a device ramp),
so keeping it on the host costs no device→host read per step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.block import Port, SourceBlock
from ..core.errors import GrError
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
    The noise types are not ported to this package yet and raise.
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

    def init_state(self, ctx):
        self._ctx_rate = ctx.sample_rate
        if str(self.settings.get("signal")).endswith("Noise"):
            raise GrError(f"{self.name}: noise signal types are not ported to "
                          f"this package yet", block=self.name)
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
            y, key = noise_ops.uniform_noise(state, shape, low=mean - std,
                                             high=mean + std)
        elif kind == "triangular":
            y, key = noise_ops.triangular(state, shape, half_range=std, mean=mean)
        else:
            y, key = noise_ops.complex_gaussian(state, shape, std=std)
        return key, {"out": y}
