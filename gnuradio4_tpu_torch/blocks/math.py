"""Arithmetic blocks (≈ reference blocks/math/Math.hpp, Rotator.hpp).

Add/Subtract/Multiply/Divide over N inputs and the *Const variants (suite
config 6's cascade is MultiplyConst/DivideConst), ``Abs``, ``Conjugate``,
``Log10`` — each one elementwise torch op — and the complex ``Rotator`` (NCO
frequency shifter), whose constant-frequency path is the hand-written
``nco_mix`` kernel on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.cuda_kernels import nco_mix
from ..ops.signal import (MASK32, complex_exp, complex_exp_ramp,  # noqa: F401
                          nco_phases, phase_increment, phase_to_frac)
from ..utils.uncertain import UncertainValue
from .basic import phase_state
from .uncertain import check_uncertain_channels, uv_join, uv_split


class _NAry(Block):
    """N-input elementwise reducer; inputs in0..in{N-1} (≈ multi-port Add etc.).

    ``uncertain=True`` runs the reducer on 2-plane (value, sigma) streams with
    first-order Gaussian propagation — the sample type is UncertainValue, as in
    the reference's ``Add<gr::UncertainValue<float>>`` registrations
    (Math.hpp:68-71)."""

    OUT = (Port("out"),)
    n_inputs = Setting(default=2, kind="static", limits=(1, 64))
    uncertain = Setting(default=False, kind="static",
                        description="inputs are 2-plane (value, sigma) streams")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        n = int(self.settings.get("n_inputs"))
        self.in_ports = tuple(Port(f"in{i}") for i in range(n))

    def _op(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, state, ins, ctx):
        uncertain = self.settings.get("uncertain")
        if uncertain:
            for p in self.in_ports:
                check_uncertain_channels(ctx, p.name, self.name)
        vals = [uv_split(ins[p.name]) if uncertain else ins[p.name]
                for p in self.in_ports]
        out = vals[0]
        for v in vals[1:]:
            out = self._op(out, v)
        return state, {"out": uv_join(out) if uncertain else out}


@register_block("Add")
class Add(_NAry):
    def _op(self, a, b):
        return a + b


@register_block("Subtract")
class Subtract(_NAry):
    def _op(self, a, b):
        return a - b


@register_block("Multiply")
class Multiply(_NAry):
    def _op(self, a, b):
        return a * b


@register_block("Divide")
class Divide(_NAry):
    def _op(self, a, b):
        return a / b


class _ConstOp(Block):
    """Elementwise op against a constant. ``value`` is SAMPLE_ACCURATE: a tag
    carrying it switches the constant at the tag's exact sample (a per-sample
    float32 ramp for that step). With ``uncertain=True`` the stream is a
    2-plane (value, sigma) pair and the constant itself may carry an
    uncertainty (``value_sigma``) — ≈ the reference's
    ``AddConst<gr::UncertainValue<T>>`` (Math.hpp:25-28), whose constant is an
    UncertainValue."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    SAMPLE_ACCURATE = frozenset({"value"})   # tag-driven changes hit at index k
    value = Setting(default=1.0, description="constant operand")
    uncertain = Setting(default=False, kind="static",
                        description="stream is a 2-plane (value, sigma) pair")
    value_sigma = Setting(default=0.0, limits=(0.0, None),
                          description="1-sigma uncertainty of the constant "
                                      "(uncertain mode)")

    def _op(self, x: torch.Tensor, c) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, state, ins, ctx):
        x = ins["in"]
        v = ctx.p("value", 1.0)
        if self.settings.get("uncertain"):
            check_uncertain_channels(ctx, "in", self.name)

            def f32(a):
                return torch.from_numpy(np.asarray(a, np.float32)).to(x.device)
            c = UncertainValue(f32(v), f32(ctx.p("value_sigma", 0.0)))
            return state, {"out": uv_join(self._op(uv_split(x), c))}
        if np.ndim(v):     # per-sample ramp (tag-accurate value switch)
            c = torch.from_numpy(np.asarray(v, np.float32)).to(x.device).to(x.dtype)
        else:              # the constant rounded to the stream's type
            c = torch.tensor(np.asarray(v).item(), dtype=x.dtype).item()
        return state, {"out": self._op(x, c)}


@register_block("AddConst")
class AddConst(_ConstOp):
    def _op(self, x, c):
        return x + c


@register_block("SubtractConst")
class SubtractConst(_ConstOp):
    def _op(self, x, c):
        return x - c


@register_block("MultiplyConst")
class MultiplyConst(_ConstOp):
    def _op(self, x, c):
        return x * c


@register_block("DivideConst")
class DivideConst(_ConstOp):
    def _op(self, x, c):
        if not torch.is_tensor(c) and torch.is_tensor(x) and x.is_cuda:
            # CUDA divides by a host scalar as a multiply by its reciprocal;
            # a device scalar keeps the true quotient, as on the CPU
            c = self._divisor(c, x)
        return x / c

    def _divisor(self, c, x: torch.Tensor) -> torch.Tensor:
        key = (c, x.dtype, x.device)
        if getattr(self, "_div_key", None) != key:
            self._div_key = key
            self._div = torch.tensor(c, dtype=x.dtype, device=x.device)
        return self._div


@register_block("Rotator")
class Rotator(Block):
    """Complex NCO frequency shifter: y[n] = x[n]·e^{j2πf/fs·n} (≈ Rotator.hpp:14).

    Integer-NCO phase state (a uint32 value in a 0-d int64 host tensor) —
    drift-free over unbounded streams; the phase increment is derived on the
    host in float64 (``prepare_params``). A constant increment mixes through
    the ``nco_mix`` kernel (its plain version on the CPU); a tag-ramped
    per-sample increment runs as int64 torch ops masked to 32 bits.
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    SAMPLE_ACCURATE = frozenset({"frequency_shift"})
    frequency_shift = Setting(default=0.0, unit="Hz",
                              description="rotation frequency (± = direction)")
    # reference surface (Rotator.hpp:33-34): XOR-alternative to
    # frequency_shift; activating it also switches to the reference's
    # pre-increment phase convention (processOne adds the increment BEFORE
    # applying, Rotator.hpp:53) with initial_phase as the chunk offset —
    # the frequency_shift surface keeps the zero-phase-at-sample-0 convention
    phase_increment = Setting(default=0.0, unit="rad",
                              description="radians added per sample "
                                          "(alternative to frequency_shift)")
    initial_phase = Setting(default=0.0, unit="rad")

    def __init__(self, name=None, sample_rate: float | None = None,
                 **settings):
        if "frequency_shift" in settings and "phase_increment" in settings:
            raise GrError("cannot set both 'frequency_shift' and "
                          "'phase_increment' (XOR, Rotator.hpp:46)")
        self._use_increment = "phase_increment" in settings
        super().__init__(name=name, **settings)
        self._sample_rate_hint = float(sample_rate or 1.0)

    def prepare_params(self, params):
        params = dict(params)
        if self._use_increment:
            inc = float(self.settings.get("phase_increment"))
            frac = inc / (2.0 * np.pi)
            frac -= np.floor(frac)
            params["_dphi"] = np.uint32(round(frac * 4294967296.0)
                                        % 4294967296)
            # pre-increment + initial phase as a constant offset
            params["_phoff"] = np.float32(
                float(self.settings.get("initial_phase")) + inc)
        else:
            params["_dphi"] = phase_increment(
                float(self.settings.get("frequency_shift")),
                self._sample_rate_hint)
            params["_phoff"] = np.float32(
                float(self.settings.get("initial_phase")))
        return params

    def tag_param_ramps(self, events, n):
        """frequency_shift tag at index k → per-sample uint32 phase-increment
        array (the derived param, not the raw Hz value): the NCO switches
        frequency at exactly sample k with continuous phase."""
        fs = self._sample_rate_hint
        f = np.full(n, float(self.settings.get("frequency_shift")), np.float64)
        for k, m in events:
            if "frequency_shift" in m:
                f[min(max(k, 0), n):] = float(m["frequency_shift"])
        frac = f / np.float64(fs)
        frac -= np.floor(frac)
        return {"_dphi": (np.round(frac * 4294967296.0)
                          % 4294967296.0).astype(np.uint32)}

    def init_state(self, ctx):
        self._sample_rate_hint = ctx.sample_rate
        return phase_state()

    def apply(self, state, ins, ctx):
        x = ins["in"].to(torch.complex64)
        dphi = ctx.params.get("_dphi", np.uint32(0))
        phase = int(state)
        if np.ndim(dphi):   # per-sample increments (tag-accurate frequency ramp)
            d_host = np.asarray(dphi, np.int64)
            d = torch.from_numpy(d_host).to(x.device)
            ph = (torch.cumsum(d, 0) - d + phase) & MASK32     # exclusive, wraps
            y = x * complex_exp(phase_to_frac(ph))
            new_phase = phase_state(phase + int(d_host.sum()))
        else:
            y, nxt = nco_mix(x.contiguous(), phase, int(dphi))
            new_phase = phase_state(nxt)
        phoff = float(ctx.params.get("_phoff", np.float32(0.0)))
        if phoff != 0.0:
            y = y * complex(np.exp(1j * np.float32(phoff)).astype(np.complex64))
        return new_phase, {"out": y}

    def apply_sp(self, state, ins, ctx, local_ctx, axis):
        """Time-sharded lowering: per-shard integer phase offset (exact, no
        collective); per-sample dphi ramps use the gather island.
        ``nco_shard_apply`` re-enters ``apply`` with the full params, so
        ``_phoff`` is applied once, there."""
        dphi = ctx.params.get("_dphi", np.uint32(0))
        if np.ndim(dphi):
            return self.lower_sp(None, state, ins, ctx, local_ctx, axis)
        from ..parallel.halo import nco_shard_apply
        return nco_shard_apply(self, state, ins, local_ctx, axis, int(dphi),
                               ins[0]["in"].shape[-1])


@register_block("Abs")
class Abs(Block):
    IN = (Port("in"),)
    OUT = (Port("out"),)

    def out_dtype(self, port, in_dtypes):
        dt = next(iter(in_dtypes.values()), np.float32)
        return np.dtype(np.float32) if np.dtype(dt) == np.dtype(np.complex64) \
            else dt

    def apply(self, state, ins, ctx):
        return state, {"out": torch.abs(ins["in"])}


@register_block("Conjugate")
class Conjugate(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)

    def apply(self, state, ins, ctx):
        return state, {"out": torch.conj(ins["in"]).resolve_conj()}


@register_block("Log10")
class Log10(Block):
    """20·k·log10(|x|) convenience block (dB conversion)."""

    IN = (Port("in"),)
    OUT = (Port("out", dtype="float32"),)
    scale = Setting(default=20.0)
    floor = Setting(default=1e-12, kind="static")

    def apply(self, state, ins, ctx):
        x = ins["in"]
        mag = torch.abs(x) if x.is_complex() else x
        f = float(self.settings.get("floor"))
        y = float(np.float32(ctx.p("scale", 20.0))) * \
            torch.log10(torch.clamp(mag.to(torch.float32), min=f))
        return state, {"out": y}
