"""Classic stream utility blocks (GNU Radio staples; the JAX package's
``blocks/util_blocks.py``): Throttle, MovingAverage, DC blocker, Threshold,
Mute, KeepOneInN, Repeat, Integrate, PeakDetector, SampleAndHold and
DiffPhasor."""

from __future__ import annotations

import time
from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.stream import torch_dtype
from ..ops.fir import fir_apply
from ..ops.iir import one_pole_apply


@register_block("Throttle")
class Throttle(Block):
    """Pass-through that paces the *host pump* to ``sample_rate`` wall-clock
    (like GNU Radio's throttle: keeps a flowgraph without hardware from
    free-running). Device compute is untouched; the sleep happens in the host
    tag hook."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    sample_rate = Setting(default=32000.0, unit="Hz", limits=(1.0, 1e12))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._t0 = None
        self._served = 0

    def start(self):
        self._t0 = None
        self._served = 0

    def emit_tags(self, ctx):  # runs once per step on the host
        n = next(iter(ctx.in_len.values()), 0)
        fs = float(self.settings.get("sample_rate"))
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        self._served += n
        target = self._t0 + self._served / fs
        if target > now:
            time.sleep(min(target - now, 1.0))
        return []

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"]}


@register_block("MovingAverage")
class MovingAverage(Block):
    """Length-N moving average as a uniform-tap FIR (``fir_apply``: the
    ``fir_banded`` kernel on the card); carried state = last N−1 inputs.
    Windows longer than 4096 take prefix sums, whose error grows with
    block_len × signal mean (cancellation of large prefix sums), so the FIR
    path is also the accurate one."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    length = Setting(default=16, kind="static", limits=(1, 1 << 20))
    scale = Setting(default=0.0, description="0 → 1/length (true average)")

    def init_state(self, ctx):
        n = int(self.settings.get("length"))
        ch = ctx.channels.get("in", 0)
        shape = (n - 1,) if ch == 0 else (ch, n - 1)
        return torch.zeros(shape, dtype=torch_dtype(ctx.dtype("in", np.float32)),
                           device=ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("length"))
        if n == 1:
            return state, {"out": x}
        scale = float(self.settings.get("scale")) or (1.0 / n)
        if n <= 4096:
            taps = np.full(n, scale, np.float32)
            y, new_state = fir_apply(x, taps, state.to(x.dtype))
            return new_state, {"out": y.to(x.dtype)}
        xc = torch.cat([state.to(x.dtype), x], dim=-1)
        c = torch.cumsum(xc, dim=-1)
        c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)  # prefix sums
        y = (c[..., n:] - c[..., :-n]) * float(np.float32(scale))
        return xc[..., -(n - 1):], {"out": y.to(x.dtype)}

    def sp_halo(self, ctx):
        # state is exactly the last length−1 inputs → default halo converters
        return int(self.settings.get("length")) - 1


@register_block("DcBlocker")
class DcBlocker(Block):
    """Single-pole DC-removal high-pass: y = x − x⁻¹ + R·y⁻¹ (the port's
    ``one_pole_apply``: a parallel recurrence)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    pole = Setting(default=0.995, kind="static", limits=(0.5, 0.999999))

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        shape = () if ch == 0 else (ch,)
        return {"u": torch.zeros(shape, dtype=torch.float32, device=ctx.device),
                "x_last": torch.zeros(shape, dtype=torch.float32,
                                      device=ctx.device)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        r = float(np.float32(self.settings.get("pole")))
        prev = torch.cat([state["x_last"][..., None], x[..., :-1]], dim=-1)
        y, u_last = one_pole_apply(x - prev, r, state["u"])
        return ({"u": u_last, "x_last": x[..., -1]},
                {"out": y.to(torch.float32)})


@register_block("Threshold")
class Threshold(Block):
    """Hysteresis-free comparator: 1.0 where x ≥ level else 0.0."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    level = Setting(default=0.0)

    def apply(self, state, ins, ctx):
        lvl = float(np.float32(ctx.p("level", 0.0)))
        return state, {"out": (ins["in"] >= lvl).to(torch.float32)}


@register_block("MuteSwitch")
class MuteSwitch(Block):
    """Runtime mute: zeros the stream while ``mute`` is set (dynamic — no
    recompile; flip it via messages or block message edges)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    mute = Setting(default=False, dtype=np.bool_)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"] * (0 if ctx.p("mute", False) else 1)}


@register_block("KeepOneInN")
class KeepOneInN(Block):
    """Every N-th sample (≈ gr keep_one_in_n): ratio 1/N, the kept sample
    is the one at ``offset`` within each group."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    n = Setting(default=2, kind="static", limits=(1, 1 << 20))
    offset = Setting(default=0, kind="static")

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("n")))

    @property
    def alignment(self):
        return int(self.settings.get("n"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("n"))
        off = int(self.settings.get("offset")) % n
        return state, {"out": x.reshape(x.shape[:-1] + (-1, n))[..., off]}


@register_block("Repeat")
class Repeat(Block):
    """Repeat each sample N times (≈ gr repeat): ratio N/1."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    n = Setting(default=2, kind="static", limits=(1, 1 << 20))

    @property
    def ratio(self):
        return Fraction(int(self.settings.get("n")), 1)

    def apply(self, state, ins, ctx):
        return state, {"out": torch.repeat_interleave(
            ins["in"], int(self.settings.get("n")), dim=-1)}


@register_block("Integrate")
class Integrate(Block):
    """Sum groups of N samples into one (≈ gr integrate): ratio 1/N."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    n = Setting(default=2, kind="static", limits=(1, 1 << 20))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("n")))

    @property
    def alignment(self):
        return int(self.settings.get("n"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("n"))
        return state, {"out": x.reshape(x.shape[:-1] + (-1, n)).sum(
            dim=-1, dtype=x.dtype)}


@register_block("PeakDetector")
class PeakDetector(Block):
    """1.0 at strict local maxima above ``threshold``, else 0.0 (≈ gr
    peak_detector's steady-state behavior). The one-sample halo at each
    step boundary is carried in state so peaks at seams are not missed."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    threshold = Setting(default=0.0)

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        shape = (2,) if ch == 0 else (ch, 2)
        return torch.full(shape, -float("inf"), dtype=torch.float32,
                          device=ctx.device)

    def apply(self, state, ins, ctx):
        ext = torch.cat([state, ins["in"]], dim=-1)
        left, mid, right = ext[..., :-2], ext[..., 1:-1], ext[..., 2:]
        thr = float(np.float32(ctx.p("threshold", 0.0)))
        peak = (mid > left) & (mid > right) & (mid > thr)
        # output is aligned one sample behind the input (the last sample's
        # peak-ness needs its right neighbor — it resolves next step)
        return ext[..., -2:], {"out": peak.to(torch.float32)}


@register_block("SampleAndHold")
class SampleAndHold(Block):
    """y[n] = x[n] while ctrl[n] > 0, else the last sampled value (≈ gr
    sample_and_hold); the held value carries across steps.

    Loop-free: each output takes the input at the last open gate at or
    before it (a running maximum of the gate's indices), the carried value
    before the first — the sequential hold's values exactly."""

    IN = (Port("in"), Port("ctrl", dtype="float32"))
    OUT = (Port("out"),)

    def init_state(self, ctx):
        if ctx.channels.get("in", 0):
            raise GrError("SampleAndHold holds a single-channel stream, as "
                          "the JAX package's scan over samples does")
        return torch.zeros((), dtype=torch.float32, device=ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        t = x.shape[-1]
        idx = torch.arange(t, device=x.device)
        last = torch.cummax(torch.where(ins["ctrl"] > 0.0, idx, -1), dim=-1)[0]
        y = torch.where(last >= 0, x[last.clamp(min=0)], state.to(x.dtype))
        held = y[-1] if t else state.to(x.dtype)
        return (held.real if held.is_complex() else held).to(torch.float32), \
            {"out": y}


@register_block("DiffPhasor")
class DiffPhasor(Block):
    """Differential phasor y[n] = x[n]·x̄[n−1] (≈ gr diff_phasor_cc) — the
    complex form of differential decoding for DPSK constellations; one
    carried sample of state."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        return torch.ones(() if ch == 0 else (ch,), dtype=torch.complex64,
                          device=ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        prev = torch.cat([state[..., None], x[..., :-1]], dim=-1)
        return x[..., -1], {"out": (x * prev.conj()).to(torch.complex64)}

    def sp_halo(self, ctx):
        return 1

    def sp_state_to_tail(self, state, ctx):
        return state[..., None]

    def sp_tail_to_state(self, tail, state, ctx):
        return tail[..., 0].to(torch.complex64)
