"""Squelch blocks (gr-analog equivalents): power squelch and CTCSS tone
squelch, both on the device (the JAX package's ``blocks/squelch.py``).

- :class:`PowerSquelch` (≈ gr pwr_squelch_cc/ff + simple_squelch_cc):
  a one-pole envelope of |x|² gates the stream sample-accurately. The
  envelope recurrence is ``ops/iir.one_pole_apply``'s parallel form, not a
  loop over samples.
- :class:`CtcssSquelch` (≈ gr ctcss_squelch_ff): per-chunk Goertzel
  power at the sub-audible tone frequency, compared against the total
  chunk power, gates whole chunks (``ops/farrow.goertzel_power``: one
  product over the chunk grid).

Thresholds are dynamic settings (``ctx.p``) — changing them mid-run is a
parameter update, not a recompile.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.farrow import goertzel_power
from ..ops.iir import _f32, one_pole_apply


@register_block("PowerSquelch")
class PowerSquelch(Block):
    """Mute samples whose smoothed power falls below ``threshold_db``:
    env[n] = (1−α)·env[n−1] + α·|x[n]|², y[n] = x[n]·[env[n] ≥ thr].

    ``threshold_db`` is dynamic (no recompile); ``alpha`` sets the
    envelope time constant (gr pwr_squelch's alpha).  The gr ``ramp``
    option is intentionally absent — a hard gate on the smoothed
    envelope is already click-free for practical alphas."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    threshold_db = Setting(default=-40.0, unit="dB",
                           description="mute below this smoothed power")
    alpha = Setting(default=1e-3, kind="static", limits=(1e-9, 1.0),
                    description="envelope smoothing per sample")
    invert = Setting(default=False, kind="static",
                     description="mute ABOVE the threshold instead")

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        return torch.zeros(() if ch == 0 else (ch,), dtype=torch.float32,
                           device=ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        a = float(self.settings.get("alpha"))
        p = (torch.abs(x) ** 2).to(torch.float32)
        env, last = one_pole_apply(a * p, _f32(1.0 - a), state)
        # the threshold is a host value: 10^(dB/10) in float32 on the host
        thr_db = np.float32(ctx.p("threshold_db", -40.0))
        thr = float(np.power(np.float32(10.0), thr_db / np.float32(10.0)))
        gate = env >= thr
        if bool(self.settings.get("invert")):
            gate = ~gate
        return last, {"out": x * gate.to(x.dtype)}


@register_block("CtcssSquelch")
class CtcssSquelch(Block):
    """CTCSS sub-audible tone squelch for demodulated FM audio: per
    ``chunk`` samples, the Goertzel power at ``frequency`` must exceed
    ``level`` × the mean chunk power for the chunk to pass (muted
    otherwise).  Gate decisions are chunk-granular like the gr block's
    internal Goertzel window."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    frequency = Setting(default=88.5, kind="static", unit="Hz",
                        description="CTCSS tone (67–254 Hz)")
    level = Setting(default=0.1,
                    description="tone-power : mean-power gate ratio")
    chunk = Setting(default=2048, kind="static", limits=(64, 1 << 20))
    sample_rate_in = Setting(default=0.0, kind="static",
                             description="0 → inherit resolved edge rate")

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def apply(self, state, ins, ctx):
        n = int(self.settings.get("chunk"))
        fs = float(self.settings.get("sample_rate_in")) or ctx.sample_rate
        f = float(self.settings.get("frequency"))
        x = ins["in"]
        flat = x.reshape(-1, n)
        tone = goertzel_power(flat, freq=f, sample_rate=fs)
        xf = flat.to(torch.float32)
        total = torch.mean(xf * xf, dim=-1)
        lvl = _f32(ctx.p("level", 0.1))
        gate = tone >= lvl * torch.clamp(total, min=_f32(1e-30))
        y = flat * gate[:, None].to(x.dtype)
        return state, {"out": y.reshape(x.shape)}
