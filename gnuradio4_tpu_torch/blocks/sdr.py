"""SDR demodulation blocks (≈ reference blocks/filter IQDemodulator,
FrequencyEstimator.hpp)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.demod import quadrature_demod


@register_block("QuadratureDemod")
class QuadratureDemod(Block):
    """FM discriminator y[n] = gain·arg(x[n]·x̄[n−1]) (state: one carried sample)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)
    gain = Setting(default=1.0, description="rad→output scaling (fs/(2π·Δf))")

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        shape = () if ch == 0 else (ch,)
        return torch.ones(shape, dtype=torch.complex64, device=ctx.device)

    def absorb_rotation(self, desc, port) -> bool:
        """Rotation-absorption consumer hook: a residual e^{jθ(m)} with θ
        linear in m shifts arg(x[m]·x̄[m−1]) by the CONSTANT Δθ — absorbed as
        a phasor folded into the demod, saving the producer's NCO pass."""
        return port == "in"

    def apply(self, state, ins, ctx):
        gain = float(np.float32(ctx.p("gain", 1.0)))
        desc = getattr(self, "_absorbed_rotation", None) or {}
        rot = None
        if "in" in desc:
            # residual per-sample phase increment → constant phasor folded
            # INSIDE arg (exact (−π,π] wrap match with the de-rotated stream)
            frac = (desc["in"]["dphi_out"] % 4294967296) / 4294967296.0
            rot = complex(np.exp(2j * np.pi * frac))
        y, last = quadrature_demod(ins["in"], state, gain=gain, rot=rot)
        return last, {"out": y}
