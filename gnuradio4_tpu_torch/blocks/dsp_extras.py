"""Beyond-reference DSP blocks of the JAX package's ``blocks/dsp_extras.py``.

Only ``Agc`` is ported; the Farrow resampler, the Goertzel detector and the
PLL of that file are not ported yet.
"""

from __future__ import annotations

import torch

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.farrow import agc_apply


@register_block("Agc")
class Agc(Block):
    """Automatic gain control: drives |y| toward ``reference`` with loop gain
    ``rate`` (per-sample feedback, a loop over samples; channels advance in
    parallel)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    reference = Setting(default=1.0, limits=(1e-9, 1e9))
    rate = Setting(default=1e-3, limits=(1e-9, 1.0))
    max_gain = Setting(default=65536.0, kind="static")

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        return torch.ones(() if ch == 0 else (ch,), dtype=torch.float32,
                          device=ctx.device)

    def apply(self, state, ins, ctx):
        y, g = agc_apply(ins["in"], state,
                         reference=float(self.settings.get("reference")),
                         rate=float(self.settings.get("rate")),
                         max_gain=float(self.settings.get("max_gain")))
        return g, {"out": y}
