"""Adaptive channel equalizers (the JAX package's ``blocks/equalizer.py``;
≈ GNU Radio's cma_equalizer_cc / lms_dd_equalizer_cc).

Block-LMS / block-CMA: the taps update once per ``update_len`` symbols from
the gradient averaged over the sub-block, so each update is a frames × taps
product; the updates run one after the other, one iteration of device ops
per sub-block with no read back to the host. Block-gradient adaptation is
the standard fast-LMS formulation: the same fixed point as per-symbol LMS
with slightly slower time constants.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.cuda_kernels import device_constant
from ..ops.digital import make_constellation
from ..ops.precision import check_f32_matmul


class _BlockEqualizer(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    num_taps = Setting(default=11, kind="static", limits=(1, 256))
    gain = Setting(default=0.01, kind="static", limits=(1e-8, 1.0),
                   description="adaptation step size mu")
    update_len = Setting(default=64, kind="static", limits=(1, 8192),
                         description="symbols per tap update (block gradient)")

    def init_state(self, ctx):
        k = int(self.settings.get("num_taps"))
        taps = torch.zeros((k,), dtype=torch.complex64, device=ctx.device)
        taps[k // 2] = 1.0
        return {"taps": taps,
                "hist": torch.zeros((k - 1,), dtype=torch.complex64,
                                    device=ctx.device)}

    def _error(self, y: torch.Tensor) -> torch.Tensor:
        """The gradient-driving error term e of the equalized symbols ``y``."""
        raise NotImplementedError

    def apply(self, state, ins, ctx):
        x = ins["in"]
        k = int(self.settings.get("num_taps"))
        mu = float(np.float32(self.settings.get("gain")))
        ul = int(self.settings.get("update_len"))
        xa = torch.cat([state["hist"], x], dim=-1)
        n = x.shape[-1]
        nblk = max(n // ul, 1)
        ul_eff = n // nblk
        check_f32_matmul(type(self).__name__)
        F = xa.unfold(-1, k, 1)                     # [n, k]: row i = xa[i:i+k]
        w = state["taps"].to(torch.complex64)
        ys = []
        for b in range(nblk):
            fb = F[b * ul_eff:(b + 1) * ul_eff]
            y = fb @ w                              # [ul] equalized symbols
            e = self._error(y)
            # block gradient of the cost wrt conj(w): mean e·conj(window)
            w = w - torch.mean(e[:, None] * fb.conj(), dim=0) * mu
            # keep taps bounded (divergence guard; CMA can blow up at high mu)
            nrm = torch.sqrt(torch.sum(w.abs() ** 2))
            w = torch.where(nrm > 4.0, w * (4.0 / nrm), w)
            ys.append(y)
        if n > nblk * ul_eff:                       # equalize the remainder
            ys.append(F[nblk * ul_eff:n] @ w)
        y = torch.cat(ys) if ys else x.new_zeros(0)
        return ({"taps": w, "hist": xa[n:n + k - 1]},
                {"out": y.to(torch.complex64)})


@register_block("CmaEqualizer")
class CmaEqualizer(_BlockEqualizer):
    """Constant-modulus (Godard) blind equalizer: drives |y|² toward
    ``modulus`` (1.0 for PSK). Blind — leaves a phase ambiguity; follow with
    a carrier loop. ≈ GNU Radio cma_equalizer_cc, block-gradient
    formulation."""

    modulus = Setting(default=1.0, kind="static", limits=(1e-6, 1e6))

    def _error(self, y):
        r = float(np.float32(self.settings.get("modulus")))
        return y * (y.abs() ** 2 - r)


@register_block("LmsDDEqualizer")
class LmsDDEqualizer(_BlockEqualizer):
    """Decision-directed LMS equalizer: error against the nearest
    constellation point (needs carrier lock first — run after a carrier
    loop, or seed with CmaEqualizer). ≈ GNU Radio lms_dd_equalizer_cc."""

    constellation = Setting(default="qpsk", kind="static",
                            choices=("bpsk", "qpsk", "8psk", "qam16"))

    def _error(self, y):
        pts = device_constant(make_constellation(
            str(self.settings.get("constellation"))), y.device)
        d = pts[torch.argmin((y[:, None] - pts[None, :]).abs(), dim=-1)]
        return y - d
