"""Arithmetic blocks against a constant (≈ reference blocks/math/Math.hpp):
``MultiplyConst`` and ``DivideConst``, the workhorses of the scheduler tests and
of suite config 6's 40-block cascade. Each is one elementwise torch op."""

from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting


class _ConstOp(Block):
    """Elementwise op against a constant. ``value`` is SAMPLE_ACCURATE: a tag
    carrying it switches the constant at the tag's exact sample (a per-sample
    float32 ramp for that step)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    SAMPLE_ACCURATE = frozenset({"value"})   # tag-driven changes hit at index k
    value = Setting(default=1.0, description="constant operand")
    uncertain = Setting(default=False, kind="static",
                        description="stream is a 2-plane (value, sigma) pair "
                                    "(not ported to this package yet; raises)")
    value_sigma = Setting(default=0.0, limits=(0.0, None),
                          description="1-sigma uncertainty of the constant "
                                      "(uncertain mode)")

    def _op(self, x: torch.Tensor, c) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, state, ins, ctx):
        if self.settings.get("uncertain"):
            raise GrError(f"{self.name}: uncertain=True is not ported to this "
                          f"package yet", block=self.name)
        x = ins["in"]
        v = ctx.p("value", 1.0)
        if np.ndim(v):     # per-sample ramp (tag-accurate value switch)
            c = torch.from_numpy(np.asarray(v, np.float32)).to(x.device).to(x.dtype)
        else:              # the constant rounded to the stream's type
            c = torch.tensor(np.asarray(v).item(), dtype=x.dtype).item()
        return state, {"out": self._op(x, c)}


@register_block("MultiplyConst")
class MultiplyConst(_ConstOp):
    def _op(self, x, c):
        return x * c


@register_block("DivideConst")
class DivideConst(_ConstOp):
    def _op(self, x, c):
        if not torch.is_tensor(c) and x.is_cuda:
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
