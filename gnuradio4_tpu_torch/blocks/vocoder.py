"""Voice codecs (≈ gr-vocoder's most-used member, absent from the
reference blocklib): CVSD — continuously-variable-slope delta modulation,
the classic 1-bit military/tactical voice codec (MIL-STD-188-113 shape).

Both directions run ON DEVICE as a Python loop over samples (the JAX
package's ``lax.scan``): the encoder carries (estimate, step,
run-of-equal-bits) as 0-d tensors (float32, float32, int32) and emits one
bit per sample; the decoder mirrors the same recursion, so a clean channel
reconstructs bit-exactly what the encoder's internal estimate tracked.
Syllabic companding: ``J`` equal bits in a row grow the step toward
``max_step``, otherwise it decays toward ``min_step``.

The loop is launch-bound: 18 torch ops a sample, none of which reads a value
back to the host. The encoder's ``xi >= est`` turns a one-ulp difference in
``est`` into another bit, so ``est`` is computed as the JAX package's CPU
program computes it: XLA contracts ``est · accum_decay ± delta`` into one
fused multiply-add, which is emulated here in float64 (the float32 product
is exact there) and rounded once to float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting


def _cvsd_params(settings):
    return (float(settings.get("min_step")), float(settings.get("max_step")),
            float(settings.get("step_decay")), float(settings.get("accum_decay")),
            int(settings.get("runlength")))


def _cvsd_loop(x, state, decide, emit_est, *, min_step, max_step,
               step_decay, accum_decay, runlength):
    """The recursion both directions share: ``decide(xi, est)`` gives the
    sample's bit (a bool tensor); the output is the bits or, with
    ``emit_est``, the estimates."""
    est, delta, run = state
    # the float32 constants the JAX package's weakly typed Python floats
    # become, and ``accum_decay`` as a float64 holding that float32
    ad64 = float(np.float32(accum_decay))
    plus, minus = (torch.tensor(v, dtype=torch.int32, device=x.device)
                   for v in (1, -1))
    out = []
    for xi in x:
        bit = decide(xi, est)
        # run of equal bits: its sign the bit, its length one more than
        # before if the bit repeats (int32, exact)
        sign = torch.where(bit, plus, minus)
        run = torch.where(bit == (run >= 0), run + sign, sign)
        coincide = torch.abs(run) >= runlength
        delta = torch.where(coincide,
                            torch.clamp_max(delta + min_step, max_step),
                            torch.clamp_min(delta * step_decay, min_step))
        # est·accum_decay ± delta as one fused multiply-add, rounded once
        est = torch.add((delta * sign).to(torch.float64),
                        est.to(torch.float64), alpha=ad64).to(torch.float32)
        out.append(est if emit_est else bit)
    if not out:
        y = torch.zeros(0, dtype=torch.float32, device=x.device)
    else:
        y = torch.stack(out).to(torch.float32)
    return y, (est, delta, run)


def cvsd_encode_scan(x, state, *, min_step, max_step, step_decay,
                     accum_decay, runlength):
    """x [T] float → (bits [T] float32 {0,1}, new state)."""
    return _cvsd_loop(x, state, lambda xi, est: xi >= est, False,
                      min_step=min_step, max_step=max_step,
                      step_decay=step_decay, accum_decay=accum_decay,
                      runlength=runlength)


def cvsd_decode_scan(bits, state, *, min_step, max_step, step_decay,
                     accum_decay, runlength):
    """bits [T] {0,1} → (audio [T] float32, new state); the exact mirror
    of the encoder's estimate recursion."""
    return _cvsd_loop(bits, state, lambda b, est: b > 0.5, True,
                      min_step=min_step, max_step=max_step,
                      step_decay=step_decay, accum_decay=accum_decay,
                      runlength=runlength)


def _init(settings, device=None):
    return (torch.zeros((), dtype=torch.float32, device=device),
            torch.tensor(float(settings.get("min_step")), dtype=torch.float32,
                         device=device),
            torch.ones((), dtype=torch.int32, device=device))


class _CvsdBase(Block):
    min_step = Setting(default=0.01, kind="static")
    max_step = Setting(default=0.1, kind="static")
    step_decay = Setting(default=0.98, kind="static")
    accum_decay = Setting(default=0.97, kind="static")
    runlength = Setting(default=3, kind="static")

    def init_state(self, ctx):
        return _init(self.settings, ctx.device)

    def _kw(self):
        mn, mx, sd, ad, rl = _cvsd_params(self.settings)
        return dict(min_step=mn, max_step=mx, step_decay=sd,
                    accum_decay=ad, runlength=rl)


@register_block("CvsdEncoder")
class CvsdEncoder(_CvsdBase):
    """Audio (float32, ~|x|≤1) → 1 bit/sample CVSD stream (device loop)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        bits, st = cvsd_encode_scan(ins["in"], state, **self._kw())
        return st, {"out": bits}


@register_block("CvsdDecoder")
class CvsdDecoder(_CvsdBase):
    """CVSD bit stream → reconstructed audio (device loop)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)

    def apply(self, state, ins, ctx):
        audio, st = cvsd_decode_scan(ins["in"], state, **self._kw())
        return st, {"out": audio}
