"""Polar code stream blocks over :mod:`gnuradio4_tpu_torch.ops.polar`.

The encoder runs ON DEVICE: the u→x butterfly is log₂N stages of
reshape + XOR (as mod-2 float32 adds, exact on 0/1 values), three torch ops
a stage. Successive-cancellation decoding is inherently sequential, so the
decoder is a frame-rate host call inside the step (the RS pattern,
core/host_call.py :func:`~..core.host_call.host_call`: one stream
synchronisation a step).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.host_call import host_call
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.cuda_kernels import device_constant, frozen
from ..ops.polar import frozen_mask, polar_decode


@register_block("PolarEncoder")
class PolarEncoder(Block):
    """K info bits → N codeword bits per frame (device butterflies)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    n = Setting(default=256, kind="static")
    k = Setting(default=128, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._frozen = frozen_mask(int(self.settings.get("n")),
                                   int(self.settings.get("k")))
        self._info_idx = frozen(np.flatnonzero(~self._frozen))

    @property
    def ratio(self):
        return Fraction(int(self.settings.get("n")),
                        int(self.settings.get("k")))

    @property
    def alignment(self):
        return int(self.settings.get("k"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("n"))
        k = int(self.settings.get("k"))
        frames = x.reshape(x.shape[:-1] + (-1, k)).to(torch.float32)
        info_idx = device_constant(self._info_idx, x.device)
        u = torch.zeros(frames.shape[:-1] + (n,), dtype=torch.float32,
                        device=x.device)
        u[..., info_idx] = frames
        # butterfly stages: XOR as mod-2 addition
        step = 1
        while step < n:
            v = u.reshape(u.shape[:-1] + (n // (2 * step), 2, step))
            upper = torch.remainder(v[..., 0, :] + v[..., 1, :], 2.0)
            v = torch.stack([upper, v[..., 1, :]], dim=-2)
            u = v.reshape(u.shape)
            step *= 2
        return state, {"out": u.reshape(x.shape[:-1]
                                        + (x.shape[-1] // k * n,))}


@register_block("PolarDecoder")
class PolarDecoder(Block):
    """N soft LLRs (positive = bit 0) → K info bits per frame via
    successive cancellation (a host call inside the step, frame rate)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    n = Setting(default=256, kind="static")
    k = Setting(default=128, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._frozen = frozen_mask(int(self.settings.get("n")),
                                   int(self.settings.get("k")))

    @property
    def ratio(self):
        return Fraction(int(self.settings.get("k")),
                        int(self.settings.get("n")))

    @property
    def alignment(self):
        return int(self.settings.get("n"))

    def _decode_np(self, x: np.ndarray) -> np.ndarray:
        n = int(self.settings.get("n"))
        k = int(self.settings.get("k"))
        flat = np.asarray(x).reshape(-1)
        bits = polar_decode(flat, self._frozen)
        return bits.astype(np.float32).reshape(x.shape[:-1]
                                               + (x.shape[-1] // n * k,))

    def apply(self, state, ins, ctx):
        return state, {"out": host_call(self._decode_np, ins["in"])}
