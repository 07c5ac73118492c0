"""LDPC stream blocks over :mod:`gnuradio4_tpu_torch.ops.ldpc` (suite configs
7 and 7k).

Both halves run on the graph's device: encoding is a 0/1 matmul against the
systematic generator, decoding is the normalized min-sum belief propagation
over the frames of each step (``ops.ldpc.decode``: the segment form on the CPU,
the form measured faster on CUDA). The code is constructed deterministically
from (n, m, wc, seed), so a matched encoder/decoder pair needs no side channel.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.cuda_kernels import device_constant, frozen
from ..ops.ldpc import LdpcGraph, decode, make_ldpc
# the names the JAX package's blocks/ldpc exports
from ..ops.ldpc import encode, min_sum_decode  # noqa: F401


def _code(settings):
    return make_ldpc(int(settings.get("n")), int(settings.get("m")),
                     wc=int(settings.get("wc")),
                     seed=int(settings.get("seed")))


@register_block("LdpcEncoder")
class LdpcEncoder(Block):
    """k data bits → n codeword bits per frame (systematic; device matmul of
    0/1 values, exact at any float precision)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    n = Setting(default=256, kind="static")
    m = Setting(default=128, kind="static")
    wc = Setting(default=3, kind="static")
    seed = Setting(default=0, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._H, self._G = _code(self.settings)
        self.k = self._G.shape[0]
        self._G_f32 = frozen(self._G.astype(np.float32))

    @property
    def ratio(self):
        return Fraction(int(self.settings.get("n")), self.k)

    @property
    def alignment(self):
        return self.k

    def apply(self, state, ins, ctx):
        x = ins["in"]
        k, n = self.k, int(self.settings.get("n"))
        frames = x.reshape(*x.shape[:-1], -1, k)
        g = device_constant(self._G_f32, x.device)
        coded = torch.remainder(frames @ g, 2.0)
        return state, {"out": coded.reshape(*x.shape[:-1],
                                            x.shape[-1] // k * n)}


@register_block("LdpcDecoder")
class LdpcDecoder(Block):
    """n soft LLRs (positive = bit 0) → k corrected systematic bits per
    frame; normalized min-sum BP on the device, ``n_iters`` fixed (static)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    n = Setting(default=256, kind="static")
    m = Setting(default=128, kind="static")
    wc = Setting(default=3, kind="static")
    seed = Setting(default=0, kind="static")
    n_iters = Setting(default=25, kind="static")
    alpha = Setting(default=0.8125, kind="static",
                    description="min-sum normalization factor")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._H, self._G = _code(self.settings)
        self.k = self._G.shape[0]
        self._tanner = LdpcGraph(self._H)

    @property
    def ratio(self):
        return Fraction(self.k, int(self.settings.get("n")))

    @property
    def alignment(self):
        return int(self.settings.get("n"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n, k = int(self.settings.get("n")), self.k
        lead = x.shape[:-1]
        bits, _ok = decode(self._tanner, x.reshape(-1, n),
                           int(self.settings.get("n_iters")),
                           float(self.settings.get("alpha")))
        out = bits[:, :k].to(torch.float32)
        return state, {"out": out.reshape(*lead, x.shape[-1] // n * k)}
