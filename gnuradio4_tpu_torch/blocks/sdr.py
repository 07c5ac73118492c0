"""SDR demodulation blocks and the wideband-FM receive chain (≈ reference
blocks/filter IQDemodulator, FrequencyEstimator.hpp).

The WBFM receiver is a nested Graph (subgraph — GraphWrapper-style composition,
reference Graph.hpp:169) built from FreqXlatingFir → QuadratureDemod → audio
decimator → de-emphasis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.graph import Graph
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops import filter_design as fd
from ..ops.demod import fm_deemphasis_coeffs, quadrature_demod
from ..ops.iir import one_pole_ba_apply


@register_block("QuadratureDemod")
class QuadratureDemod(Block):
    """FM discriminator y[n] = gain·arg(x[n]·x̄[n−1]) (state: one carried sample)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)
    SAMPLE_ACCURATE = frozenset({"gain"})
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
        gain = ctx.p("gain", 1.0)
        if np.ndim(gain):      # per-sample ramp (tag-accurate gain switch)
            gain = torch.from_numpy(np.asarray(gain, np.float32)).to(ins["in"].device)
        else:
            gain = float(np.float32(gain))
        desc = getattr(self, "_absorbed_rotation", None) or {}
        rot = None
        if "in" in desc:
            # residual per-sample phase increment → constant phasor folded
            # INSIDE arg (exact (−π,π] wrap match with the de-rotated stream)
            frac = (desc["in"]["dphi_out"] % 4294967296) / 4294967296.0
            rot = complex(np.exp(2j * np.pi * frac))
        y, last = quadrature_demod(ins["in"], state, gain=gain, rot=rot)
        return last, {"out": y}


@register_block("FmDeemphasis")
class FmDeemphasis(Block):
    """Single-pole FM de-emphasis (τ = 75 µs US / 50 µs EU)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    tau = Setting(default=75e-6, kind="static", unit="s")
    sample_rate_in = Setting(default=0.0, kind="static",
                             description="0 → inherit resolved edge rate")

    def _ba(self, fs: float):
        fs_eff = float(self.settings.get("sample_rate_in")) or fs
        return fm_deemphasis_coeffs(fs_eff, float(self.settings.get("tau")))

    def init_state(self, ctx):
        self._fs_cached = ctx.sample_rate
        ch = ctx.channels.get("in", 0)
        return torch.zeros(() if ch == 0 else (ch,), dtype=torch.float32,
                           device=ctx.device)

    def apply(self, state, ins, ctx):
        # single real pole → exact O(log T) parallel recurrence
        b, a = self._ba(getattr(self, "_fs_cached", ctx.sample_rate))
        y, last = one_pole_ba_apply(ins["in"], b, a, state)
        return last, {"out": y}


def make_wbfm_receiver(*, quad_rate: float, audio_decim: int,
                       center_freq: float = 0.0, channel_width: float = 200e3,
                       max_dev: float = 75e3, rf_decim: int = 1,
                       ntaps: int = 127, deemph_tau: float = 75e-6,
                       name: str = "wbfm") -> Graph:
    """Wideband FM receiver subgraph (suite config 3).

    input: complex baseband at ``quad_rate·rf_decim`` centered ``center_freq`` away
    from the station; output: float32 audio at ``quad_rate/audio_decim``.
    Structure: FreqXlatingFir(channel LP, decim rf_decim) → QuadratureDemod →
    audio low-pass FIR (decim audio_decim) → de-emphasis.
    """
    from .filter import FirFilter, FreqXlatingFir
    g = Graph(name=name)
    fs_in = quad_rate * rf_decim
    chan_taps = fd.design_fir("lowpass", ntaps, sample_rate=fs_in,
                              f_low=channel_width / 2.0)
    xlate = g.add(FreqXlatingFir(taps=chan_taps.astype(np.float32),
                                 center_freq=center_freq, decim=rf_decim,
                                 sample_rate_in=fs_in, name=f"{name}.channel"))
    demod = g.add(QuadratureDemod(gain=quad_rate / (2.0 * np.pi * max_dev),
                                  name=f"{name}.demod"))
    audio_rate = quad_rate / audio_decim
    audio_taps = fd.design_fir("lowpass", ntaps, sample_rate=quad_rate,
                               f_low=min(15e3, 0.4 * audio_rate))
    audio = g.add(FirFilter(taps=audio_taps.astype(np.float32), decim=audio_decim,
                            name=f"{name}.audio"))
    deemph = g.add(FmDeemphasis(tau=deemph_tau, sample_rate_in=audio_rate,
                                name=f"{name}.deemph"))
    g.connect_chain(xlate, demod, audio, deemph)
    g.export_in("in", xlate, "in")
    g.export_out("out", deemph, "out")
    return g


@register_block("WbfmReceiver")
class WbfmReceiver(Graph):
    """Registry-constructible WBFM receiver (nested graph block)."""

    def __init__(self, name=None, quad_rate: float = 250e3, audio_decim: int = 5,
                 center_freq: float = 0.0, rf_decim: int = 1, max_dev: float = 75e3,
                 deemph_tau: float = 75e-6):
        inner = make_wbfm_receiver(quad_rate=quad_rate, audio_decim=audio_decim,
                                   center_freq=center_freq, rf_decim=rf_decim,
                                   max_dev=max_dev, deemph_tau=deemph_tau,
                                   name=name or "wbfm")
        # adopt the prepared graph's contents
        super().__init__(name=name or "wbfm")
        self.blocks = inner.blocks
        self.edges = inner.edges
        self._exports_in = inner._exports_in
        self._exports_out = inner._exports_out
        self.in_ports = inner.in_ports
        self.out_ports = inner.out_ports
