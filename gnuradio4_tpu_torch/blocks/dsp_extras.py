"""Beyond-reference DSP blocks every SDR user expects: arbitrary-rate Farrow
resampler, AGC, Goertzel tone detector, IQ imbalance and coarse CFO
correction, PLL and Costas carrier tracking, the band-edge FLL and the M2M4
SNR estimator (the JAX package's ``blocks/dsp_extras.py``).

The carrier loops, the FLL and the SNR estimator's EMA carry their state from
one sample, sub-block or chunk to the next, so each runs as a loop of small
torch ops over its steps; none reads a value back to the host.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.stream import torch_dtype
from ..ops.cuda_kernels import device_constant, frozen
from ..ops.demod import _PI, _TWO_PI, carrier_loop, pll_gains
from ..ops.farrow import agc_apply, farrow_apply, farrow_init_state, goertzel_power
from ..ops.iir import _f32
from ..ops.precision import check_f32_matmul


def _loop_state(ctx) -> dict:
    ch = ctx.channels.get("in", 0)
    shape = () if ch == 0 else (ch,)
    return {"phase": torch.zeros(shape, dtype=torch.float32, device=ctx.device),
            "freq": torch.zeros(shape, dtype=torch.float32, device=ctx.device)}


def _derotate(x: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    """x·e^{−jφ} with e^{−jφ} formed in complex64."""
    return x * torch.polar(torch.ones_like(ph), -ph)


@register_block("FarrowResampler")
class FarrowResampler(Block):
    """Arbitrary-rate resampler (cubic Farrow interpolator).

    ``rate`` = output rate / input rate (e.g. 0.9837). The rate is rationalized
    to ≤ 1e-9 relative error for the static block-size algebra; the fractional
    phase carries exactly, so the stream is drift-free at that rational rate.
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    rate = Setting(default=1.0, kind="static", limits=(1e-6, 1e6),
                   description="output/input sample-rate ratio")

    def _frac(self) -> Fraction:
        return Fraction(float(self.settings.get("rate"))).limit_denominator(10 ** 6)

    @property
    def ratio(self):
        return self._frac()

    @property
    def alignment(self):
        return self._frac().denominator

    def init_state(self, ctx):
        return farrow_init_state(ctx.channels.get("in", 0),
                                 torch_dtype(ctx.dtype("in", np.float32)),
                                 ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        frac = self._frac()
        n_out = int(next(iter(ctx.in_len.values())) * frac)
        src_step = 1.0 / float(frac)  # input samples per output sample
        y, st = farrow_apply(x, state, ratio=src_step, n_out=n_out)
        return st, {"out": y}


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


@register_block("GoertzelDetector")
class GoertzelDetector(Block):
    """Single-frequency power detector (Goertzel): one normalized power value
    per ``chunk`` input samples — cheap DTMF/pilot detection."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    frequency = Setting(default=1000.0, kind="static", unit="Hz")
    chunk = Setting(default=1024, kind="static", limits=(8, 1 << 24))
    sample_rate_in = Setting(default=0.0, kind="static",
                             description="0 → inherit resolved edge rate")

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("chunk")))

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def apply(self, state, ins, ctx):
        n = int(self.settings.get("chunk"))
        fs = float(self.settings.get("sample_rate_in")) or ctx.sample_rate
        x = ins["in"]
        xw = x.reshape(*x.shape[:-1], -1, n)
        p = goertzel_power(xw, freq=float(self.settings.get("frequency")),
                           sample_rate=fs)
        return state, {"out": p}


@register_block("IqImbalanceCorrector")
class IqImbalanceCorrector(Block):
    """Blind IQ gain/phase imbalance correction: estimates E[I²]/E[Q²] and
    E[I·Q] per step (IIR-smoothed in state) and applies the standard
    de-imbalance transform. ≈ GNU Radio iq_imbal correction."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    alpha = Setting(default=0.05, limits=(1e-6, 1.0),
                    description="estimator smoothing per step")

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        shape = () if ch == 0 else (ch,)
        return {"gain": torch.ones(shape, dtype=torch.float32, device=ctx.device),
                "phase": torch.zeros(shape, dtype=torch.float32, device=ctx.device)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        i, q = x.real, x.imag
        a = np.float32(ctx.p("alpha", 0.05))
        keep = float(np.float32(1.0) - a)          # 1 − α in float32
        a = float(a)
        # model: q_meas = g·q + φ·i with E[i·q] = 0 for a balanced signal
        # ⇒ φ̂ = E[i·q_m]/E[i²],  ĝ² = E[q_m²]/E[i²] − φ̂²
        pi = torch.mean(i * i, dim=-1) + _f32(1e-20)
        pq = torch.mean(q * q, dim=-1)
        piq = torch.mean(i * q, dim=-1)
        phase_inst = piq / pi
        gain_inst = torch.sqrt(torch.clamp(pq / pi - phase_inst * phase_inst,
                                           min=_f32(1e-12)))
        gain = keep * state["gain"] + a * gain_inst
        phase = keep * state["phase"] + a * phase_inst
        # invert: q̂ = (q_m − φ̂·i)/ĝ
        qc = (q - phase[..., None] * i) / gain[..., None]
        return {"gain": gain, "phase": phase}, {"out": torch.complex(i, qc)}


@register_block("CoarseFrequencyCorrector")
class CoarseFrequencyCorrector(Block):
    """M-th-power coarse CFO estimate + correction for M-PSK: the offset shows
    up at M·Δf in x^M; one FFT peak per step estimates it, an NCO removes it.
    State carries the correction phase for continuity. The peak's bin and its
    parabolic refinement stay on the device."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    order = Setting(default=4, kind="static", choices=(2, 4, 8),
                    description="constellation order M (PSK)")

    def init_state(self, ctx):
        return {"phase": torch.zeros((), dtype=torch.float32, device=ctx.device),
                "freq": torch.zeros((), dtype=torch.float32, device=ctx.device)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        m = int(self.settings.get("order"))
        n = x.shape[-1]
        xm = x
        for _ in range(m.bit_length() - 1):     # x^m by squaring (integer_pow)
            xm = xm * xm
        spec = torch.abs(torch.fft.fft(xm))
        k = torch.argmax(spec)                  # the first maximum, as jnp's
        # parabolic sub-bin interpolation around the peak (cyclic neighbors)
        sa = spec[torch.remainder(k - 1, n)]
        sb = spec[k]
        sc = spec[torch.remainder(k + 1, n)]
        denom = sa - 2.0 * sb + sc
        d = torch.where(torch.abs(denom) > _f32(1e-20),
                        0.5 * (sa - sc) / denom, 0.0)
        k_signed = torch.where(k > n // 2, k - n, k).to(torch.float32) + d
        # the block-length estimate is already an average — no cross-step
        # smoothing (it would slow convergence to the true offset)
        freq = _TWO_PI * k_signed / float(n * m)
        idx = torch.arange(n, dtype=torch.float32, device=x.device)
        y = _derotate(x, state["phase"] + freq * idx)
        new_phase = torch.remainder(state["phase"] + freq * float(n), _TWO_PI)
        return {"phase": new_phase, "freq": freq}, {"out": y}


@register_block("PllCarrierTracking")
class PllCarrierTracking(Block):
    """2nd-order PLL that tracks and removes a residual carrier:
    y[n] = x[n]·e^{-jφ[n]} (≈ GNU Radio pll_carriertracking_cc)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    loop_bw = Setting(default=0.02, kind="static", limits=(1e-6, 1.0))
    max_freq = Setting(default=1.0, kind="static",
                       description="frequency clamp, rad/sample")

    def init_state(self, ctx):
        return _loop_state(ctx)

    def apply(self, state, ins, ctx):
        alpha, beta = pll_gains(float(self.settings.get("loop_bw")))
        y, _, ph, fr = carrier_loop(
            ins["in"], state["phase"], state["freq"], alpha=alpha, beta=beta,
            detector=lambda yn: torch.atan2(yn.imag, yn.real),
            max_freq=float(self.settings.get("max_freq")))
        return {"phase": ph, "freq": fr}, {"out": y}


_K8 = _f32(np.sqrt(2.0) - 1.0)


def _costas_detector(order: int):
    """Order 2 (BPSK): e = Re·Im; order 4 (QPSK): e = sign(Re)·Im −
    sign(Im)·Re; order 8 (8PSK): the QPSK detector with the K = √2−1 axis
    weighting (GR costas_loop_cc)."""
    if order == 2:
        return lambda y: y.real * y.imag
    if order == 4:
        return lambda y: torch.sign(y.real) * y.imag - torch.sign(y.imag) * y.real

    def det8(y):
        re, im = y.real, y.imag
        a, b = torch.sign(re) * im, torch.sign(im) * re
        return torch.where(torch.abs(re) >= torch.abs(im), a - b * _K8,
                           a * _K8 - b)
    return det8


@register_block("CostasLoop")
class CostasLoop(Block):
    """Decision-directed carrier recovery for M-PSK (≈ GNU Radio
    costas_loop_cc; beyond the reference's blocklib, expected by GR users).

    Order 2 (BPSK): e = Re·Im; order 4 (QPSK): e = sign(Re)·Im − sign(Im)·Re;
    order 8 (8PSK): QPSK detector with the K = √2−1 axis weighting.
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    loop_bw = Setting(default=0.02, kind="static", limits=(1e-6, 1.0))
    order = Setting(default=4, kind="static", choices=(2, 4, 8))
    max_freq = Setting(default=1.0, kind="static",
                       description="frequency clamp, rad/sample")

    def init_state(self, ctx):
        return _loop_state(ctx)

    def apply(self, state, ins, ctx):
        alpha, beta = pll_gains(float(self.settings.get("loop_bw")))
        y, _, ph, fr = carrier_loop(
            ins["in"], state["phase"], state["freq"], alpha=alpha, beta=beta,
            detector=_costas_detector(int(self.settings.get("order"))),
            max_freq=float(self.settings.get("max_freq")))
        return {"phase": ph, "freq": fr}, {"out": y}


@register_block("FllBandEdge")
class FllBandEdge(Block):
    """Band-edge frequency-locked loop (≈ GNU Radio fll_band_edge_cc; beyond
    the reference's blocklib). Acquires carrier offsets up to ~half the symbol
    bandwidth using the energy difference between upper/lower band-edge
    filters of the matched (RRC) pulse.

    The loop updates once per ``subblock`` samples: each sub-block is
    de-rotated, its frames run through both band-edge filters as ONE
    [frames, K] × [K, 2] product, and the averaged energy difference drives a
    first-order integrator. Acquisition is slower by the sub-block factor;
    the loop runs once per sub-block, not per sample.

    In cascades keep ``loop_bw`` small (default 0.01): a wide FLL bandwidth
    jitters the de-rotation frequency at sub-block rate, phase-random-walking
    the stream and smearing downstream decision loops (the JAX package
    measured fll bw 0.05 -> 67% symbol accuracy after PfbClockSync+Costas;
    bw 0.01 -> 100%).
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    samples_per_symbol = Setting(default=4.0, kind="static")
    rolloff = Setting(default=0.35, kind="static", limits=(0.0, 1.0))
    filter_size = Setting(default=45, kind="static", limits=(3, 1024))
    loop_bw = Setting(default=0.01, kind="static", limits=(1e-6, 1.0))
    subblock = Setting(default=64, kind="static", limits=(8, 4096))
    max_freq = Setting(default=1.0, kind="static")

    def _band_edge_taps(self):
        """Upper/lower band-edge filters: a sinc-squared edge prototype
        heterodyned to ±(1+a)/(2·sps) cycles/sample (GR's design intent)."""
        if getattr(self, "_be", None) is None:
            sps = float(self.settings.get("samples_per_symbol"))
            a = float(self.settings.get("rolloff"))
            k = int(self.settings.get("filter_size"))
            n = np.arange(k, dtype=np.float64) - (k - 1) / 2.0
            # edge prototype: squared sinc ramp over the transition band a/sps
            g = np.sinc(a * n / sps) ** 2
            g /= np.sum(g)
            fe = (1.0 + a) / (2.0 * sps)          # band-edge center, cyc/sample
            rot = np.exp(2j * np.pi * fe * n)
            self._be = (np.asarray(g * rot, np.complex64),
                        np.asarray(g * np.conj(rot), np.complex64))
        return self._be

    def _plan(self):
        """([K, 2] conj(upper | lower) taps, [frames, K] frame indices into a
        sub-block), frames starting every max(1, (sb − K)//8) samples."""
        if getattr(self, "_fll_plan", None) is None:
            sb = int(self.settings.get("subblock"))
            k = int(self.settings.get("filter_size"))
            up, lo = self._band_edge_taps()
            starts = np.arange(0, sb - k + 1, max(1, (sb - k) // 8 or 1))
            self._fll_plan = frozen(
                np.ascontiguousarray(np.stack([np.conj(up), np.conj(lo)], 1)),
                starts[:, None] + np.arange(k)[None, :])
        return self._fll_plan

    def init_state(self, ctx):
        return {"phase": torch.zeros((), dtype=torch.float32, device=ctx.device),
                "freq": torch.zeros((), dtype=torch.float32, device=ctx.device)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        sb = int(self.settings.get("subblock"))
        bw = _f32(float(self.settings.get("loop_bw")))
        fmax = float(self.settings.get("max_freq"))
        # correlation with conj(h): downconverts the band at +fe (resp. -fe)
        # to DC, so |frames @ conj(up)|^2 measures upper-band-edge energy. NO
        # tap reversal — reversing the symmetric-envelope taps flips e^{+j} to
        # e^{-j} and swaps the two bands (the loop then diverges to -clamp)
        taps, frames_at = self._plan()
        w = device_constant(taps, x.device)
        fidx = device_constant(frames_at, x.device)
        check_f32_matmul("FllBandEdge")
        n = x.shape[-1]
        nblk = n // sb
        ph, fr = state["phase"], state["freq"]
        idx = torch.arange(sb, dtype=torch.float32, device=x.device)
        ys = []
        for blk in x[..., : nblk * sb].reshape(nblk, sb).unbind(0):
            y = _derotate(blk, ph + fr * idx)
            mag = torch.abs(y[fidx] @ w)                 # [frames, 2]
            e = torch.mean(mag * mag, dim=0)
            eu, el = e[0], e[1]
            err = (eu - el) / (eu + el + _f32(1e-20))
            fr = torch.clamp(fr + bw * err, -fmax, fmax)
            ph = torch.remainder(ph + fr * float(sb) + _PI, _TWO_PI) - _PI
            ys.append(y)
        if n > nblk * sb:  # rotate the tail with the final estimate
            m = n - nblk * sb
            ys.append(_derotate(x[..., nblk * sb:], ph + fr * idx[:m]))
            ph = torch.remainder(ph + fr * float(m) + _PI, _TWO_PI) - _PI
        y = torch.cat(ys, dim=-1) if ys else x.clone()
        return {"phase": ph, "freq": fr}, {"out": y}

    def estimated_freq(self, state) -> float:
        """Current frequency estimate, rad/sample (for tests/monitoring)."""
        return float(state["freq"])


@register_block("SnrEstimator")
class SnrEstimator(Block):
    """M2M4 moments SNR estimator (≈ GNU Radio's mpsk_snr_est_cc, the
    blind/non-data-aided default): for constant-modulus constellations,
    S = sqrt(2·M2² − M4) and N = M2 − S with M2 = E|x|², M4 = E|x|⁴.
    Decimating probe: one SNR (dB) estimate per ``chunk`` samples; running
    moments carry in state with an EMA (``alpha``) across chunks, a loop over
    the step's chunks."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)
    chunk = Setting(default=1024, kind="static")
    alpha = Setting(default=0.0, kind="static",
                    description="EMA across chunks (0 = independent)")

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("chunk")))

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def init_state(self, ctx):
        return {"m2": torch.zeros((), dtype=torch.float32, device=ctx.device),
                "m4": torch.zeros((), dtype=torch.float32, device=ctx.device),
                "warm": torch.zeros((), dtype=torch.bool, device=ctx.device)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("chunk"))
        frames = x.reshape(x.shape[:-1] + (-1, n))
        p = (frames.real * frames.real + frames.imag * frames.imag).to(torch.float32)
        m2 = p.mean(dim=-1)
        m4 = (p * p).mean(dim=-1)
        a = float(self.settings.get("alpha"))
        if a > 0.0:
            m2p, m4p, warm = state["m2"], state["m4"], state["warm"]
            hot = torch.ones_like(warm)
            seq2, seq4 = [], []
            for m2c, m4c in zip(m2.reshape(-1).unbind(0), m4.reshape(-1).unbind(0)):
                m2p = torch.where(warm, a * m2p + (1 - a) * m2c, m2c)
                m4p = torch.where(warm, a * m4p + (1 - a) * m4c, m4c)
                warm = hot
                seq2.append(m2p)
                seq4.append(m4p)
            new_state = {"m2": m2p, "m4": m4p, "warm": warm}
            m2 = torch.stack(seq2).reshape(frames.shape[:-1])
            m4 = torch.stack(seq4).reshape(frames.shape[:-1])
        else:
            new_state = state
        s = torch.sqrt(torch.clamp(2.0 * m2 * m2 - m4, min=_f32(1e-20)))
        noise = torch.clamp(m2 - s, min=_f32(1e-20))
        snr_db = 10.0 * torch.log10(s / noise)
        return new_state, {"out": snr_db.to(torch.float32)}
