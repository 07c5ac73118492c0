"""Filter blocks (≈ reference blocks/filter/time_domain_filter.hpp).

``FirFilter`` (:24 fir_filter with decimation), ``BasicFilter`` /
``BasicDecimatingFilter`` (auto-designed, :131-211), ``FreqXlatingFir`` (channel
extraction) and ``IQDemodulator`` filter through ops/fir.py ``fir_apply``, i.e.
the hand-written banded FIR kernel on a CUDA device. ``IirFilter`` (:64
iir_filter) runs one of ops/iir.py's engines, or the hand-written
biquad-cascade kernel. ``Decimator`` (:216) keeps every N-th sample;
``RationalResampler`` runs ops/resample.py; ``LockInDemodulator`` is the
reference's two-input IQDemodulator over ``torch.fft.rfft``.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Any

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops import filter_design as fd
from ..ops import iir as iir_ops
from ..ops.cuda_kernels import frozen, iir_sos, nco_mix
from ..ops.fir import PRECISIONS, fir_apply, fir_init_state, freq_xlating_taps
from ..ops.resample import RationalResamplerKernel
from ..ops.signal import complex_exp_ramp, phase_increment
from .basic import phase_state
from .uncertain import check_uncertain_channels


@register_block("FirFilter")
class FirFilter(Block):
    """Overlap-save FIR with optional decimation (≈ fir_filter + Decimator fused).

    State carries the last ``ntaps-1`` inputs (the HistoryBuffer analog).
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    taps = Setting(default=(1.0,), kind="static", description="FIR taps b[k]")
    decim = Setting(default=1, kind="static", limits=(1, 1 << 16))
    precision = Setting(default="auto", kind="static", choices=PRECISIONS,
                        description="precision rung of this block's FIR: "
                                    "auto → the banded kernel in full "
                                    "float32; an explicit rung takes the "
                                    "matmul path (host taps, ntaps<=512, "
                                    "else GrError): highest = float32, "
                                    "high = bf16×3, default/bf16 = one bf16 "
                                    "pass, int8 = int8 × int8 (ops/"
                                    "precision.py)")
    uncertain = Setting(default=False, kind="static",
                        description="input is a 2-plane (value, sigma) stream; "
                                    "sigma propagates as sqrt(fir(sigma^2, "
                                    "taps^2)) — the uncorrelated first-order "
                                    "rule of the reference's "
                                    "fir_filter<UncertainValue<T>> "
                                    "(time_domain_filter.hpp:213)")

    def __init__(self, name=None, taps: Any = None, **settings):
        if taps is not None:
            settings["taps"] = tuple(np.asarray(taps).tolist())
        super().__init__(name=name, **settings)

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("decim")))

    @property
    def alignment(self):
        return int(self.settings.get("decim"))

    def _taps_array(self):
        t = np.asarray(self.settings.get("taps"))
        if t.size == 0:
            t = np.ones(1)  # identity filter when no taps configured
        return t.astype(np.complex64 if np.iscomplexobj(t) else np.float32)

    def _prec(self):
        p = str(self.settings.get("precision"))
        return None if p == "auto" else p

    def out_dtype(self, port, in_dtypes):
        t = self._taps_array()
        up = next(iter(in_dtypes.values()), np.float32)
        if np.iscomplexobj(t) or np.dtype(up) == np.dtype(np.complex64):
            return np.dtype(np.complex64)
        return up

    def init_state(self, ctx):
        t = self._taps_array()
        # history follows the STREAM dtype — a real stream with complex taps
        # stays real (ops/fir.py keeps the real rail)
        ch = ctx.channels.get("in", 0)
        return fir_init_state(ch, len(t), ctx.dtype("in"), ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        d = int(self.settings.get("decim"))
        if self.settings.get("uncertain"):
            check_uncertain_channels(ctx, "in", self.name)
            t = self._taps_array()
            if np.iscomplexobj(t):
                raise GrError(f"{self.name}: uncertain mode needs real taps")
            # state holds the raw input planes (value, sigma) — the plain
            # path's layout, so checkpoints are unchanged. Two FIR calls: the
            # value plane, and sigma² through the squared taps.
            yv, hv = fir_apply(x[..., 0, :], t, state[..., 0, :], decim=d,
                               precision=self._prec())
            s2, hs = fir_apply(x[..., 1, :].square(), t * t,
                               state[..., 1, :].square(), decim=d,
                               precision=self._prec())
            y = torch.stack([yv, s2.clamp_min(0.0).sqrt()], dim=-2)
            new_state = torch.stack([hv, hs.clamp_min(0.0).sqrt()], dim=-2)
            return new_state, {"out": y}
        y, new_state = fir_apply(x, self._taps_array(), state, decim=d,
                                 precision=self._prec())
        return new_state, {"out": y}

    def sp_halo(self, ctx):
        """Time-shardable: state is exactly the last ntaps−1 raw inputs, so the
        default halo lowering applies (per-shard lengths are decim-divisible
        by the rate algebra's shard alignment)."""
        return len(self._taps_array()) - 1


@register_block("FreqXlatingFir")
class FreqXlatingFir(FirFilter):
    """Frequency-translating FIR: heterodyne + low-pass + decimate in one pass
    (taps rotated by center_freq; output de-rotated by the decimated NCO).
    ≈ GNU Radio's freq_xlating_fir; reference analog: IQDemodulator front-end."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    center_freq = Setting(default=0.0, kind="static", unit="Hz")
    sample_rate_in = Setting(default=0.0, kind="static", unit="Hz",
                             description="0 → inherit resolved edge rate")
    f_cut = Setting(default=0.0, kind="static", unit="Hz",
                    description="> 0 → auto-design a lowpass prototype at the "
                                "resolved rate instead of explicit taps")
    ntaps = Setting(default=121, kind="static", limits=(1, 1 << 16),
                    description="prototype length when f_cut is set")
    window = Setting(default="Hamming", kind="static")

    _fs_cached: float = 1.0

    def _fs(self, ctx_rate: float = 1.0) -> float:
        fs = float(self.settings.get("sample_rate_in"))
        return fs if fs > 0 else ctx_rate

    def _taps_array(self):
        f_cut = float(self.settings.get("f_cut"))
        if f_cut > 0.0:
            return fd.design_fir(
                "lowpass", int(self.settings.get("ntaps")),
                sample_rate=self._fs(self._fs_cached), f_low=f_cut,
                window=self.settings.get("window")).astype(np.float32)
        return super()._taps_array()

    def _rotated_taps(self, fs: float):
        self._fs_cached = fs
        base = np.asarray(self._taps_array(), dtype=np.float64)
        return freq_xlating_taps(base, float(self.settings.get("center_freq")), fs)

    def init_state(self, ctx):
        self._fs_cached = ctx.sample_rate     # design rate for f_cut mode
        ntaps = len(self._taps_array())
        ch = ctx.channels.get("in", 0)
        # complex input → history holds complex64 (ROTATED samples on the
        # rotate-then-filter path); real input → the raw real stream
        in_dt = ctx.dtype("in", np.complex64)
        dt = np.complex64 if in_dt == np.dtype(np.complex64) else np.float32
        return {"hist": fir_init_state(ch, ntaps, dt, ctx.device),
                "phase": phase_state()}

    def rotation_descriptor(self, ctx_rate: float):
        """Compiler rotation-absorption hook. ``dphi_out`` is the uint32
        increment of the SKIPPED de-rotation: consumers must RE-APPLY
        e^{j·2π·frac32(m·dphi_out)/2³²} per output sample m, plus a
        step-constant phase all absorbing consumers are invariant to. See
        FFT._rotation_window and QuadratureDemod.apply for the two consumers."""
        fc = float(self.settings.get("center_freq"))
        if fc == 0.0:
            return None
        decim = int(self.settings.get("decim"))
        return {"dphi_out": int(phase_increment(-fc * decim,
                                                self._fs(ctx_rate)))}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        fs = self._fs(ctx.sample_rate)
        decim = int(self.settings.get("decim"))
        fc = float(self.settings.get("center_freq"))
        hist = state["hist"]
        stream_dt = torch.complex64 if x.is_complex() else torch.float32
        if getattr(self, "_rotation_absorbed", False) or fc == 0.0:
            # absorbed: every consumer absorbs the residual rotation, so the
            # heterodyned-taps FIR runs with NO NCO pass (history = raw x).
            # fc == 0: no translation, plain FIR over the raw stream.
            taps = self._rotated_taps(fs) if fc != 0.0 else self._taps_array()
            self._fs_cached = fs
            y, new_hist = fir_apply(x.to(stream_dt), taps, hist.to(stream_dt),
                                    decim=decim, precision=self._prec())
            return ({"hist": new_hist.to(hist.dtype), "phase": state["phase"]},
                    {"out": y.to(torch.complex64)})
        if x.is_complex():
            # Rotate-then-filter: the heterodyned-taps form's output
            # de-rotation cancels the tap heterodyne EXACTLY —
            #   e^{-jωn}·Σₖ h[k]e^{jωk} x[n−k] = Σₖ h[k]·(x·e^{-jω·})[n−k]
            # — so rotating the INPUT (the nco_mix kernel) lets the FIR run
            # with REAL taps. History carries the rotated stream; the phase
            # accumulates at the INPUT rate.
            dphi = int(phase_increment(-fc, fs))
            xr, phase = nco_mix(x.to(torch.complex64).contiguous(),
                                int(state["phase"]), dphi)
            self._fs_cached = fs
            y, new_hist = fir_apply(xr, self._taps_array(),
                                    hist.to(torch.complex64), decim=decim,
                                    precision=self._prec())
            return {"hist": new_hist, "phase": phase_state(phase)}, {"out": y}
        # Real input: heterodyned complex taps over the REAL rail + de-rotation
        # at the decimated output rate (n/decim NCO samples).
        y, new_hist = fir_apply(x.to(torch.float32), self._rotated_taps(fs),
                                hist.to(torch.float32), decim=decim,
                                precision=self._prec())
        n_out = y.shape[-1]
        dphi = int(phase_increment(-fc * decim, fs))
        y = y * complex_exp_ramp(int(state["phase"]), dphi, n_out,
                                 device=y.device)
        return ({"hist": new_hist, "phase": phase_state(int(state["phase"])
                                                        + dphi * n_out)},
                {"out": y})

    def apply_sp(self, state, ins, ctx, local_ctx, axis):
        """Time-sharded lowering: FIR history via the left neighbour's halo;
        the NCO phase is position-dependent, so each shard offsets its start
        phase by its global position (the integer phase wraps mod 2³²
        exactly). Complex input rotates BEFORE the halo exchange (the carried
        tail is the rotated stream, matching ``apply``'s history)."""
        from ..parallel.halo import fir_timeshard
        xs = [d["in"] for d in ins]
        fs = self._fs(ctx.sample_rate)
        decim = int(self.settings.get("decim"))
        fc = float(self.settings.get("center_freq"))
        hist = state["hist"]
        phase = int(state["phase"])

        def fir(streams, taps):
            ys, tail = fir_timeshard(streams, taps, hist, decim=decim,
                                     precision=self._prec())
            return ys, tail.to(hist.dtype)

        if getattr(self, "_rotation_absorbed", False) or fc == 0.0:
            # absorbed: consumers handle the residual rotation (linear in the
            # GLOBAL index, the form absorbers are built for); fc == 0: no
            # translation — either way the FIR runs raw, no NCO pass
            dt = torch.complex64 if xs[0].is_complex() else torch.float32
            taps = self._rotated_taps(fs) if fc != 0.0 else self._taps_array()
            self._fs_cached = fs
            ys, tail = fir([x.to(dt) for x in xs], taps)
            return ({"hist": tail, "phase": state["phase"]},
                    [{"out": y.to(torch.complex64)} for y in ys])
        if xs[0].is_complex():
            dphi = int(phase_increment(-fc, fs))
            n_in = xs[0].shape[-1]
            xr = [nco_mix(x.to(torch.complex64).contiguous(),
                          phase + dphi * i * n_in, dphi)[0]
                  for i, x in enumerate(xs)]
            self._fs_cached = fs
            ys, tail = fir(xr, self._taps_array())
            return ({"hist": tail,
                     "phase": phase_state(phase + dphi * axis.size * n_in)},
                    [{"out": y} for y in ys])
        ys, tail = fir([x.to(torch.float32) for x in xs], self._rotated_taps(fs))
        n_out = ys[0].shape[-1]
        dphi = int(phase_increment(-fc * decim, fs))
        ys = [y * complex_exp_ramp(phase + dphi * i * n_out, dphi, n_out,
                                   device=y.device)
              for i, y in enumerate(ys)]
        return ({"hist": tail,
                 "phase": phase_state(phase + dphi * axis.size * n_out)},
                [{"out": y} for y in ys])


@functools.lru_cache(maxsize=64)
def _ba_to_sos(b: tuple, a: tuple) -> np.ndarray:
    """The sections of (b, a), designed once per coefficient set (read-only):
    ``ba_to_sos`` finds polynomial roots, and IirFilter asks for the
    sections twice at every step."""
    return frozen(fd.ba_to_sos(b, a))


@register_block("IirFilter")
class IirFilter(Block):
    """Direct-form IIR y[n] = Σb·x − Σa·y (≈ iir_filter, time_domain_filter.hpp:64).

    Engines: ``scan`` — transposed DF-II loop over time (ops/iir.py
    ``iir_apply``, state [C, order]); ``parallel`` — partial fractions into
    one-pole recurrences of O(log T) depth (needs separable poles, state
    [C, S] complex64); ``pallas`` — the biquad cascade, on the card the
    ``iir_sos`` CUDA kernel (a chunked state-space scan across time: chunks
    filtered in parallel and joined by their carried states) and on the CPU
    its plain loop (state [C, S, 2]).
    ``auto`` decides from the block's device: ``scan`` on the CPU; on CUDA
    ``parallel`` when the sections allow it, else ``pallas``."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    b = Setting(default=(1.0,), kind="static", description="feed-forward coeffs")
    a = Setting(default=(1.0,), kind="static", description="feedback coeffs, a[0]=1")
    engine = Setting(default="auto", kind="static",
                     choices=("auto", "scan", "parallel", "pallas"),
                     description="'parallel': O(log T) associative-scan partial "
                                 "fractions (needs separable poles); 'pallas': "
                                 "the biquad-cascade kernel (a chunked scan "
                                 "across time)")
    uncertain = Setting(default=False, kind="static",
                        description="input is a 2-plane (value, sigma) stream; "
                                    "sigma^2 runs the per-op uncorrelated "
                                    "recursion sy2[n] = Σb^2·sx2[n-k] + "
                                    "Σa^2·sy2[n-j] (≈ iir_filter<Uncertain"
                                    "Value<T>>, time_domain_filter.hpp:64); "
                                    "forces the scan engine")

    def __init__(self, name=None, b: Any = None, a: Any = None, **settings):
        if b is not None:
            settings["b"] = tuple(np.asarray(b, dtype=np.float64).tolist())
        if a is not None:
            settings["a"] = tuple(np.asarray(a, dtype=np.float64).tolist())
        super().__init__(name=name, **settings)

    def _sos(self) -> np.ndarray:
        return _ba_to_sos(tuple(self.settings.get("b")), tuple(self.settings.get("a")))

    def _engine(self, device: torch.device) -> str:
        eng = str(self.settings.get("engine"))
        if eng != "auto":
            return eng
        if device.type != "cuda":
            return "scan"
        return "parallel" if iir_ops.sos_supports_parallel(self._sos()) else "pallas"

    def init_state(self, ctx):
        if self.settings.get("uncertain"):
            nb = len(self.settings.get("b"))
            na = len(self.settings.get("a"))
            # per-plane scalar loop states (value path + variance path)
            return {"v": iir_ops.iir_init_state(0, nb, na, ctx.device),
                    "s2": iir_ops.iir_init_state(0, nb, na, ctx.device)}
        ch = ctx.channels.get("in", 0)
        eng = self._engine(ctx.device)
        if eng == "parallel":
            return iir_ops.sos_parallel_init_state(ch, self._sos().shape[0],
                                                   ctx.device)
        if eng == "pallas":
            return iir_ops.sos_init_state(ch, self._sos().shape[0], ctx.device)
        return iir_ops.iir_init_state(ch, len(self.settings.get("b")),
                                      len(self.settings.get("a")), ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        if self.settings.get("uncertain"):
            check_uncertain_channels(ctx, "in", self.name)
            b = np.asarray(self.settings.get("b"), dtype=np.float64)
            a = np.asarray(self.settings.get("a"), dtype=np.float64)
            bn, an = b / a[0], a / a[0]
            yv, sv = iir_ops.iir_apply(x[..., 0, :], bn, an, state["v"])
            # variance recursion: sy2 = Σ bn² sx2 − Σ (−an²) sy2
            av = np.concatenate([[1.0], -np.square(an[1:])])
            s2, ss = iir_ops.iir_apply(x[..., 1, :].square(), np.square(bn),
                                       av, state["s2"])
            y = torch.stack([yv, s2.clamp_min(0.0).sqrt()], dim=-2)
            return {"v": sv, "s2": ss}, {"out": y}
        eng = self._engine(ctx.device)
        if eng == "parallel":
            y, new_state = iir_ops.sos_parallel_apply(x, self._sos(), state)
        elif eng == "pallas":
            y, new_state = iir_sos(x.contiguous(), self._sos(), state)
        else:
            y, new_state = iir_ops.iir_apply(
                x, np.asarray(self.settings.get("b"), dtype=np.float64),
                np.asarray(self.settings.get("a"), dtype=np.float64), state)
        return new_state, {"out": y}


@register_block("IQDemodulator")
class IQDemodulator(FreqXlatingFir):
    """RF → decimated complex baseband in one block (≈ reference IQDemodulator,
    blocks/filter FrequencyEstimator.hpp, Resampling<1024,1>): heterodyne at
    ``center_freq``, anti-alias low-pass, decimate by ``decim``. Taps are
    auto-designed (windowed-sinc, cutoff 0.4·fs/decim, 8·decim+1 taps) unless
    given explicitly. Accepts real or complex input."""

    IN = (Port("in"),)   # real RF or complex IF both work
    OUT = (Port("out", dtype="complex64"),)
    taps = Setting(default=(), kind="static",
                   description="anti-alias taps; empty → auto-designed")

    def _taps_array(self):
        user = np.asarray(self.settings.get("taps"))
        if user.size:   # explicit taps win over the auto design
            return super()._taps_array()
        d = int(self.settings.get("decim"))
        if getattr(self, "_auto_key", None) != d:
            self._auto_key = d
            self._auto_taps = fd.design_fir(
                "lowpass", 8 * d + 1, sample_rate=1.0, f_low=0.4 / max(d, 1),
                window="Hamming").astype(np.float32)
        return self._auto_taps


@register_block("LockInDemodulator")
class LockInDemodulator(Block):
    """Dual-channel lock-in / transfer-function analyzer (≈ the reference's
    two-input ``IQDemodulator``, blocks/filter FrequencyEstimator.hpp:
    Resampling<1024,1> with amp/phase/frequency outputs).

    Per ``chunk`` input samples, one sample on each output: the response/
    reference amplitude ratio, their phase difference (radians or degrees,
    optionally inverted) and the reference frequency. Both chunks are
    transformed together; the reference's dominant (non-DC) bin carries both
    complex coefficients, and the frequency comes from parabolic
    interpolation around it."""

    IN = (Port("ref", dtype="float32"), Port("resp", dtype="float32"))
    OUT = (Port("amp", dtype="float32"), Port("phase", dtype="float32"),
           Port("freq", dtype="float32"))
    chunk = Setting(default=1024, kind="static", limits=(8, 1 << 24))
    phase_unit = Setting(default="radians", kind="static",
                         choices=("radians", "degrees"))
    invert_phase = Setting(default=False, kind="static")

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("chunk")))

    @property
    def alignment(self):
        return int(self.settings.get("chunk"))

    def apply(self, state, ins, ctx):
        n = int(self.settings.get("chunk"))
        fs = ctx.sample_rate
        ref = ins["ref"].reshape(*ins["ref"].shape[:-1], -1, n)
        resp = ins["resp"].reshape(*ins["resp"].shape[:-1], -1, n)
        r = torch.fft.rfft(ref, dim=-1)
        s = torch.fft.rfft(resp, dim=-1)
        mag = torch.abs(r)
        mag[..., 0] = 0.0                       # ignore DC
        km = torch.clamp(torch.argmax(mag, dim=-1), 1, n // 2 - 1)[..., None]
        take = lambda a, idx: torch.gather(a, -1, idx)[..., 0]
        rk, sk = take(r, km), take(s, km)
        amp = torch.abs(sk) / torch.clamp(torch.abs(rk), min=1e-30)
        ph = torch.angle(sk * torch.conj(rk))
        if bool(self.settings.get("invert_phase")):
            ph = -ph
        if str(self.settings.get("phase_unit")) == "degrees":
            ph = ph * float(np.float32(180.0 / np.pi))
        # parabolic peak interpolation for the reference frequency
        a, b, c = take(mag, km - 1), take(mag, km), take(mag, km + 1)
        denom = a - 2 * b + c
        d = torch.where(denom.abs() > 1e-20, 0.5 * (a - c) / denom,
                        torch.zeros_like(denom))
        freq = (km[..., 0].to(torch.float32) + d) * float(np.float32(fs / n))
        return state, {"amp": amp.float(), "phase": ph.float(),
                       "freq": freq.float()}


@register_block("Decimator")
class Decimator(Block):
    """Keep every N-th sample (≈ Decimator, time_domain_filter.hpp:216). The
    output is a strided view of the input; ``fir_apply`` makes its input
    contiguous before a kernel sees it."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    decim = Setting(default=1, kind="static", limits=(1, 1 << 20))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("decim")))

    @property
    def alignment(self):
        return int(self.settings.get("decim"))

    def apply(self, state, ins, ctx):
        d = int(self.settings.get("decim"))
        return state, {"out": ins["in"][..., ::d]}


@register_block("BasicFilter")
class BasicFilter(FirFilter):
    """Auto-designed FIR from high-level parameters (≈ BasicFilter,
    time_domain_filter.hpp:131): set filter_type/f_low/f_high/ntaps/window and
    the taps are designed once per compile via ops.filter_design."""

    filter_type = Setting(default="lowpass", kind="static",
                          choices=("lowpass", "highpass", "bandpass", "bandstop"))
    f_low = Setting(default=0.1, kind="static", unit="Hz")
    f_high = Setting(default=0.0, kind="static", unit="Hz")
    ntaps = Setting(default=127, kind="static", limits=(1, 1 << 16))
    window = Setting(default="Hamming", kind="static")
    sample_rate_design = Setting(default=0.0, kind="static",
                                 description="0 → inherit resolved edge rate")

    _fs_cached: float = 1.0

    def _taps_array(self):
        fs = float(self.settings.get("sample_rate_design")) or self._fs_cached
        key = (fs, *(self.settings.get(k) for k in (
            "filter_type", "f_low", "f_high", "ntaps", "window")))
        if getattr(self, "_design_key", None) != key:
            fh = float(self.settings.get("f_high")) or None
            self._design_key = key
            self._design = fd.design_fir(
                self.settings.get("filter_type"), int(self.settings.get("ntaps")),
                sample_rate=fs, f_low=float(self.settings.get("f_low")),
                f_high=fh, window=self.settings.get("window")).astype(np.float32)
        return self._design

    def init_state(self, ctx):
        self._fs_cached = ctx.sample_rate
        return super().init_state(ctx)


@register_block("BasicDecimatingFilter")
class BasicDecimatingFilter(BasicFilter):
    """BasicFilter + decimation (≈ BasicDecimatingFilter) — just set decim>1."""


@register_block("RationalResampler")
class RationalResampler(Block):
    """L/M polyphase rational resampler (suite config 2), ops/resample.py.
    Auto-designs Kaiser taps unless given. The kernel (taps and shapes) is
    built once from the static settings and rebuilt only when they change."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    interp = Setting(default=1, kind="static", limits=(1, 1 << 16))
    decim = Setting(default=1, kind="static", limits=(1, 1 << 16))
    taps = Setting(default=(), kind="static")
    ntaps_per_phase = Setting(default=16, kind="static", limits=(2, 1024))

    def _kernel(self) -> RationalResamplerKernel:
        t = self.settings.get("taps")
        key = (int(self.settings.get("interp")), int(self.settings.get("decim")),
               tuple(t) if t is not None else (),
               int(self.settings.get("ntaps_per_phase")))
        if getattr(self, "_kernel_key", None) != key:
            self._kernel_key = key
            self._kernel_obj = RationalResamplerKernel(
                key[0], key[1], taps=np.asarray(key[2]) if key[2] else None,
                ntaps_per_phase=key[3])
        return self._kernel_obj

    @property
    def ratio(self):
        k = self._kernel()
        return Fraction(k.interp, k.decim)

    @property
    def alignment(self):
        return int(self.settings.get("decim"))

    def init_state(self, ctx):
        ch = ctx.channels.get("in", 0)
        return self._kernel().init_state(ch, ctx.dtype("in", np.float32),
                                         ctx.device)

    def apply(self, state, ins, ctx):
        y, st = self._kernel().apply(ins["in"], state)
        return st, {"out": y}

    def sp_halo(self, ctx):
        """Time-shardable: the polyphase state is the last ntaps_eff−1 inputs
        and the decimation/interpolation phase restarts cleanly at shard
        boundaries (local lengths are alignment·sp-divisible)."""
        k = self._kernel()
        ntaps_eff = k.k_per_phase if k.interp > 1 else len(k.taps)
        return ntaps_eff - 1
