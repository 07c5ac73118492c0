"""Digital modem blocks (the JAX package's ``blocks/digital.py``): constellation
mapping and demapping (hard and soft), RRC pulse shaping, symbol timing
(square-law, Mueller & Müller, polyphase clock sync), differential coding,
preamble correlation, the link instruments (PRBS source, bit packing, BER
meter), packet framing with its CRC32C, and the OFDM chain (modulator,
demodulator, Schmidl & Cox sync, pilots, channel equalizer).

The feedback loops (M&M, the polyphase clock sync, the equalizer's EMA across
OFDM symbols) run one iteration of device ops per symbol with no read back to
the host. The CRC32C is affine over GF(2): one float32 matmul of the payload
bits against a host-built matrix gives every frame's CRC bits at once, bit
for bit the JAX package's bitwise loop. The PRBS generator and the BER meter's
replica stream the recurrence b[i] = b[i−deg] ⊕ b[i−tap2] in NumPy chunks.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch

from ..core.block import Block, Port, SinkBlock
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.cuda_kernels import device_constant, frozen
from ..ops.digital import (default_occupied, iq_to_symbols,
                           make_constellation, mm_timing_recovery,
                           ofdm_demodulate, ofdm_modulate, rrc_taps,
                           symbols_to_iq, timing_phase_energy)
from ..ops.fir import fir_apply, fir_init_state
from ..ops.precision import check_f32_matmul

CONSTELLATIONS = ("BPSK", "QPSK", "8PSK", "QAM16", "QAM64")
_NO_DET = -(1 << 30)          # index of an empty detection record


@register_block("ConstellationMapper")
class ConstellationMapper(Block):
    """int32 symbols → complex64 IQ points (Gray-coded PSK/QAM)."""

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="complex64"),)
    constellation = Setting(default="QPSK", kind="static",
                            choices=CONSTELLATIONS)

    def apply(self, state, ins, ctx):
        table = make_constellation(str(self.settings.get("constellation")))
        return state, {"out": symbols_to_iq(ins["in"], table)}


@register_block("ConstellationDemapper")
class ConstellationDemapper(Block):
    """complex64 IQ → nearest-symbol int32 (hard decision)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="int32"),)
    constellation = Setting(default="QPSK", kind="static",
                            choices=CONSTELLATIONS)

    def apply(self, state, ins, ctx):
        table = make_constellation(str(self.settings.get("constellation")))
        return state, {"out": iq_to_symbols(ins["in"], table)}


@register_block("OfdmModulator")
class OfdmModulator(Block):
    """IQ symbols → OFDM time-domain stream (IFFT + cyclic prefix).

    Consumes ``n_occupied`` symbols per OFDM symbol; produces
    ``fft_size + cp_len`` samples — ratio (fft+cp)/occupied.
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    fft_size = Setting(default=64, kind="static", limits=(8, 1 << 16))
    cp_len = Setting(default=16, kind="static", limits=(0, 1 << 14))
    n_occupied = Setting(default=48, kind="static", limits=(1, 1 << 16))

    def _occ(self):
        return default_occupied(int(self.settings.get("fft_size")),
                                int(self.settings.get("n_occupied")))

    @property
    def ratio(self):
        n = int(self.settings.get("fft_size")) + int(self.settings.get("cp_len"))
        return Fraction(n, int(self.settings.get("n_occupied")))

    @property
    def alignment(self):
        return int(self.settings.get("n_occupied"))

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n_occ = int(self.settings.get("n_occupied"))
        sym = x.reshape(*x.shape[:-1], -1, n_occ)
        y = ofdm_modulate(sym, fft_size=int(self.settings.get("fft_size")),
                          cp_len=int(self.settings.get("cp_len")),
                          occupied=self._occ())
        return state, {"out": y}


@lru_cache(maxsize=64)
def _rrc_f32(sps: int, ntaps: int, beta: float) -> np.ndarray:
    """RRC taps as float32, read-only (uploaded once per device)."""
    return frozen(rrc_taps(sps, ntaps, beta=beta).astype(np.float32))


@register_block("RrcFilter")
class RrcFilter(Block):
    """Root-raised-cosine pulse shaping / matched filter: ``fir_apply``,
    which is the ``fir_banded`` kernel on the card."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    sps = Setting(default=4, kind="static", limits=(1, 256))
    ntaps = Setting(default=65, kind="static", limits=(3, 1 << 14))
    beta = Setting(default=0.35, kind="static", limits=(0.01, 1.0))

    def _taps(self):
        return _rrc_f32(int(self.settings.get("sps")),
                        int(self.settings.get("ntaps")),
                        float(self.settings.get("beta")))

    def init_state(self, ctx):
        return fir_init_state(ctx.channels.get("in", 0), len(self._taps()),
                              ctx.dtype("in", np.complex64), ctx.device)

    def apply(self, state, ins, ctx):
        y, st = fir_apply(ins["in"], self._taps(), state)
        return st, {"out": y}


@register_block("SymbolSampler")
class SymbolSampler(Block):
    """Square-law (non-data-aided) symbol timing: per step, pick the sampling
    phase with maximum symbol-rate energy and decimate by ``sps``. State
    smooths the phase estimate across steps."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    sps = Setting(default=4, kind="static", limits=(2, 256))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("sps")))

    @property
    def alignment(self):
        return int(self.settings.get("sps"))

    def init_state(self, ctx):
        sps = int(self.settings.get("sps"))
        return torch.zeros((sps,), dtype=torch.float32, device=ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        sps = int(self.settings.get("sps"))
        e = timing_phase_energy(x, sps)
        e_s = 0.5 * state + 0.5 * (e if e.ndim == 1 else torch.mean(
            e.reshape(-1, sps), dim=0))
        phase = torch.argmax(e_s).reshape(1)      # first maximum on a tie
        frames = x.reshape(*x.shape[:-1], -1, sps)
        y = frames.index_select(-1, phase)[..., 0]
        return e_s, {"out": y.to(torch.complex64)}


@register_block("MMSymbolSync")
class MMSymbolSync(Block):
    """Mueller & Müller decision-directed symbol synchronizer (feedback loop;
    tracks small timing offsets/clock drift; state = μ + last symbol)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    sps = Setting(default=4, kind="static", limits=(2, 256))
    gain = Setting(default=0.01, kind="static", limits=(1e-6, 1.0))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("sps")))

    @property
    def alignment(self):
        return int(self.settings.get("sps"))

    def init_state(self, ctx):
        return {"mu": torch.zeros((), dtype=torch.float32, device=ctx.device),
                "last": torch.zeros((), dtype=torch.complex64, device=ctx.device)}

    def apply(self, state, ins, ctx):
        syms, mu, last = mm_timing_recovery(
            ins["in"], sps=int(self.settings.get("sps")),
            mu0=state["mu"], last_sym=state["last"],
            gain=float(self.settings.get("gain")))
        return {"mu": mu, "last": last}, {"out": syms}


@register_block("OfdmDemodulator")
class OfdmDemodulator(OfdmModulator):
    """OFDM time-domain stream → IQ symbols (CP strip + FFT); assumes symbol
    alignment (synchronization is upstream)."""

    @property
    def ratio(self):
        n = int(self.settings.get("fft_size")) + int(self.settings.get("cp_len"))
        return Fraction(int(self.settings.get("n_occupied")), n)

    @property
    def alignment(self):
        return (int(self.settings.get("fft_size"))
                + int(self.settings.get("cp_len")))

    def apply(self, state, ins, ctx):
        sym = ofdm_demodulate(ins["in"],
                              fft_size=int(self.settings.get("fft_size")),
                              cp_len=int(self.settings.get("cp_len")),
                              occupied=self._occ())
        return state, {"out": sym.reshape(*sym.shape[:-2], -1)}


@register_block("PfbClockSync")
class PfbClockSync(Block):
    """Polyphase-filterbank clock recovery (≈ GNU Radio pfb_clock_sync_ccf):
    matched filtering and symbol timing in one block. ``nfilts`` polyphase
    arms of the RRC prototype give fractional delays; a Gardner detector on
    the matched output, err = Re{conj(y_mid)·(y_prev − y)}, steers a
    2nd-order loop selecting the arm (and slipping whole samples as the
    accumulated offset crosses sample boundaries).

    Emits one matched-filtered symbol per ``sps`` input samples; one
    iteration of device ops per symbol. A window that would start before the
    carried history starts at its first sample, as ``dynamic_slice`` clamps.
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    sps = Setting(default=4, kind="static", limits=(2, 64))
    nfilts = Setting(default=32, kind="static", limits=(4, 256))
    rolloff = Setting(default=0.35, kind="static", limits=(0.0, 1.0))
    taps_per_arm = Setting(default=11, kind="static", limits=(3, 64))
    loop_bw = Setting(default=0.05, kind="static", limits=(1e-6, 1.0))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("sps")))

    @property
    def alignment(self):
        return int(self.settings.get("sps"))

    def _arms(self) -> np.ndarray:
        if getattr(self, "_bk", None) is None:
            sps = int(self.settings.get("sps"))
            M = int(self.settings.get("nfilts"))
            L = int(self.settings.get("taps_per_arm"))
            proto = rrc_taps(sps * M, L * M, beta=float(
                self.settings.get("rolloff"))).astype(np.float64)
            proto = proto[: L * M]
            arms = np.stack([proto[m::M][::-1] for m in range(M)])
            # unit-energy arms: matched output of a unit-energy RRC pulse ≈ 1
            arms = arms / np.linalg.norm(arms, axis=1, keepdims=True)
            self._bk = frozen(arms.astype(np.float32))
        return self._bk

    def init_state(self, ctx):
        sps = int(self.settings.get("sps"))
        H = int(self.settings.get("taps_per_arm")) + 2 * sps
        dev = ctx.device
        return {"hist": torch.zeros((H,), dtype=torch.complex64, device=dev),
                "acc": torch.full((), float(sps), dtype=torch.float32,
                                  device=dev),              # mid-range
                "rate": torch.zeros((), dtype=torch.float32, device=dev),
                "prev": torch.zeros((), dtype=torch.complex64, device=dev)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        sps = int(self.settings.get("sps"))
        M = int(self.settings.get("nfilts"))
        L = int(self.settings.get("taps_per_arm"))
        bw = float(self.settings.get("loop_bw"))
        damp = float(np.sqrt(2.0) / 2.0)
        denom = 1.0 + 2.0 * damp * bw + bw * bw
        alpha = float(np.float32(4.0 * damp * bw / denom))
        beta = float(np.float32(4.0 * bw * bw / denom))
        max_rate = float(np.float32(0.05))   # samples/symbol deviation clamp
        dev = x.device
        arms = device_constant(self._arms(), dev)
        xa = torch.cat([state["hist"], x], dim=-1)
        nx = xa.shape[-1]
        nsym = x.shape[-1] // sps
        # the on-time window and the Gardner mid-point window, per symbol
        offs = device_constant(np.array([0, -(sps // 2)], np.int64), dev)
        lane = torch.arange(L, device=dev)
        acc, rate, prev = state["acc"], state["rate"], state["prev"]
        ys = []
        for i in range(nsym):
            fl = torch.floor(acc)
            ioff = fl.to(torch.int32).clamp(0, 2 * sps)
            ki = ((acc - fl) * M).to(torch.int32).clamp(0, M - 1)
            starts = (ioff.to(torch.int64) + (i * sps) + offs).clamp(0, nx - L)
            w = xa[starts[:, None] + lane]                   # [2, L]
            arm = arms.index_select(0, ki.reshape(1).to(torch.int64))
            yy = (arm * w).sum(-1)                           # y, y_mid
            y = yy[0]
            err = (yy[1].conj() * (prev - y)).real
            rate = torch.clamp(rate + err * beta, -max_rate, max_rate)
            acc = torch.clamp(acc + err * alpha + rate, 0.0, float(2 * sps))
            prev = y
            ys.append(y)
        H = L + 2 * sps
        s0 = min(max(nsym * sps, 0), nx - H)
        out = torch.stack(ys) if ys else x.new_zeros(0)
        return ({"hist": xa[s0:s0 + H], "acc": acc, "rate": rate,
                 "prev": prev}, {"out": out.to(torch.complex64)})


@register_block("DiffEncoder")
class DiffEncoder(Block):
    """Differential phase encoder: y[n] = x[n]·y[n-1] (phases accumulate), a
    cumulative complex product (``torch.cumprod``, a parallel scan on the
    card); state carries the last output for stream continuity. ≈ GNU Radio
    diff_encoder (phase-domain form)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)

    def init_state(self, ctx):
        return torch.ones((), dtype=torch.complex64, device=ctx.device)

    def apply(self, state, ins, ctx):
        prod = torch.cumprod(ins["in"], dim=-1)
        y = (state * prod).to(torch.complex64)
        # renormalize: pure phase accumulation must not drift in magnitude
        y = y / torch.clamp(y.abs(), min=1e-30)
        return y[..., -1], {"out": y}


@register_block("DiffDecoder")
class DiffDecoder(Block):
    """Differential phase decoder: y[n] = x[n]·conj(x[n-1]); state carries
    the previous input sample."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)

    def init_state(self, ctx):
        return torch.ones((), dtype=torch.complex64, device=ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        prev = torch.cat([state[None], x[..., :-1]], dim=-1)
        return x[..., -1], {"out": (x * prev.conj()).to(torch.complex64)}


def _peaks_top(rho: torch.Tensor, thr: float, cap: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Local maxima of ``rho`` at or above ``thr``, the ``cap`` strongest:
    (magnitudes, indices), the lowest index first among equal magnitudes
    (``jax.lax.top_k``'s order)."""
    zero = rho.new_zeros(1)
    left = torch.cat([zero, rho[:-1]])
    right = torch.cat([rho[1:], zero])
    peak = (rho >= left) & (rho > right) & (rho >= thr)
    score = torch.where(peak, rho, 0.0)
    mags, idxs = torch.sort(score, descending=True, stable=True)
    return mags[:cap], idxs[:cap]


@register_block("PreambleCorrelator")
class PreambleCorrelator(Block):
    """Burst/preamble detection: correlates against a known symbol sequence
    on the device (one frames × preamble matmul), emits the stream unchanged
    on ``out`` and a fixed-capacity detection record ``[2, max_det]`` (row 0:
    in-step index, row 1: normalized correlation magnitude) on ``det``.

    Pair with :class:`DetectionSink` to collect absolute-indexed detections
    on the host (≈ GNU Radio correlate_access_code / corr_est): detection
    indices ride a data port instead of stream tags, since data-dependent
    tags cannot exist within the step that computes them."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"), Port("det", dtype="float32"))
    threshold = Setting(default=0.7, kind="static", limits=(0.0, 1.0),
                        description="normalized correlation threshold")
    max_detections = Setting(default=8, kind="static", limits=(1, 256))

    def __init__(self, preamble=(), name=None, **settings):
        super().__init__(name=name, **settings)
        self._pre = np.asarray(preamble, np.complex64)
        if self._pre.size == 0:
            raise GrError("PreambleCorrelator needs a preamble sequence")
        self._pre = self._pre / np.linalg.norm(self._pre)
        self._pre_conj = frozen(np.conj(self._pre).astype(np.complex64))

    def out_channels(self, port, in_channels):
        if port == "det":
            return 2
        return in_channels.get("in", 0)

    def init_state(self, ctx):
        return torch.zeros((len(self._pre) - 1,), dtype=torch.complex64,
                           device=ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        k = len(self._pre)
        cap = int(self.settings.get("max_detections"))
        thr = float(np.float32(self.settings.get("threshold")))
        xa = torch.cat([state, x], dim=-1)
        n = x.shape[-1]
        F = xa.unfold(-1, k, 1)                            # [n, k] windows
        check_f32_matmul("PreambleCorrelator")
        c = (F @ device_constant(self._pre_conj, x.device)).abs()
        e = torch.sqrt(torch.sum(F.abs() ** 2, dim=-1)) + 1e-12
        mags, idxs = _peaks_top(c / e, thr, cap)          # normalized [0,1]
        idxs = torch.where(mags > 0, idxs - (k - 1), _NO_DET)
        # the det stream has the data's length (single-rate algebra); only
        # the first max_detections columns carry records
        det = torch.zeros((2, n), dtype=torch.float32, device=x.device)
        det[0, :cap] = idxs.to(torch.float32)
        det[1, :cap] = mags
        return xa[n:n + k - 1], {"out": x, "det": det}


def _records(det: np.ndarray, abs_index: int):
    """(absolute index, magnitude) of each filled record of a ``det`` array."""
    for i, m in zip(det[0], det[1]):
        if m > 0 and i > -(1 << 29):
            yield int(abs_index + i), float(m)


@register_block("DetectionSink")
class DetectionSink(SinkBlock):
    """Collects PreambleCorrelator ``det`` records into absolute-indexed
    detections: ``.detections`` = list of (abs_sample_index, correlation)."""

    IN = (Port("in", dtype="float32"),)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.detections: list[tuple[int, float]] = []

    def consume(self, arrays, tags, n_valid, abs_index):
        self.detections.extend(_records(np.asarray(arrays["in"]), abs_index))


_PRBS_TAPS = {7: (7, 6), 9: (9, 5), 15: (15, 14), 23: (23, 18), 31: (31, 28)}
# the generator keeps deg·2^12 bits of history: chunks of tap2·2^12 bits
_PRBS_DOUBLINGS = 12


class PrbsStream:
    """The ITU-T PRBS of ``order`` from the all-ones seed (a Fibonacci LFSR),
    streamed: ``take(n)`` returns the next ``n`` bits as uint8.

    The LFSR's output obeys b[i] = b[i−deg] ⊕ b[i−tap2] (the seed is the
    deg bits before the first). Squaring its polynomial over GF(2) gives
    b[i] = b[i−deg·2^k] ⊕ b[i−tap2·2^k] wherever the plain recurrence holds
    back to i − (2^k−1)·deg, so once deg·2^k bits exist the next tap2·2^k
    come from one NumPy XOR of two earlier slices."""

    def __init__(self, order: int):
        self.deg, self.tap2 = _PRBS_TAPS[int(order)]
        self._hist = np.ones(self.deg, np.uint8)      # the all-ones seed

    def take(self, n: int) -> np.ndarray:
        deg, tap2 = self.deg, self.tap2
        h = len(self._hist)
        buf = np.empty(h + n, np.uint8)
        buf[:h] = self._hist
        pos, end = h, h + n
        while pos < end:
            k = 0
            while k < _PRBS_DOUBLINGS and (deg << (k + 1)) <= pos:
                k += 1
            a, c = deg << k, tap2 << k
            m = min(c, end - pos)
            np.bitwise_xor(buf[pos - a:pos - a + m], buf[pos - c:pos - c + m],
                           out=buf[pos:pos + m])
            pos += m
        self._hist = buf[-min(len(buf), deg << _PRBS_DOUBLINGS):].copy()
        return buf[h:]


@register_block("PrbsSource")
class PrbsSource(Block):
    """ITU-T PRBS bit source (PRBS7/9/15/23/31, Fibonacci LFSR) — the standard
    link-measurement stimulus (≈ GNU Radio glfsr_source_b). Bits are generated
    host-side per step (FEED) and streamed as int32 0/1."""

    IN = ()
    OUT = (Port("out", dtype="int32"),)
    FEED = True
    order = Setting(default=15, kind="static", choices=tuple(_PRBS_TAPS))
    n_bits = Setting(default=0, kind="static",
                     description="0 = endless")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._lfsr = PrbsStream(int(self.settings.get("order")))

    def host_feed(self, n, abs_index):
        total = int(self.settings.get("n_bits"))
        if total and abs_index >= total:
            return None
        take = n if not total else min(n, total - abs_index)
        return {"out": self._lfsr.take(take).astype(np.int32)}, take

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("PackBits")
class PackBits(Block):
    """k bits (int32 0/1, MSB first) → one symbol int32 (≈ pack_k_bits_bb)."""

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="int32"),)
    k = Setting(default=2, kind="static", limits=(1, 30))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("k")))

    @property
    def alignment(self):
        return int(self.settings.get("k"))

    def apply(self, state, ins, ctx):
        k = int(self.settings.get("k"))
        x = ins["in"].reshape(*ins["in"].shape[:-1], -1, k)
        w = device_constant(2 ** np.arange(k - 1, -1, -1, dtype=np.int32),
                            x.device)
        return state, {"out": torch.sum(x * w, dim=-1, dtype=torch.int32)}


@register_block("UnpackBits")
class UnpackBits(Block):
    """One symbol int32 → k bits (MSB first) (≈ unpack_k_bits_bb)."""

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="int32"),)
    k = Setting(default=2, kind="static", limits=(1, 30))

    @property
    def ratio(self):
        return Fraction(int(self.settings.get("k")), 1)

    def apply(self, state, ins, ctx):
        k = int(self.settings.get("k"))
        x = ins["in"]
        shifts = device_constant(np.arange(k - 1, -1, -1, dtype=np.int32),
                                 x.device)
        bits = (x[..., None] >> shifts) & 1
        return state, {"out": bits.reshape(*x.shape[:-1], -1)}


@register_block("BerSink")
class BerSink(SinkBlock):
    """Bit-error-rate meter: compares the incoming bit stream against a local
    PRBS replica after self-synchronizing to it (correlation over the first
    window). ``.report()`` → dict(bits, errors, ber, synced). The replica
    streams on from the synchronized lag, so each step costs its own bits."""

    IN = (Port("in", dtype="int32"),)
    order = Setting(default=15, kind="static", choices=tuple(_PRBS_TAPS))
    sync_window = Setting(default=4096, kind="static", limits=(64, 1 << 20))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._rx: list[np.ndarray] = []
        self._synced = None      # (lag, invert)
        self._replica = None     # PrbsStream positioned at the next rx bit
        self._bits = 0
        self._errors = 0
        deg = int(self.settings.get("order"))
        self._period = (1 << deg) - 1

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        self._rx.append(np.asarray(arrays["in"][..., :n_valid]).ravel())
        if self._synced is None:
            w = int(self.settings.get("sync_window"))
            if sum(len(c) for c in self._rx) < w:
                return
            order = int(self.settings.get("order"))
            rx = np.concatenate(self._rx)[:w].astype(np.int8)
            ref = PrbsStream(order).take(w + self._period).astype(np.int8)
            best = (w + 1, 0, False)
            x = 2 * rx - 1
            for lag in range(self._period):
                r = 2 * ref[lag:lag + w].astype(np.int32) - 1
                c = int(np.dot(x, r))
                if w - abs(c) < best[0] * 2:
                    best = ((w - abs(c)) // 2, lag, c < 0)
            self._synced = (best[1], best[2])
            self._replica = PrbsStream(order)
            self._replica.take(best[1])
            pending = np.concatenate(self._rx)
            self._rx = []
        else:
            pending = self._rx.pop()
        ref = self._replica.take(len(pending)).astype(np.int8)
        if self._synced[1]:
            ref = 1 - ref
        self._errors += int(np.sum(pending.astype(np.int8) != ref))
        self._bits += len(pending)

    def report(self) -> dict:
        return {"bits": self._bits, "errors": self._errors,
                "ber": self._errors / self._bits if self._bits else None,
                "synced": self._synced is not None}


_CRC32C_POLY = 0x82F63B78


@lru_cache(maxsize=16)
def _crc32c_affine(n_bits: int) -> tuple[np.ndarray, np.ndarray]:
    """The CRC32C (Castagnoli, reflected) of ``n_bits`` 0/1 bits as an affine
    map over GF(2): its 32 bits, MSB first, are (bits @ G + k) mod 2.

    One step of the bitwise CRC is c ← S(c ⊕ b) with S(c) = c >> 1, ⊕ poly
    when c is odd: linear in (c, b). A one at position i alone enters as
    S(1) = poly and meets n_bits − 1 − i more steps of S, so its row is
    S^(n_bits−1−i)(poly); the constant k is the CRC of n_bits zeros,
    S^n_bits(0xFFFFFFFF) ⊕ 0xFFFFFFFF."""
    s = lambda c: ((c >> 1) ^ _CRC32C_POLY) if c & 1 else c >> 1
    rows = np.empty(n_bits, np.int64)
    v, k0 = _CRC32C_POLY, 0xFFFFFFFF
    for i in range(n_bits - 1, -1, -1):
        rows[i] = v
        v, k0 = s(v), s(k0)
    shifts = np.arange(31, -1, -1)
    g = ((rows[:, None] >> shifts) & 1).astype(np.float32)
    k = (((k0 ^ 0xFFFFFFFF) >> shifts) & 1).astype(np.int64)
    return frozen(g, k)


@register_block("PacketFramer")
class PacketFramer(Block):
    """Bits → framed QPSK burst symbols: [preamble | 16-bit length | payload
    bits as QPSK | 32-bit CRC32C]. Fixed frame geometry per step: consumes
    ``payload_bits`` per frame, emits ``frame_syms`` symbols (rate algebra
    stays static). Pair with PreambleCorrelator + PacketReceiver.
    """

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="complex64"),)
    payload_bits = Setting(default=512, kind="static", limits=(8, 1 << 16))
    preamble_len = Setting(default=63, kind="static", limits=(15, 255))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        rng = np.random.default_rng(0xC0FFEE)   # fixed, shared with receiver
        m = int(self.settings.get("preamble_len"))
        self._preamble = frozen(np.exp(
            1j * np.pi / 4 * (2 * rng.integers(0, 4, m) + 1)
        ).astype(np.complex64))

    @property
    def preamble(self) -> np.ndarray:
        return self._preamble

    def _geometry(self):
        pb = int(self.settings.get("payload_bits"))
        if pb % 2:
            raise GrError("payload_bits must be even (QPSK: 2 bits/symbol)")
        header_syms = 8            # 16-bit length as QPSK
        crc_syms = 16              # 32-bit CRC32C as QPSK
        m = int(self.settings.get("preamble_len"))
        return pb, m + header_syms + pb // 2 + crc_syms

    @property
    def ratio(self):
        pb, fs = self._geometry()
        return Fraction(fs, pb)

    @property
    def alignment(self):
        return self._geometry()[0]

    def apply(self, state, ins, ctx):
        dev = ins["in"].device
        bits = ins["in"].to(torch.int64)
        pb, _ = self._geometry()
        payload = bits.reshape(-1, pb)
        nframes = payload.shape[0]
        g, k = _crc32c_affine(pb)
        # 0/1 sums of at most 2^16 terms: exact in float32 at any rung
        crc_bits = ((payload.to(torch.float32) @ device_constant(g, dev))
                    .to(torch.int64) + device_constant(k, dev)) & 1
        hdr = device_constant(((pb >> np.arange(15, -1, -1)) & 1
                               ).astype(np.int64), dev)
        allbits = torch.cat([hdr.expand(nframes, 16), payload, crc_bits], -1)
        pairs = allbits.reshape(nframes, -1, 2)
        body = device_constant(_qpsk_gray(), dev)[pairs[..., 0] * 2
                                                  + pairs[..., 1]]
        pre = device_constant(self._preamble, dev).expand(nframes, -1)
        return state, {"out": torch.cat([pre, body], -1).reshape(-1)}


@lru_cache(maxsize=1)
def _qpsk_gray() -> np.ndarray:
    """The framer's four symbols e^{j(π/4 + π/2·gray(s))}, the angle in
    float32 as the JAX package forms it."""
    gray = np.array([0, 1, 3, 2], np.float32)
    ang = np.float32(np.pi / 4) + np.float32(np.pi / 2) * gray
    return frozen(np.exp(1j * ang.astype(np.float64)).astype(np.complex64))


@register_block("PacketReceiver")
class PacketReceiver(SinkBlock):
    """Host-side packet extraction: feed it the SAME stream the
    PreambleCorrelator saw (its ``out`` port) — it buffers samples, and
    each detection (the correlator's ``det`` port on input ``det``)
    demodulates header/payload/CRC. ``.packets`` = list of dicts(index, ok,
    bits)."""

    IN = (Port("in", dtype="complex64"), Port("det", dtype="float32"))
    preamble_len = Setting(default=63, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.complex64)
        self._buf_start = 0            # absolute index of _buf[0]
        self.packets: list[dict] = []

    def consume(self, arrays, tags, n_valid, abs_index):
        x = np.asarray(arrays["in"][..., :n_valid])
        if self._buf.size == 0:
            self._buf_start = abs_index
        self._buf = np.concatenate([self._buf, x])
        det = np.asarray(arrays.get("det", np.zeros((2, 0))))
        for i, _ in _records(det, abs_index):
            self._try_decode(i)
        # bound the buffer: keep 1<<18 most recent samples
        if len(self._buf) > (1 << 18):
            drop = len(self._buf) - (1 << 18)
            self._buf = self._buf[drop:]
            self._buf_start += drop

    def _try_decode(self, det_abs: int) -> None:
        pre = int(self.settings.get("preamble_len"))
        start = det_abs - self._buf_start + pre
        if start < 0:
            return
        buf = self._buf

        def read_syms(off, n):
            if start + off + n > len(buf):
                return None
            return buf[start + off: start + off + n]

        hdr = read_syms(0, 8)
        if hdr is None:
            return
        gray_rev = {0: 0, 1: 1, 3: 2, 2: 3}

        def demod_bits(syms):
            k = np.round((np.angle(syms) - np.pi / 4) / (np.pi / 2)) % 4
            out = []
            for s in k.astype(int):
                v = gray_rev[s]
                out += [(v >> 1) & 1, v & 1]
            return np.asarray(out, np.int64)

        hbits = demod_bits(hdr)
        length = int("".join(map(str, hbits)), 2)
        if length <= 0 or length > (1 << 15) or length % 2:
            return
        body = read_syms(8, length // 2 + 16)
        if body is None:
            return
        bbits = demod_bits(body)
        payload, crc_bits = bbits[:length], bbits[length:]
        g, k = _crc32c_affine(length)
        # 0/1 sums of at most 2^15 terms: exact in float32
        crc = ((payload.astype(np.float32) @ g).astype(np.int64) + k) & 1
        ok = bool(np.array_equal(crc, crc_bits))
        self.packets.append({"index": det_abs, "ok": ok,
                             "bits": payload.astype(np.int32)})


def schmidl_cox_preamble(fft_size: int, cp_len: int, seed: int = 0x5C) -> np.ndarray:
    """Time-domain Schmidl & Cox preamble: PN symbols on EVEN subcarriers only
    → the useful part repeats [A A]; receivers detect via lag-N/2
    autocorrelation. Returns fft_size+cp_len complex samples."""
    rng = np.random.default_rng(seed)
    spec = np.zeros(fft_size, complex)
    even = np.arange(2, fft_size // 2, 2)
    pn = np.exp(1j * np.pi / 2 * rng.integers(0, 4, len(even)))
    spec[even] = pn
    spec[-even] = np.conj(pn)[::-1] * 0 + np.exp(
        1j * np.pi / 2 * rng.integers(0, 4, len(even)))
    td = np.fft.ifft(spec) * np.sqrt(fft_size)
    td = td / np.sqrt(np.mean(np.abs(td) ** 2))
    return np.concatenate([td[-cp_len:], td]).astype(np.complex64)


@register_block("OfdmSync")
class OfdmSync(Block):
    """Schmidl & Cox OFDM synchronizer: lag-N/2 autocorrelation over the
    repeated preamble half gives a timing metric (plateau → peak) and the
    fractional CFO from the correlation angle. Fully feed-forward (cumsum
    sliding sums — no sequential loop).

    Ports: ``out`` passes the stream through; ``det`` carries up to
    ``max_detections`` records [3 rows: in-step index, metric, cfo_est
    (subcarrier-spacing units)] — collect with :class:`OfdmSyncSink`.
    """

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"), Port("det", dtype="float32"))
    fft_size = Setting(default=64, kind="static", limits=(16, 1 << 14))
    cp_len = Setting(default=16, kind="static")
    threshold = Setting(default=0.6, kind="static", limits=(0.0, 1.0))
    max_detections = Setting(default=4, kind="static", limits=(1, 64))

    def out_channels(self, port, in_channels):
        return 3 if port == "det" else in_channels.get("in", 0)

    def init_state(self, ctx):
        nf = int(self.settings.get("fft_size"))
        return torch.zeros((nf,), dtype=torch.complex64,
                           device=ctx.device)   # N samples of history

    def apply(self, state, ins, ctx):
        x = ins["in"].to(torch.complex64)
        nf = int(self.settings.get("fft_size"))
        half = nf // 2
        cap = int(self.settings.get("max_detections"))
        thr = float(np.float32(self.settings.get("threshold")))
        n = x.shape[-1]
        xa = torch.cat([state, x], dim=-1)             # [nf + n]
        # P(d) = sum_{m<half} conj(xa[d+m]) xa[d+m+half]  via cumsum
        prod = xa[:-half].conj() * xa[half:]            # [nf/2 + n]
        cp_ = torch.cumsum(torch.cat([prod.new_zeros(1), prod]), dim=0)
        P = cp_[half:half + n] - cp_[:n]                # windows of length half
        e = xa.abs() ** 2
        ce = torch.cumsum(torch.cat([e.new_zeros(1), e]), dim=0)
        E1 = ce[half:half + n] - ce[:n]          # energy of window 1 [d, d+half)
        E2 = ce[nf:nf + n] - ce[half:half + n]   # energy of window 2
        # Cauchy-Schwarz normalization: |P|^2 <= E1*E2, so m in [0, 1]
        m = P.abs() ** 2 / (E1 * E2 + 1e-12)
        mags, idxs = _peaks_top(m, thr, cap)
        cfo = torch.angle(P[idxs]) / float(np.float32(np.pi))
        det = torch.zeros((3, n), dtype=torch.float32, device=x.device)
        det[0, :cap] = torch.where(mags > 0, idxs - nf, _NO_DET).to(torch.float32)
        det[1, :cap] = mags
        det[2, :cap] = torch.where(mags > 0, cfo, 0.0)
        return xa[n:n + nf], {"out": x, "det": det}


@register_block("OfdmSyncSink")
class OfdmSyncSink(SinkBlock):
    """Collects OfdmSync detections, clustering the S&C plateau (multiple
    peaks per preamble within ``min_gap`` samples → keep the strongest):
    ``.detections`` = list of (abs_sample_index, metric, cfo_subcarriers)."""

    IN = (Port("in", dtype="float32"),)
    min_gap = Setting(default=256, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.detections: list[tuple[int, float, float]] = []

    def consume(self, arrays, tags, n_valid, abs_index):
        det = np.asarray(arrays["in"])
        gap = int(self.settings.get("min_gap"))
        for i, m, c in sorted(zip(det[0], det[1], det[2])):
            if m <= 0 or i <= -(1 << 29):
                continue
            rec = (int(abs_index + i), float(m), float(c))
            if self.detections and rec[0] - self.detections[-1][0] < gap:
                if rec[1] > self.detections[-1][1]:   # keep the stronger
                    self.detections[-1] = rec
            else:
                self.detections.append(rec)


def _pilot_comb(settings) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The comb-pilot layout shared by the inserter and the equalizer:
    (pilot mask over the occupied subcarriers, pilot positions, pilot values):
    every ``pilot_spacing``-th occupied subcarrier carries a BPSK pilot, its
    sign alternating by pilot index."""
    n_occ = int(settings.get("n_occupied"))
    sp = int(settings.get("pilot_spacing"))
    idx = np.arange(0, n_occ, sp)
    mask = np.zeros(n_occ, bool)
    mask[idx] = True
    vals = np.where(np.arange(len(idx)) % 2 == 0, 1.0, -1.0)
    return mask, idx, vals.astype(np.complex64)


@register_block("OfdmPilotInserter")
class OfdmPilotInserter(Block):
    """Insert comb-type pilots into the occupied-subcarrier stream: every
    ``pilot_spacing``-th occupied subcarrier carries a known BPSK pilot
    (sign alternates by pilot index), the rest carry data. Pairs with
    :class:`OfdmChannelEqualizer` on the receive side; sits between the
    symbol mapper and :class:`OfdmModulator`."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    n_occupied = Setting(default=48, kind="static")
    pilot_spacing = Setting(default=8, kind="static", limits=(2, 1 << 10))

    @property
    def n_data(self):
        return int((~_pilot_comb(self.settings)[0]).sum())

    @property
    def ratio(self):
        return Fraction(int(self.settings.get("n_occupied")), self.n_data)

    @property
    def alignment(self):
        return self.n_data

    def apply(self, state, ins, ctx):
        x = ins["in"]
        mask, idx, vals = _pilot_comb(self.settings)
        n_occ, nd = len(mask), self.n_data
        dev = x.device
        frames = x.reshape(*x.shape[:-1], -1, nd)
        out = torch.zeros(frames.shape[:-1] + (n_occ,), dtype=torch.complex64,
                          device=dev)
        out[..., device_constant(np.flatnonzero(~mask), dev)] = frames
        out[..., device_constant(idx, dev)] = device_constant(vals, dev)
        return state, {"out": out.reshape(*x.shape[:-1],
                                          x.shape[-1] // nd * n_occ)}


@lru_cache(maxsize=16)
def _interp_plan(fft: int, n_occ: int, spacing: int):
    """``jnp.interp``'s terms for the equalizer's pilot → subcarrier
    interpolation, all host constants: (pilot order, index i of the right
    neighbour, weight (x − xp[i−1]) / (xp[i] − xp[i−1]) in float32, the
    degenerate-interval, left-of-range and right-of-range masks)."""
    pidx = np.arange(0, n_occ, spacing)
    occ = default_occupied(fft, n_occ)
    freq = np.where(occ < fft // 2, occ, occ - fft).astype(np.float32)
    xp_f = freq[pidx]
    psort = np.argsort(xp_f)
    xp = xp_f[psort]
    i = np.minimum(np.maximum(np.searchsorted(xp, freq, side="right"), 1),
                   len(xp) - 1)
    dx = xp[i] - xp[i - 1]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(np.float32).eps)
    t = ((freq - xp[i - 1]) / np.where(dx0, np.float32(1), dx)).astype(np.float32)
    return frozen(psort.astype(np.int64), i.astype(np.int64), t, dx0,
                  freq < xp[0], freq > xp[-1])


@register_block("OfdmChannelEqualizer")
class OfdmChannelEqualizer(Block):
    """Pilot-based per-subcarrier channel estimation + equalization on the
    demodulated occupied-subcarrier stream (the output of
    :class:`OfdmDemodulator`).

    LS estimate at the comb pilots (known BPSK pattern, matching
    :class:`OfdmPilotInserter`), linear interpolation across subcarriers in
    signed frequency (clamped to the end pilots, as ``jnp.interp``),
    optional EMA smoothing across OFDM symbols (``smoothing`` 0..1, carried
    in state so it spans scheduler steps; one iteration of device ops per
    OFDM symbol), then zero-forcing or MMSE equalization; pilots are
    stripped from the output (ratio n_data/n_occupied)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    fft_size = Setting(default=64, kind="static",
                       description="FFT size of the upstream demodulator — "
                                   "needed to interpolate in true (signed) "
                                   "frequency, not occupied-array order")
    n_occupied = Setting(default=48, kind="static")
    pilot_spacing = Setting(default=8, kind="static", limits=(2, 1 << 10))
    mode = Setting(default="zf", kind="static", choices=("zf", "mmse"))
    noise_var = Setting(default=0.0, description="MMSE noise variance")
    smoothing = Setting(default=0.0, kind="static", limits=(0.0, 0.999),
                        description="EMA factor across OFDM symbols "
                                    "(0 = per-symbol estimates)")

    @property
    def n_data(self):
        return int((~_pilot_comb(self.settings)[0]).sum())

    @property
    def ratio(self):
        return Fraction(self.n_data, int(self.settings.get("n_occupied")))

    @property
    def alignment(self):
        return int(self.settings.get("n_occupied"))

    def init_state(self, ctx):
        n_occ = int(self.settings.get("n_occupied"))
        # carried channel estimate (EMA) + a has-history flag
        return {"h": torch.ones(n_occ, dtype=torch.complex64, device=ctx.device),
                "warm": torch.zeros((), dtype=torch.bool, device=ctx.device)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        dev = x.device
        mask, pidx, pvals = _pilot_comb(self.settings)
        n_occ, nd = len(mask), self.n_data
        frames = x.reshape(-1, n_occ)
        psort, i, t, dx0, left, right = (
            device_constant(a, dev) for a in _interp_plan(
                int(self.settings.get("fft_size")), n_occ,
                int(self.settings.get("pilot_spacing"))))
        # LS at the pilots (÷ ±1 is × ±1), in signed-frequency order
        h_p = (frames[:, device_constant(pidx, dev)]
               * device_constant(pvals.real.astype(np.float32), dev))[:, psort]

        def interp(fp):
            lo, hi = fp[:, i - 1], fp[:, i]
            f = torch.where(dx0, lo, lo + t * (hi - lo))
            f = torch.where(left, fp[:, :1], f)
            return torch.where(right, fp[:, -1:], f)

        h_sym = torch.complex(interp(h_p.real), interp(h_p.imag))
        a = float(self.settings.get("smoothing"))
        if a > 0.0 and h_sym.shape[0]:
            h = torch.where(state["warm"], state["h"] * a + h_sym[0] * (1 - a),
                            h_sym[0])
            rows = [h]
            for s in range(1, h_sym.shape[0]):
                h = h * a + h_sym[s] * (1 - a)
                rows.append(h)
            h_sym = torch.stack(rows)
            new_state = {"h": h, "warm": torch.ones((), dtype=torch.bool,
                                                    device=dev)}
        else:
            new_state = state
        if str(self.settings.get("mode")) == "mmse":
            nv = float(np.float32(ctx.p("noise_var", 0.0)))
            eq = frames * (h_sym.conj() / (h_sym.abs() ** 2 + nv))
        else:
            eq = frames / h_sym
        out = eq[:, device_constant(np.flatnonzero(~mask), dev)]
        return new_state, {"out": out.reshape(*x.shape[:-1],
                                              x.shape[-1] // n_occ * nd)}


@register_block("SoftDemapper")
class SoftDemapper(Block):
    """complex64 IQ → per-bit max-log-MAP LLRs (positive = bit 0), the glue
    between any Gray constellation and the soft FEC decoders (LdpcDecoder).

    For each bit position b: LLR_b = (min_{s: bit_b(s)=0} |y−s|²
    − min_{s: bit_b(s)=1} |y−s|²) / noise_var. Bits come out LSB-first per
    symbol (the constellation index IS the bit label, matching
    ConstellationMapper). Ratio bits_per_symbol/1."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)
    constellation = Setting(default="QPSK", kind="static",
                            choices=CONSTELLATIONS)
    noise_var = Setting(default=1.0,
                        description="channel noise variance (per complex "
                                    "sample); scales LLR confidence")

    def _table(self):
        return make_constellation(str(self.settings.get("constellation")))

    @property
    def bits_per_symbol(self):
        return int(np.log2(len(self._table())))

    @property
    def ratio(self):
        return Fraction(self.bits_per_symbol, 1)

    def apply(self, state, ins, ctx):
        y = ins["in"]
        dev = y.device
        table = self._table()
        labels = np.arange(len(table))
        d2 = (y[..., None] - device_constant(table, dev)).abs() ** 2  # [.., T, M]
        llrs = []
        for b in range(self.bits_per_symbol):
            zero = (labels >> b) & 1 == 0
            d0 = d2[..., device_constant(np.flatnonzero(zero), dev)].amin(-1)
            d1 = d2[..., device_constant(np.flatnonzero(~zero), dev)].amin(-1)
            llrs.append(d1 - d0)
        nv = max(np.float32(ctx.p("noise_var", 1.0)), np.float32(1e-12))
        out = torch.stack(llrs, dim=-1) / torch.full((), float(nv), device=dev)
        return state, {"out": out.reshape(y.shape[:-1] + (-1,))
                       .to(torch.float32)}
