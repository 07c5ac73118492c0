"""Polyphase filter-bank (PFB) channelizer / synthesizer.

Critically sampled M-channel analysis bank:

    X[n, p] = x[nM + p]                                  (corner turn, reshape)
    v[n, p] = Σ_j h[jM + p] · X[n−j, p]                  (M branch FIRs of P taps)
    y[n, m] = FFT_p(v[n, ·])[m]                          (batched FFT)

Channel m is centered at m·fs/M, output rate fs/M. The weighted overlap-add
synthesis bank inverts it (channel → wideband).

The oversampled bank (GNU Radio's ``oversample_rate`` O; harris, Dick & Rice,
IEEE Trans. MTT 51(4), 2003) advances D = M/O input samples a frame. With i
the absolute input index, n the absolute frame and i = (n+1)·D − M − jM + p:

    y[n, m] = Σ_{j<P, p<M} h[jM + p] · x[i] · e^{−j2π·m·i/M}

which at O = 1 is the critically sampled bank above. Since i ≡ (n+1)·D + p
(mod M), it is the same branch FIRs over frames that overlap by M − D
samples, the same FFT, and a phase e^{−j2π·m·s·D/M} per frame, s = (n+1) mod
L with L = M/gcd(M, D): the circular shift of the branch outputs by
(n+1)·D mod M, in the frequency domain. One body (:func:`_analyze`) runs
every D in [1, M]: the branch FIRs as one multiply-add a tap over strided
views of the input (real taps on the float32 view of the complex samples),
the FFT across the branch axis with ``torch.fft`` (cuFFT on the card), and
one pass that writes the channel-major output with the per-frame phase,
which at D = M (L = 1) is a row of exact ones.

The carried state is the last P·M − D input samples and the next frame's
index. At D = M it is held as the reference's rows [P−1, M] (the samples in
input order; every frame's index is 0), otherwise as ``{"hist", "frame"}``:
:func:`pfb_state` and :func:`pfb_history` map between the two.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.errors import GrError
from . import filter_design as fd


def design_pfb_taps(n_channels: int, taps_per_phase: int = 8, *,
                    beta: float = 9.6, rolloff: float = 1.0) -> np.ndarray:
    """Prototype low-pass for an M-channel PFB: cutoff fs/(2M), length M·P."""
    m = n_channels
    ntaps = m * taps_per_phase
    if ntaps % 2 == 0:
        ntaps += 1
    h = fd.design_fir("lowpass", ntaps, sample_rate=float(m),
                      f_low=0.5 * rolloff, window="Kaiser", beta=beta)
    return np.pad(h, (0, m * taps_per_phase + m - len(h)))[: m * taps_per_phase]


def branch_fir_macs(xc: torch.Tensor, hp: torch.Tensor, r: int) -> torch.Tensor:
    """Per-branch FIR via shift-multiply-accumulate.

    xc: [..., P−1+R, M] rows-with-history; hp: [P, M] real branch taps →
    [..., R, M]: ``v[n, p] = Σ_j hp[j, p]·xc[n + (P−1) − j, p]``, summed in j
    order."""
    p = hp.shape[0]
    cplx = xc.is_complex()
    xr = torch.view_as_real(xc) if cplx else xc
    h = hp.to(xr.dtype)
    if cplx:
        h = h[..., None]                  # real taps on both rails
    acc = None
    for j in range(p):
        seg = xr[..., (p - 1 - j): (p - 1 - j) + r, :, :] if cplx \
            else xr[..., (p - 1 - j): (p - 1 - j) + r, :]
        term = seg * h[j]
        acc = term if acc is None else acc.add_(term)
    return torch.view_as_complex(acc) if cplx else acc


def pfb_init_state(n_channels: int, taps_per_phase: int,
                   device: torch.device | str = "cpu",
                   dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Branch FIR history: [taps_per_phase-1, M] previous corner-turn rows."""
    return torch.zeros((taps_per_phase - 1, n_channels), dtype=dtype,
                       device=device)


def _branch_taps(taps, p: int, m: int, device: torch.device,
                 scale: float = 1.0) -> torch.Tensor:
    """Prototype taps h[j·M + p] → [P, M] float32 on ``device``."""
    if torch.is_tensor(taps):
        t = taps.to(device=device, dtype=torch.float32)
    else:
        t = torch.from_numpy(np.asarray(taps, np.float32)).to(device)
    hp = t.reshape(p, m)
    return hp * scale if scale != 1.0 else hp


def pfb_analyze(x: torch.Tensor, taps, state: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Critically sampled analysis step: the bank at hop M.

    x: [T] complex with T % M == 0; taps: [M·P] prototype (host or tensor);
    state: [P-1, M]. Returns (channels [M, T//M], new_state)."""
    m = state.shape[-1]
    return pfb_analyze_oversampled(x, taps, state, m, m)


def pfb_hop(n_channels: int, oversample_rate: float) -> int:
    """The oversampled bank's hop D = M/O in input samples; a ``GrError``
    where it is not a whole number of samples in [1, M], as GNU Radio's
    ``pfb_channelizer_ccf`` refuses such an ``oversample_rate``."""
    m, o = int(n_channels), float(oversample_rate)
    d = m / o if o > 0 else 0.0
    if not (1.0 <= o <= m and abs(d - round(d)) <= 1e-9 * m):
        raise GrError(f"pfb_channelizer: oversample_rate {oversample_rate!r} "
                      f"must be M/i for a whole i in [1, M] (M = {m})")
    return int(round(d))


def shift_period(n_channels: int, hop: int) -> int:
    """Frames after which the oversampled bank's circular shift repeats."""
    return n_channels // math.gcd(n_channels, hop)


def frame_state(frame: int, period: int) -> torch.Tensor:
    """The oversampled bank's frame index modulo the shift period, as a 0-d
    int64 host tensor (read without a device sync)."""
    return torch.tensor(int(frame) % period, dtype=torch.int64)


def pfb_state(hist: torch.Tensor, frame: int, n_channels: int, hop: int):
    """The bank's carried state at hop D = ``hop`` from ``hist``, its last
    P·M − D input samples, and ``frame``, the next frame's absolute index:
    rows [P−1, M] at D = M, else ``{"hist", "frame"}`` (:func:`frame_state`)."""
    if hop == n_channels:
        return hist.reshape(-1, n_channels)
    return {"hist": hist, "frame": frame_state(frame, shift_period(n_channels, hop))}


def pfb_history(state) -> tuple[torch.Tensor, int]:
    """:func:`pfb_state`'s inverse: (the last P·M − D input samples, the next
    frame's index modulo the shift period)."""
    if torch.is_tensor(state):
        return state.reshape(-1), 0
    return state["hist"], int(state["frame"])


def pfb_os_init_state(n_channels: int, taps_per_phase: int, hop: int,
                      device: torch.device | str = "cpu",
                      dtype: torch.dtype = torch.complex64):
    """The bank's state at hop D before any input (:func:`pfb_state`)."""
    hist = torch.zeros(taps_per_phase * n_channels - hop, dtype=dtype,
                       device=device)
    return pfb_state(hist, 0, n_channels, hop)


@functools.lru_cache(maxsize=16)
def _shift_phases(m: int, hop: int, device: torch.device) -> torch.Tensor:
    """[L, L, M] complex64: row ``[s, a]`` is ``e^{−j2π·m·((s + a) mod
    L)·D/M}`` over the channels m, the phase of the frame ``a`` frames after
    one whose shift index is ``s``. Values on the axes are exact (±1, ±j)."""
    period = shift_period(m, hop)
    s = np.arange(period)
    k = (s[:, None] + s[None, :]) % period                     # [s, a]
    r = (k[:, :, None] * hop * np.arange(m)[None, None, :]) % m
    ang = -2.0 * np.pi * r / m
    re, im = np.cos(ang), np.sin(ang)
    re[np.abs(re) < 1e-12] = 0.0
    im[np.abs(im) < 1e-12] = 0.0
    return torch.from_numpy((re + 1j * im).astype(np.complex64)).to(device)


def _analyze(x: torch.Tensor, taps, hist: torch.Tensor, frame: int, m: int,
             d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The bank at hop D = ``d``: (channels [M, T//D], the new history).

    Frame f of the step reads the input ``xe[f·D : f·D + P·M]`` of ``xe`` =
    ``hist`` then ``x``, as P rows of M: one strided view of ``xe`` a branch
    tap, each one multiply-add over every frame. ``frame`` is the first
    frame's index; its phase is applied in the pass that writes the
    channel-major output."""
    p = (hist.shape[-1] + d) // m
    period = shift_period(m, d)
    f = x.shape[-1] // d
    xe = torch.cat([hist.to(x.dtype), x])                   # [P·M − D + T]
    xr = torch.view_as_real(xe)
    hp = _branch_taps(taps, p, m, x.device)[..., None]      # [P, M, 1]
    acc = None
    for j in range(p):
        seg = xr.as_strided((f, m, 2), (2 * d, 2, 1),
                            xr.storage_offset() + 2 * (p - 1 - j) * m)
        acc = seg * hp[j] if acc is None else acc.addcmul_(seg, hp[j])
    # channel m (centered at +m·fs/M) picks the e^{-j2πpm/M} combination → FFT.
    # branch gain ≈ 1/M (prototype sums to 1) × FFT sum M → unity channel gain.
    y = torch.fft.fft(torch.view_as_complex(acc), dim=-1)     # [F, M]
    tab = _shift_phases(m, d, x.device)[(frame + 1) % period]   # [L, M]
    out = torch.empty((m, f), dtype=torch.complex64, device=x.device)
    ot = out.t()
    body = f - f % period
    if body:
        torch.mul(y[:body].view(-1, period, m), tab,
                  out=ot[:body].view(-1, period, m))
    if body < f:
        torch.mul(y[body:], tab[: f - body], out=ot[body:])
    return out, xe[xe.shape[0] - (p * m - d):].clone()


def pfb_analyze_oversampled(x: torch.Tensor, taps, state, n_channels: int,
                            hop: int):
    """Analysis step at hop D = ``hop`` in [1, M].

    x: [T] complex with T % D == 0; taps: [M·P] prototype (host or tensor);
    state: :func:`pfb_os_init_state`'s. Returns (channels [M, T//D],
    new_state)."""
    hist, frame = pfb_history(state)
    y, hist = _analyze(x, taps, hist, frame, n_channels, hop)
    return y, pfb_state(hist, frame + y.shape[-1], n_channels, hop)


def pfb_synthesize(channels: torch.Tensor, taps, state: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Synthesis bank (inverse): channels [M, N] → wideband [N·M].

    FFT across channels, branch-filter each phase, interleave. State: [P-1, M].
    """
    m, n = channels.shape
    p = state.shape[0] + 1
    # inverse of the analysis FFT: IFFT·M recovers the branch signals
    rows = torch.fft.ifft(channels.t(), dim=-1) * m          # [N, M]
    xc = torch.cat([state.to(rows.dtype), rows], dim=0)
    v = branch_fir_macs(xc, _branch_taps(taps, p, m, channels.device, m), n)
    new_state = xc[n:].clone()
    return v.reshape(-1).to(torch.complex64), new_state


def channel_center_freqs(n_channels: int, sample_rate: float) -> np.ndarray:
    """Center frequency of each channel (FFT bin convention, wraps at fs/2)."""
    return np.fft.fftfreq(n_channels, d=1.0 / sample_rate)
