"""Digital modem operations: constellations (PSK/QAM), OFDM framing, RRC
pulses and Mueller & Müller timing recovery (the JAX package's
``ops/digital.py``).

Symbol mapping is a table gather, demapping a nearest-point argmin; OFDM is a
batched ``torch.fft`` (cuFFT on the card, as XLA ran the JAX package's FFTs
outside any Pallas kernel). The M&M loop is sequential by nature: one
iteration of device ops per symbol, with no read back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_kernels import device_constant


def make_constellation(kind: str) -> np.ndarray:
    """Unit-average-power constellation points, Gray-coded where standard."""
    k = kind.upper()
    if k == "BPSK":
        return np.array([1.0 + 0j, -1.0 + 0j], np.complex64)
    if k == "QPSK":
        pts = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j], np.complex64)
        return (pts / np.sqrt(2.0)).astype(np.complex64)
    if k == "8PSK":
        gray = [0, 1, 3, 2, 6, 7, 5, 4]
        pts = np.zeros(8, np.complex64)
        for i, g in enumerate(gray):
            pts[g] = np.exp(1j * (2 * np.pi * i / 8 + np.pi / 8))
        return pts
    if k in ("QAM16", "16QAM"):
        gray2 = {0: -3, 1: -1, 3: 1, 2: 3}
        pts = np.zeros(16, np.complex64)
        for b in range(16):
            pts[b] = gray2[(b >> 2) & 3] + 1j * gray2[b & 3]
        return (pts / np.sqrt(10.0)).astype(np.complex64)
    if k in ("QAM64", "64QAM"):
        gray3 = {0: -7, 1: -5, 3: -3, 2: -1, 6: 1, 7: 3, 5: 5, 4: 7}
        pts = np.zeros(64, np.complex64)
        for b in range(64):
            pts[b] = gray3[(b >> 3) & 7] + 1j * gray3[b & 7]
        return (pts / np.sqrt(42.0)).astype(np.complex64)
    raise ValueError(f"unknown constellation {kind!r}")


def symbols_to_iq(symbols: torch.Tensor, constellation: np.ndarray
                  ) -> torch.Tensor:
    """Map integer symbols [..., N] → complex64 points (table gather; an index
    outside the table takes its nearest end, as ``jnp.take(mode='clip')``)."""
    table = device_constant(np.asarray(constellation, np.complex64),
                            symbols.device)
    idx = symbols.to(torch.int32).to(torch.int64).clamp(0, table.shape[0] - 1)
    return table[idx]


def iq_to_symbols(iq: torch.Tensor, constellation: np.ndarray) -> torch.Tensor:
    """Hard-decision demapping: nearest constellation point (the lowest index
    on a tie)."""
    table = device_constant(np.asarray(constellation, np.complex64), iq.device)
    d = (iq[..., None] - table).abs() ** 2
    return torch.argmin(d, dim=-1).to(torch.int32)


def ofdm_modulate(symbols: torch.Tensor, *, fft_size: int, cp_len: int,
                  occupied: np.ndarray) -> torch.Tensor:
    """OFDM: map symbols onto ``occupied`` subcarriers, IFFT, prepend CP.

    symbols: [..., n_sym, len(occupied)] complex → [..., n_sym·(fft_size+cp)].
    """
    occ = device_constant(np.asarray(occupied, np.int64), symbols.device)
    lead = symbols.shape[:-2]
    n_sym = symbols.shape[-2]
    grid = torch.zeros((*lead, n_sym, fft_size), dtype=torch.complex64,
                       device=symbols.device)
    grid[..., occ] = symbols.to(torch.complex64)
    time = torch.fft.ifft(grid, dim=-1) * float(np.sqrt(np.float32(fft_size)))
    with_cp = torch.cat([time[..., -cp_len:], time], dim=-1)
    return with_cp.reshape(*lead, n_sym * (fft_size + cp_len))


def ofdm_demodulate(x: torch.Tensor, *, fft_size: int, cp_len: int,
                    occupied: np.ndarray) -> torch.Tensor:
    """Inverse of :func:`ofdm_modulate` (assumes symbol alignment)."""
    occ = device_constant(np.asarray(occupied, np.int64), x.device)
    sym_len = fft_size + cp_len
    lead = x.shape[:-1]
    n_sym = x.shape[-1] // sym_len
    frames = x[..., : n_sym * sym_len].reshape(*lead, n_sym, sym_len)
    grid = torch.fft.fft(frames[..., cp_len:], dim=-1) \
        / float(np.sqrt(np.float32(fft_size)))
    return grid[..., occ].to(torch.complex64)


def rrc_taps(sps: int, ntaps: int, *, beta: float = 0.35) -> np.ndarray:
    """Root-raised-cosine pulse-shaping taps (unit energy), ``sps`` samples per
    symbol, roll-off ``beta``."""
    if ntaps % 2 == 0:
        ntaps += 1
    t = (np.arange(ntaps) - (ntaps - 1) / 2.0) / float(sps)
    h = np.zeros(ntaps, np.float64)
    for k, tt in enumerate(t):
        if abs(tt) < 1e-12:
            h[k] = 1.0 - beta + 4.0 * beta / np.pi
        elif beta > 0 and abs(abs(4.0 * beta * tt) - 1.0) < 1e-9:
            h[k] = (beta / np.sqrt(2.0)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            num = (np.sin(np.pi * tt * (1 - beta))
                   + 4 * beta * tt * np.cos(np.pi * tt * (1 + beta)))
            den = np.pi * tt * (1 - (4 * beta * tt) ** 2)
            h[k] = num / den
    return (h / np.sqrt(np.sum(h * h))).astype(np.float64)


def timing_phase_energy(x: torch.Tensor, sps: int) -> torch.Tensor:
    """Mean symbol-rate energy per sampling phase: [..., sps]."""
    t = x.shape[-1] - (x.shape[-1] % sps)
    frames = x[..., :t].reshape(*x.shape[:-1], -1, sps)
    return torch.mean(frames.abs() ** 2, dim=-2)


def _decide(v: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.sign(v.real), torch.sign(v.imag))


def mm_timing_recovery(x: torch.Tensor, *, sps: int, mu0: torch.Tensor,
                       last_sym: torch.Tensor, gain: float = 0.01
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mueller & Müller decision-directed timing recovery (feedback loop).

    x: [T] complex at ``sps`` samples/symbol (T % sps == 0). Per output symbol
    k the loop samples x at position k·sps + μ (linear interpolation), updates
    μ with the M&M error e = Re{ŷ_{k-1}·y_k − ŷ_k·y_{k-1}} (decisions ŷ via
    sign quantization), and clamps μ to [−sps/2 + 1, sps/2 − 1 + sps].

    One iteration of device ops per symbol (the JAX package's ``lax.scan``),
    none of which reads back to the host. Returns (symbols [T//sps], μ_final,
    last_symbol).
    """
    t = x.shape[-1]
    n_sym = t // sps
    lo, hi = -sps / 2.0 + 1.0, sps / 2.0 - 1.0 + sps
    pair = torch.arange(2, device=x.device)
    mu = mu0.to(torch.float32)
    y_prev = last_sym.to(torch.complex64)
    d_prev = _decide(y_prev)
    ys = []
    for k in range(n_sym):
        pos = mu + float(k * sps)
        i = torch.floor(pos).to(torch.int32).clamp(0, t - 2)
        frac = pos - i.to(torch.float32)
        x0 = x[i.to(torch.int64) + pair]
        y = x0[0] * (1.0 - frac) + x0[1] * frac
        d = _decide(y)
        e = (d_prev * y - d * y_prev).real
        mu = torch.clamp(mu + e * gain, lo, hi)
        ys.append(y)
        y_prev, d_prev = y, d
    syms = torch.stack(ys) if ys else x.new_zeros(0)
    return syms, mu, y_prev


def default_occupied(fft_size: int, n_occupied: int) -> np.ndarray:
    """Symmetric occupied-carrier map avoiding DC and band edges."""
    half = n_occupied // 2
    pos = np.arange(1, half + 1)
    neg = fft_size - np.arange(1, n_occupied - half + 1)
    return np.sort(np.concatenate([pos, neg]))

