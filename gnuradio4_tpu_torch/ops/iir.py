"""IIR filtering (≈ reference blocks/filter time_domain_filter.hpp:64 iir_filter).

Strategies, as in the JAX package:

1. **Channel parallelism**: a loop over time carrying per-channel state vectors
   (:func:`iir_apply`, :func:`sos_apply`). In PyTorch this is a Python loop of
   small tensor ops per sample: correct everywhere, usable only at small T.
   The biquad cascade's fast form on the card is the ``iir_sos`` CUDA kernel
   (ops/cuda_kernels.py), of which :func:`sos_apply` is the plain version.
2. **Parallel linear recurrence** (first-order sections): y[n] = c·y[n-1] + v[n]
   is an associative operation on pairs (c, v), evaluated in O(log T) depth
   (:func:`one_pole_apply`), or for a host-constant pole on long streams in
   blocks: an [L, L] Toeplitz matmul, a scan over the T/L block carries and one
   correction pass. Biquads with separable poles decompose into one-pole
   sections (:func:`biquad_parallel_apply`).

State layout (transposed direct-form II): ``s[..., i]``, i ∈ [0, order).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .cuda_kernels import check_f32_matmul


def _normalize_ba(b: np.ndarray, a: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    b = b / a[0]
    a = a / a[0]
    order = max(len(b), len(a)) - 1
    b = np.pad(b, (0, order + 1 - len(b)))
    a = np.pad(a, (0, order + 1 - len(a)))
    return b, a, order


def iir_init_state(channels: int, nb: int, na: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    order = max(nb, na) - 1
    shape = (order,) if channels == 0 else (channels, order)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _f32(v: float) -> float:
    """A host coefficient rounded to float32, as the JAX package casts it."""
    return float(np.float32(v))


def iir_apply(x: torch.Tensor, b: np.ndarray, a: np.ndarray, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Transposed DF-II, a loop over time. x: [T] or [C, T]; state: [..., order]."""
    b, a, order = _normalize_ba(b, a)
    if order == 0:
        return x * _f32(b[0]), state
    bj = [_f32(v) for v in b]
    aj = [_f32(v) for v in a]
    s = [state[..., i].to(x.dtype) for i in range(order)]
    ys = []
    for n in range(x.shape[-1]):
        xn = x[..., n]
        yn = bj[0] * xn + s[0]
        # s_i ← b_{i+1}·x − a_{i+1}·y + s_{i+1}
        s = [bj[i + 1] * xn - aj[i + 1] * yn + (s[i + 1] if i + 1 < order else 0.0)
             for i in range(order)]
        ys.append(yn)
    y = torch.stack(ys, dim=-1) if ys else x.clone()
    return y, torch.stack(s, dim=-1)


def one_pole_apply(x: torch.Tensor, pole: complex | float,
                   y_prev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Parallel first-order recurrence y[n] = pole·y[n-1] + x[n].

    The pole is a host constant (every caller's is: the JAX package's traced
    poles come from dynamic settings no ported block has). With |pole| ≤ 1 on
    a stream of T ≥ 4096 samples, T % 128 == 0, it takes the blocked two-level
    path (:func:`_one_pole_blocked`); everything else takes the O(log T)-depth
    scan. ``GR4TPU_NO_BLOCKED_ONEPOLE=1`` forces the scan, the same switch the
    JAX package reads.

    x: [..., T]; y_prev: [...] (y[-1]); returns (y, y[T-1]).
    """
    t = x.shape[-1]
    if abs(pole) <= 1.0 and t >= 4096 and t % _BLK == 0 \
            and os.environ.get("GR4TPU_NO_BLOCKED_ONEPOLE") != "1":
        return _one_pole_blocked(x, complex(pole), y_prev)
    pole = _round_like(pole, x)
    v = x.clone()
    v[..., 0] += pole * y_prev.to(x.dtype)
    ys = _one_pole_scan(pole, v)
    return ys, ys[..., -1]


_BLK = 128   # in-block Toeplitz size


def _one_pole_blocked(x: torch.Tensor, pole: complex, y_prev: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level linear recurrence (host-constant pole, T % 128 == 0).

    In-block zero-state responses come from one lower-triangular Toeplitz
    matmul W[j,i] = p^{i−j} in full float32 (complex64 for a complex pole);
    the block carries chain through a scan over T/L values; the entering state
    folds back in one elementwise pass (y[b,i] = y_loc[b,i] + p^{i+1}·ent_b).
    Exact algebra — only f32/c64 rounding differs from the sequential loop."""
    check_f32_matmul("one_pole_apply (blocked)")
    L = _BLK
    t = x.shape[-1]
    nb = t // L
    cx = x.is_complex() or pole.imag != 0.0
    idx = np.arange(L)
    d = idx[None, :] - idx[:, None]          # i − j
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        w = np.where(d >= 0, np.asarray(pole, np.complex128) ** np.maximum(d, 0),
                     0.0)
        pv = np.asarray(pole, np.complex128) ** (idx + 1)       # p^{i+1}
        cl = complex(np.asarray(pole, np.complex128) ** L)       # p^L
    dt = torch.complex64 if cx else x.dtype
    np_dt = np.complex64 if cx else np.float32
    w_dev = torch.from_numpy((w if cx else w.real).astype(np_dt)).to(x.device)
    pv_dev = torch.from_numpy((pv if cx else pv.real).astype(np_dt)).to(x.device)
    cl_h = complex(np.complex64(cl)) if cx else _f32(cl.real)
    xb = x.to(dt).reshape(*x.shape[:-1], nb, L)
    y_loc = torch.matmul(xb, w_dev)
    e = y_loc[..., :, L - 1]                 # end-of-block local responses
    yp = y_prev.to(dt)
    v = e.clone()
    v[..., 0] += cl_h * yp
    s = _one_pole_scan(cl_h, v)
    ent = torch.cat([yp[..., None], s[..., :-1]], dim=-1)
    y = y_loc + ent[..., :, None] * pv_dev
    return y.reshape(x.shape), s[..., -1]


def _one_pole_scan(pole, v: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of y[n] = pole·y[n-1] + v[n] along the last axis by
    log-depth doubling (Hillis–Steele over (c, v) pairs with the associative
    (c_l, v_l)∘(c_r, v_r) = (c_l·c_r, c_r·v_l + v_r)). With a constant pole
    every c that level d reads is pole^d, so c is one scalar, squared per
    level in the stream's precision, as the pairwise products round it."""
    t = v.shape[-1]
    c = pole
    d = 1
    while d < t:
        nxt = torch.empty_like(v)
        nxt[..., :d] = v[..., :d]
        torch.add(v[..., d:], v[..., :-d], alpha=c, out=nxt[..., d:])
        v = nxt
        c = _round_like(c * c, v)
        d *= 2
    return v


def _round_like(c, v: torch.Tensor):
    """A host scalar rounded to ``v``'s precision (complex64 or float32)."""
    return complex(np.complex64(c)) if v.is_complex() else _f32(c)


def sos_init_state(channels: int, n_sections: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    shape = (n_sections, 2) if channels == 0 else (channels, n_sections, 2)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def sos_coefficients(sos: np.ndarray) -> np.ndarray:
    """[S, 5] float32 (b0, b1, b2, a1, a2) per section, a0-normalised in float64
    then rounded — the values the JAX package's kernel and scan both use."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    co = np.concatenate([sos[:, :3], sos[:, 4:]], axis=1) / sos[:, 3:4]
    return np.ascontiguousarray(co, dtype=np.float32)


def sos_apply(x: torch.Tensor, sos: np.ndarray, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cascaded-biquad IIR, a loop over time. sos: [S, 6]; state: [..., S, 2]
    transposed-DF2. The plain version of the ``iir_sos`` kernel."""
    co = [[float(v) for v in row] for row in sos_coefficients(sos)]
    s = [(state[..., k, 0].to(x.dtype), state[..., k, 1].to(x.dtype))
         for k in range(len(co))]
    ys = []
    for n in range(x.shape[-1]):
        v = x[..., n]
        new_s = []
        for (b0, b1, b2, a1, a2), (s0, s1) in zip(co, s):
            y = b0 * v + s0
            new_s.append((b1 * v - a1 * y + s1, b2 * v - a2 * y))
            v = y
        s = new_s
        ys.append(v)
    y = torch.stack(ys, dim=-1) if ys else x.clone()
    new_state = torch.stack([torch.stack(p, dim=-1) for p in s], dim=-2)
    return y, new_state


def one_pole_ba_apply(x: torch.Tensor, b: np.ndarray, a: np.ndarray,
                      u_prev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """First-order section y = b0·x + b1·x⁻¹ − a1·y⁻¹ in O(log T):
    H(w) = K + A/(1 − p·w) with p = −a1, K = b1/a1, A = b0 − b1/a1.
    State: the one-pole carry u[-1] (real)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    b = b / a[0]
    a = a / a[0]
    b0 = float(b[0])
    b1 = float(b[1]) if len(b) > 1 else 0.0
    a1 = float(a[1]) if len(a) > 1 else 0.0
    if a1 == 0.0:
        y = _f32(b0) * x + _f32(b1) * torch.cat(
            [u_prev[..., None].to(x.dtype), x[..., :-1]], dim=-1)
        return y.to(x.dtype), x[..., -1].clone()
    p = -a1
    K = b1 / a1
    A = b0 - b1 / a1
    u, last = one_pole_apply(x.to(torch.float32), p, u_prev.to(torch.float32))
    y = _f32(K) * x + _f32(A) * u
    return y.to(x.dtype), last


# Partial fractions carry an A ∝ 1/(p1−p2) amplitude: as the poles cluster the
# two rails cancel catastrophically in f32. Require |disc| ≥ EPS_REL·scale with
# scale = max(a1², 4|a2|) — RELATIVE pole separation ≳ 1e-3 — on both the real
# branch (p1−p2 = √disc) and the conjugate branch (p−p̄ = i√−disc); anything
# closer takes the sequential form.
_POLE_SEP_EPS_REL = 1e-6


def _disc_scale(a1: float, a2: float) -> float:
    return max(a1 * a1, 4.0 * abs(a2), 1e-300)


def sos_supports_parallel(sos: np.ndarray) -> bool:
    """True when every section's poles admit the O(log T) / blocked
    partial-fraction path: complex-conjugate pairs or two distinct real poles
    with relative separation ≥ ~1e-3. Near-repeated poles and first-order
    leftovers (a2 == 0) keep the sequential form."""
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    for row in sos:
        b0, b1, b2, a0, a1, a2 = row
        a1, a2 = a1 / a0, a2 / a0
        if a2 == 0.0:
            return False
        disc = a1 * a1 - 4.0 * a2
        if abs(disc) < _POLE_SEP_EPS_REL * _disc_scale(a1, a2):
            return False
    return True


def sos_parallel_init_state(channels: int, n_sections: int,
                            device: torch.device | str = "cpu") -> torch.Tensor:
    shape = (n_sections,) if channels == 0 else (channels, n_sections)
    return torch.zeros(shape, dtype=torch.complex64, device=device)


def sos_parallel_apply(x: torch.Tensor, sos: np.ndarray, state: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Biquad cascade in O(log T) depth: each section via partial fractions and
    one-pole recurrences; sections chain sequentially (S is small).
    State: complex one-pole carries u[-1], [..., S]."""
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    v = x
    carries = []
    for k, row in enumerate(sos):
        v, last = biquad_parallel_apply(v, row, state[..., k])
        carries.append(last)
    return v, torch.stack(carries, dim=-1)


def biquad_parallel_apply(x: torch.Tensor, sos_row: np.ndarray,
                          state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One biquad in O(log T) via one-pole decomposition.

    H(z) = (b0 + b1 z⁻¹ + b2 z⁻²)/(1 + a1 z⁻¹ + a2 z⁻²). Complex-conjugate
    poles p, p̄: y = K·x + 2·Re[A·u], u a one-pole recurrence with pole p.
    Two distinct real poles: y = K·x + A1·u1 + A2·u2, the two real carries
    packed as (re, im) of the section's complex state slot. ``state``: complex
    carry, shape [...]. Raises for first-order or near-repeated poles.
    """
    b0, b1, b2, a0, a1, a2 = (float(v) for v in np.asarray(sos_row, np.float64))
    b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
    if a2 == 0.0:
        raise ValueError(
            "biquad_parallel_apply requires a full second-order section "
            "(a2 != 0); first-order/FIR sections take the sequential path "
            "(sos_supports_parallel gates this)")
    disc = a1 * a1 - 4.0 * a2
    if abs(disc) < _POLE_SEP_EPS_REL * _disc_scale(a1, a2):
        raise ValueError(
            "biquad_parallel_apply requires well-separated poles "
            "(relative separation >= ~1e-3): near-repeated poles make the "
            "partial-fraction amplitudes cancel in f32 — use the sequential "
            "path (sos_supports_parallel gates this)")
    K = b2 / a2
    if disc > 0.0:
        sq = float(np.sqrt(disc))
        p1, p2 = (-a1 + sq) / 2.0, (-a1 - sq) / 2.0
        A1 = (b0 * p1 * p1 + b1 * p1 + b2) / (p1 * (p1 - p2))
        A2 = (b0 * p2 * p2 + b1 * p2 + b2) / (p2 * (p2 - p1))
        xf = x.to(torch.float32)
        u1, l1 = one_pole_apply(xf, p1, state.real.to(torch.float32))
        u2, l2 = one_pole_apply(xf, p2, state.imag.to(torch.float32))
        y = _f32(K) * x + _f32(A1) * u1 + _f32(A2) * u2
        return y.to(x.dtype), torch.complex(l1.to(torch.float32),
                                            l2.to(torch.float32))
    p = complex(-a1 / 2.0, np.sqrt(-disc) / 2.0)
    # exact partial fractions in w = z⁻¹: H = K + A/(1−p w) + Ā/(1−p̄ w) with
    # K = b2/a2 and A = (b0 p² + b1 p + b2)/(p (p − p̄)); K + 2·Re A = b0
    A = (b0 * p * p + b1 * p + b2) / (p * (p - np.conj(p)))
    u, u_last = one_pole_apply(x.to(torch.complex64), p, state)
    y = _f32(K) * x + 2.0 * (complex(np.complex64(A)) * u).real
    return y.to(x.dtype), u_last
