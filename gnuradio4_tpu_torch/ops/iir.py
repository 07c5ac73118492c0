"""IIR filtering (≈ reference blocks/filter time_domain_filter.hpp:64 iir_filter).

Strategies, as in the JAX package:

1. **Channel parallelism**: a loop over time carrying per-channel state vectors
   (:func:`iir_apply`, :func:`sos_apply`). In PyTorch this is a Python loop of
   small tensor ops per sample: correct everywhere, usable only at small T.
   The biquad cascade's fast form on the card is the ``iir_sos`` CUDA kernel
   (ops/cuda_kernels.py), of which :func:`sos_apply` is the plain version: a
   chunked state-space scan across time whose host matrices
   (:func:`sos_chunk_powers`) and algebra (:func:`sos_chunked_ref`) live here.
2. **Parallel linear recurrence** (first-order sections): y[n] = c·y[n-1] + v[n]
   is an associative operation on pairs (c, v), evaluated in O(log T) depth
   (:func:`one_pole_apply`), or for a host-constant pole on long streams in
   blocks: an [L, L] Toeplitz matmul, a scan over the T/L block carries and one
   correction pass. Biquads with separable poles decompose into one-pole
   sections (:func:`biquad_parallel_apply`).

State layout (transposed direct-form II): ``s[..., i]``, i ∈ [0, order).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .cuda_kernels import frozen, one_pole
from .precision import check_f32_matmul


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
    poles come from dynamic settings no ported block has). A CUDA stream
    takes the ``one_pole`` kernel (ops/cuda_kernels.py): one launch, any T,
    float32 or complex64 only (GrError otherwise, and for a complex pole
    over a real stream), the output in the stream's type.
    On the CPU, with |pole| ≤ 1 on a stream of T ≥ 4096 samples,
    T % 128 == 0, it takes the blocked two-level path
    (:func:`_one_pole_blocked`); everything else takes the O(log T)-depth
    scan. ``GR4TPU_NO_BLOCKED_ONEPOLE=1`` forces the scan there, the same
    switch the JAX package reads.

    x: [..., T]; y_prev: [...] (y[-1]); returns (y, y[T-1]).
    """
    if x.device.type == "cuda":
        return _one_pole_card(x, pole, y_prev)
    t = x.shape[-1]
    if abs(pole) <= 1.0 and t >= 4096 and t % _BLK == 0 \
            and os.environ.get("GR4TPU_NO_BLOCKED_ONEPOLE") != "1":
        return _one_pole_blocked(x, complex(pole), y_prev)
    pole = _round_like(pole, x)
    v = x.clone()
    v[..., 0] += pole * y_prev.to(x.dtype)
    ys = _one_pole_scan(pole, v)
    return ys, ys[..., -1]


def _one_pole_card(x: torch.Tensor, pole, u_prev: torch.Tensor,
                   gain_x: float = 0.0, gain_u: float = 1.0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``one_pole`` kernel in the stream's own type, which it refuses
    unless float32 or complex64; ``u_prev`` in that type, broadcast to the
    stream's channels."""
    return one_pole(x.contiguous(), pole,
                    u_prev.to(x.dtype).expand(x.shape[:-1]).contiguous(),
                    gain_x, gain_u)


_BLK = 128   # in-block Toeplitz size


def _one_pole_blocked(x: torch.Tensor, pole: complex, y_prev: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level linear recurrence (host-constant pole, T % 128 == 0).

    In-block zero-state responses come from one lower-triangular Toeplitz
    matmul W[j,i] = p^{i−j} in full float32 (complex64 for a complex pole);
    the block carries chain through a scan over T/L values; the entering state
    folds back in one elementwise pass (y[b,i] = y_loc[b,i] + p^{i+1}·ent_b).
    Exact algebra — only f32/c64 rounding differs from the sequential loop.
    The constants are built and uploaded once per pole and device
    (:func:`_one_pole_blocks`)."""
    check_f32_matmul("one_pole_apply (blocked)")
    L = _BLK
    t = x.shape[-1]
    nb = t // L
    cx = x.is_complex() or pole.imag != 0.0
    w_dev, pv_dev, cl_h = _one_pole_blocks(pole, cx, x.device)
    dt = torch.complex64 if cx else x.dtype
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


@functools.lru_cache(maxsize=64)
def _one_pole_blocks(pole: complex, cx: bool, device: torch.device
                     ) -> tuple[torch.Tensor, torch.Tensor, complex | float]:
    """The blocked recurrence's constants for one pole on ``device``, in
    complex64 (``cx``) or float32: W[j,i] = p^{i−j} ([L, L], lower-triangular
    Toeplitz), p^{i+1} ([L]) and p^L, all from float64 powers."""
    L = _BLK
    idx = np.arange(L)
    d = idx[None, :] - idx[:, None]          # i − j
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        w = np.where(d >= 0, np.asarray(pole, np.complex128) ** np.maximum(d, 0),
                     0.0)
        pv = np.asarray(pole, np.complex128) ** (idx + 1)       # p^{i+1}
        cl = complex(np.asarray(pole, np.complex128) ** L)       # p^L
    np_dt = np.complex64 if cx else np.float32
    w_dev = torch.from_numpy((w if cx else w.real).astype(np_dt)).to(device)
    pv_dev = torch.from_numpy((pv if cx else pv.real).astype(np_dt)).to(device)
    cl_h = complex(np.complex64(cl)) if cx else _f32(cl.real)
    return w_dev, pv_dev, cl_h


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
    return _cascade_loop(x, sos_coefficients(sos), state)


# The iir_sos kernel's chunked scan (csrc/iir_sos.cu; its wrapper checks that
# the library reports the same values): samples per chunk, sections per group,
# and powers Φ^(2^j), j < SOS_CARRY_LEVELS, of each group's chunk transition.
SOS_CHUNK = 128
SOS_GROUP = 16
SOS_CARRY_LEVELS = 40


def sos_step_matrix(co: np.ndarray) -> np.ndarray:
    """A, [2S, 2S] float64: one sample of the cascade with zero input, acting
    on the state vector ``state[..., S, 2].reshape(2S)`` (s0, s1 of section 0,
    then of section 1, ...). ``co``: [S, 5] (b0, b1, b2, a1, a2), as
    :func:`sos_coefficients` gives them. Column i is one step from unit
    state e_i."""
    co = np.asarray(co, np.float64)
    s = np.eye(2 * co.shape[0])
    new = np.empty_like(s)
    v = np.zeros(s.shape[1])
    for k, (b0, b1, b2, a1, a2) in enumerate(co):
        y = b0 * v + s[2 * k]
        new[2 * k] = b1 * v - a1 * y + s[2 * k + 1]
        new[2 * k + 1] = b2 * v - a2 * y
        v = y
    return new


def sos_chunk_transition(co: np.ndarray, chunk: int) -> np.ndarray:
    """Φ = A^chunk, [2S, 2S]: the state after ``chunk`` samples of zero input,
    in float64 from the f32-rounded coefficients ``co``, rounded to float32.
    A chunk entered in state s and left in z from the zero state leaves in
    Φ·s + z."""
    return np.linalg.matrix_power(sos_step_matrix(co), chunk).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _chunk_powers(co_key: bytes, n_sec: int, chunk: int) -> np.ndarray:
    phi = np.linalg.matrix_power(
        sos_step_matrix(np.frombuffer(co_key, np.float32).reshape(n_sec, 5)), chunk)
    out = np.empty((SOS_CARRY_LEVELS, *phi.shape), np.float32)
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        for j in range(SOS_CARRY_LEVELS):
            out[j] = phi
            phi = phi @ phi
    return frozen(out)


def sos_chunk_powers(co: np.ndarray, chunk: int = SOS_CHUNK) -> np.ndarray:
    """[SOS_CARRY_LEVELS, 2S, 2S] float32, read-only and cached per
    (coefficients, chunk): Φ^(2^j), squared in float64 from Φ = A^chunk and
    each rounded to float32. The carry of the chunked scan combines spans of
    2^j chunks with them."""
    co = np.ascontiguousarray(co, np.float32)
    return _chunk_powers(co.tobytes(), co.shape[0], chunk)


def sos_chunked_ref(x: torch.Tensor, sos: np.ndarray, state: torch.Tensor,
                    chunk: int = SOS_CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``iir_sos`` kernel's chunked state-space scan, in plain PyTorch, for
    the tests: the same result as :func:`sos_apply` in exact arithmetic.

    Per group of up to SOS_GROUP sections, the stream (each later group the
    previous group's output) is cut into chunks of ``chunk`` samples, the last
    one partial. Every chunk runs through the cascade from the zero state
    (its end state z_k); the entering states s_0 = state and
    s_{k+1} = Φ·s_k + z_k come from a log-depth scan with the powers of
    :func:`sos_chunk_powers`; every chunk runs again from s_k and gives y.
    The last chunk's end state is the new state. x: [T] or [C, T] float32;
    state: [..., S, 2]."""
    co = sos_coefficients(sos)
    squeeze = x.ndim == 1
    y = x[None] if squeeze else x
    st = state[None] if squeeze else state
    new_state = st.clone()
    for k0 in range(0, co.shape[0], SOS_GROUP):
        grp = co[k0:k0 + SOS_GROUP]
        y, new_state[:, k0:k0 + len(grp)] = _chunked_group(
            y, grp, st[:, k0:k0 + len(grp)], chunk)
    return (y[0], new_state[0]) if squeeze else (y, new_state)


def _chunked_group(x: torch.Tensor, co: np.ndarray, state: torch.Tensor,
                   chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    c, t = x.shape
    n = 2 * co.shape[0]
    if c == 0 or t == 0:
        return x.clone(), state.clone()
    k = -(-t // chunk)
    xp = torch.nn.functional.pad(x, (0, k * chunk - t)).reshape(c * k, chunk)
    zero = torch.zeros(c * k, co.shape[0], 2, dtype=x.dtype, device=x.device)
    _, z = _cascade_loop(xp, co, zero)
    # inclusive scan of w_k = Φ·w_{k−1} + z_k with w_{−1} = state: w_k is the
    # state after chunk k, the entering state of chunk k + 1
    powers = torch.from_numpy(sos_chunk_powers(co, chunk).copy()).to(x.device)
    w = z.reshape(c, k, n)
    w[:, 0] += state.reshape(c, n) @ powers[0].T
    d, j = 1, 0
    while d < k:
        nxt = w.clone()
        nxt[:, d:] += w[:, :-d] @ powers[j].T
        w, d, j = nxt, 2 * d, j + 1
    enter = torch.cat([state.reshape(c, 1, n), w[:, :-1]], dim=1)
    y, _ = _cascade_loop(xp, co, enter.reshape(c * k, n // 2, 2))
    _, s_out = _cascade_loop(x[:, (k - 1) * chunk:], co, enter[:, -1].reshape(c, n // 2, 2))
    return y.reshape(c, k * chunk)[:, :t], s_out


def _cascade_loop(x: torch.Tensor, co: np.ndarray, state: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cascade's loop over time with [S, 5] float32 coefficients ``co``."""
    co = [[float(v) for v in row] for row in co]
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
    if x.device.type == "cuda":       # the epilogue in the kernel's one pass
        y, last = _one_pole_card(x.to(torch.float32), p, u_prev, _f32(K), _f32(A))
        return y.to(x.dtype), last
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
