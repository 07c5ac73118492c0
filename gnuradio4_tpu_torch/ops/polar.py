"""Polar codes (Arıkan): construction, butterfly encoding, successive-
cancellation decoding.

Encoding is x = u·F^{⊗n} over GF(2) — log₂N butterfly stages of XORs,
which vectorize perfectly (the device encoder in blocks/polar.py runs them
as torch reshapes). The frozen set comes from the Bhattacharyya parameter
recursion on a BEC (the classic design heuristic); SC decoding is the
standard recursive min-sum on LLRs (host — it is inherently sequential,
and runs at frame rate, not sample rate).
"""

from __future__ import annotations

import numpy as np

from ..core.errors import GrError


def frozen_mask(n_code: int, k: int, *, design_erasure: float = 0.5
                ) -> np.ndarray:
    """Boolean mask [N]: True = frozen position. Bhattacharyya/BEC
    recursion: z⁻ = 2z − z², z⁺ = z²; keep the K most reliable (smallest
    z) as information positions."""
    if n_code & (n_code - 1) or n_code < 2:
        raise GrError(f"polar: N must be a power of two (got {n_code})")
    if not (0 < k < n_code):
        raise GrError(f"polar: need 0 < K < N (got K={k}, N={n_code})")
    z = np.array([design_erasure], np.float64)
    while len(z) < n_code:
        z = np.concatenate([2 * z - z * z, z * z])
    # the concatenation builds z with the FIRST-applied polarization bit as
    # the index LSB; the natural-order butterfly encoder (adjacent pairs in
    # the first stage) polarizes with that bit as the index MSB — so the
    # reliabilities map to u positions through the bit-reversal permutation
    n_bits = int(np.log2(n_code))
    rev = np.zeros(n_code, np.int64)
    for i in range(n_code):
        r, v = 0, i
        for _ in range(n_bits):
            r = (r << 1) | (v & 1)
            v >>= 1
        rev[i] = r
    z = z[rev]
    order = np.argsort(z, kind="stable")          # most reliable first
    mask = np.ones(n_code, bool)
    mask[order[:k]] = False
    return mask


def encode(u: np.ndarray) -> np.ndarray:
    """x = u·F^{⊗n}: butterfly XOR stages; ``u`` [.., N] bits."""
    x = np.asarray(u, np.uint8).copy()
    n_code = x.shape[-1]
    step = 1
    while step < n_code:
        shape = x.shape[:-1] + (n_code // (2 * step), 2, step)
        v = x.reshape(shape)
        v[..., 0, :] ^= v[..., 1, :]
        step *= 2
    return x.reshape(u.shape)


def polar_encode(bits: np.ndarray, frozen: np.ndarray) -> np.ndarray:
    """K info bits → N codeword bits (frozen positions carry 0)."""
    frozen = np.asarray(frozen, bool)
    n_code = len(frozen)
    k = int((~frozen).sum())
    bits = np.asarray(bits, np.uint8)
    frames = bits.reshape(-1, k)
    u = np.zeros((len(frames), n_code), np.uint8)
    u[:, ~frozen] = frames
    return encode(u).reshape(-1)


def _sc_decode_one(llr: np.ndarray, frozen: np.ndarray) -> np.ndarray:
    """Successive cancellation on one frame; returns û [N]."""
    n_code = len(llr)

    def rec(l, fr):
        if len(l) == 1:
            if fr[0]:
                return np.array([0], np.uint8)
            return np.array([1 if l[0] < 0 else 0], np.uint8)
        half = len(l) // 2
        a, b = l[:half], l[half:]
        # f: sign-min combine for the upper branch
        lf = np.sign(a) * np.sign(b) * np.minimum(np.abs(a), np.abs(b))
        u1 = rec(lf, fr[:half])
        # partial re-encode of the upper decisions feeds g
        s = encode(u1)
        lg = b + (1.0 - 2.0 * s) * a
        u2 = rec(lg, fr[half:])
        return np.concatenate([u1, u2])

    return rec(np.asarray(llr, np.float64), np.asarray(frozen, bool))


def polar_decode(llr: np.ndarray, frozen: np.ndarray) -> np.ndarray:
    """LLR stream (positive = bit 0), framed [*, N] → K info bits/frame."""
    frozen = np.asarray(frozen, bool)
    n_code = len(frozen)
    frames = np.asarray(llr, np.float64).reshape(-1, n_code)
    out = []
    for f in frames:
        u = _sc_decode_one(f, frozen)
        out.append(u[~frozen])
    return np.concatenate(out).astype(np.uint8) if out else \
        np.zeros(0, np.uint8)
