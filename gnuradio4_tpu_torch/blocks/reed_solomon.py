"""Reed-Solomon block codes over GF(2^8).

The satellite/storage workhorse (CCSDS 101.0 telemetry uses RS(255,223) as
the outer code around the K=7 convolutional inner code that
:class:`~gnuradio4_tpu.blocks.fec.ViterbiDecoder` already handles).
Complete codec: encode by generator-polynomial division; decode via
syndromes → Berlekamp-Massey → Chien search → Forney algorithm, correcting
up to ⌊(n−k)/2⌋ symbol errors, or more with declared erasures
(2·errors + erasures ≤ n − k).

Field and code parameters are configurable: primitive polynomial (default
0x11D; CCSDS uses 0x187), first consecutive root ``fcr`` and generator-root
spacing ``prim`` (CCSDS: fcr=112, prim=11 in the dual-basis spec — the
conventional representation here matches libfec's usage).

Host-side by design: RS operates on bytes at frame rate (kHz), thousands of
times below the sample-rate path that runs on the device. The stream blocks
run the codec inside the step through :func:`host_call` (the JAX package's
``jax.pure_callback``).
"""

from __future__ import annotations

import numpy as np

from ..core.block import Block, Port
from ..core.errors import GrError
from ..core.host_call import host_call
from ..core.registry import register_block
from ..core.settings import Setting


class GF256:
    """GF(2^8) arithmetic tables for a given primitive polynomial."""

    def __init__(self, prim_poly: int = 0x11D):
        self.prim_poly = prim_poly
        exp = np.zeros(512, np.int32)
        log = np.zeros(256, np.int32)
        x = 1
        for i in range(255):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= prim_poly
        if x != 1:
            raise GrError(f"0x{prim_poly:X} is not primitive over GF(256)")
        exp[255:510] = exp[:255]
        self.exp, self.log = exp, log

    def mul(self, a, b):
        a = np.asarray(a, np.int32)
        b = np.asarray(b, np.int32)
        out = self.exp[(self.log[a] + self.log[b]) % 255]
        return np.where((a == 0) | (b == 0), 0, out)

    def inv(self, a):
        a = np.asarray(a, np.int32)
        if np.any(a == 0):
            raise GrError("GF(256): inverse of 0")
        return self.exp[(255 - self.log[a]) % 255]

    def poly_mul(self, p, q):
        out = np.zeros(len(p) + len(q) - 1, np.int32)
        for i, c in enumerate(p):
            if c:
                out[i: i + len(q)] ^= np.asarray(self.mul(c, q), np.int32)
        return out

    def poly_eval(self, poly, xs):
        """Evaluate poly (highest-degree first) at each x (Horner)."""
        xs = np.asarray(xs, np.int32)
        acc = np.zeros_like(xs)
        for c in poly:
            acc = np.asarray(self.mul(acc, xs), np.int32) ^ int(c)
        return acc


class ReedSolomon:
    """RS(n, k) codec; n ≤ 255, t = (n−k)//2 correctable symbol errors."""

    def __init__(self, n: int = 255, k: int = 223, *,
                 prim_poly: int = 0x11D, fcr: int = 1, prim: int = 1):
        if not (0 < k < n <= 255):
            raise GrError(f"RS({n},{k}): need 0 < k < n <= 255")
        self.n, self.k = n, k
        self.nroots = n - k
        self.fcr, self.prim = fcr, prim
        self.gf = GF256(prim_poly)
        # generator polynomial: prod (x - alpha^(prim*(fcr+i)))
        g = np.array([1], np.int32)
        for i in range(self.nroots):
            root = self.gf.exp[(prim * (fcr + i)) % 255]
            g = self.gf.poly_mul(g, np.array([1, root], np.int32))
        self.genpoly = g

    # -- encode ---------------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """k data symbols → n-symbol systematic codeword (data + parity)."""
        data = np.asarray(data, np.int32) & 0xFF
        if len(data) != self.k:
            raise GrError(f"RS({self.n},{self.k}): got {len(data)} symbols")
        rem = np.zeros(self.nroots, np.int32)
        for d in data:
            feedback = int(d) ^ int(rem[0])
            rem[:-1] = rem[1:]
            rem[-1] = 0
            if feedback:
                rem ^= np.asarray(
                    self.gf.mul(feedback, self.genpoly[1:]), np.int32)
        return np.concatenate([data, rem]).astype(np.uint8)

    # -- decode ---------------------------------------------------------------
    def decode(self, codeword: np.ndarray,
               erasures: list[int] = ()) -> tuple[np.ndarray, int]:
        """Returns (corrected k data symbols, n_corrected). Raises GrError
        when the error weight exceeds the code's capability."""
        gf = self.gf
        r = np.asarray(codeword, np.int32) & 0xFF
        if len(r) != self.n:
            raise GrError(f"RS({self.n},{self.k}): got {len(r)} symbols")
        # syndromes S_i = r(alpha^(prim*(fcr+i)))
        xs = gf.exp[(self.prim * (self.fcr + np.arange(self.nroots))) % 255]
        synd = gf.poly_eval(r, xs)
        if not synd.any() and not len(erasures):
            return r[: self.k].astype(np.uint8), 0
        # erasure locator from known positions (ascending coefficients)
        lam = np.array([1], np.int32)
        for pos in erasures:
            x = int(gf.exp[(self.prim * (self.n - 1 - pos)) % 255])
            # lam *= (1 - x·z): ascending-order poly [1, x]
            lam = self._poly_mul_asc(lam, np.array([1, x], np.int32))
        # Berlekamp-Massey on erasure-modified syndromes
        synd_asc = synd.astype(np.int32)          # S_0..S_{2t-1}
        lam = self._berlekamp_massey(synd_asc, lam, len(erasures))
        # Chien search: roots of lam (ascending coeffs) → error locations
        degree = len(lam) - 1
        err_pos = []
        for i in range(self.n):
            x = int(gf.exp[(self.prim * i) % 255])
            xinv = int(gf.inv(x))
            if self._eval_asc(lam, xinv) == 0:
                err_pos.append(self.n - 1 - i)
        if len(err_pos) != degree:
            raise GrError(f"RS({self.n},{self.k}): uncorrectable "
                          f"(locator degree {degree}, {len(err_pos)} roots)")
        if not err_pos:
            return r[: self.k].astype(np.uint8), 0
        # Forney: error magnitudes from omega = S·lam mod z^nroots
        omega = self._poly_mul_asc(synd_asc, lam)[: self.nroots]
        lam_deriv = lam[1::2].copy()              # formal derivative (GF(2))
        for pos in err_pos:
            i = self.n - 1 - pos
            xinv = int(gf.inv(int(gf.exp[(self.prim * i) % 255])))
            num = self._eval_asc(omega, xinv)
            den = self._eval_asc_even(lam_deriv, xinv)
            if den == 0:
                raise GrError(f"RS({self.n},{self.k}): Forney denominator 0")
            mag = int(gf.mul(num, gf.inv(den)))
            # fcr adjustment: magnitude scales by x^(1-fcr)
            x = int(gf.exp[(self.prim * i) % 255])
            adj = int(gf.exp[(gf.log[x] * (1 - self.fcr)) % 255])
            r[pos] ^= int(gf.mul(mag, adj))
        # verify
        if gf.poly_eval(r, xs).any():
            raise GrError(f"RS({self.n},{self.k}): uncorrectable "
                          f"(post-correction syndromes non-zero)")
        return r[: self.k].astype(np.uint8), len(err_pos)

    # ascending-coefficient helpers (BM/Chien/Forney convention)
    def _poly_mul_asc(self, p, q):
        out = np.zeros(len(p) + len(q) - 1, np.int32)
        for i, c in enumerate(p):
            if c:
                out[i: i + len(q)] ^= np.asarray(
                    self.gf.mul(int(c), q), np.int32)
        return out

    def _eval_asc(self, poly, x):
        acc = 0
        for c in poly[::-1]:
            acc = int(self.gf.mul(acc, x)) ^ int(c)
        return acc

    def _eval_asc_even(self, poly_odd_removed, x):
        # lam'(z) in GF(2) keeps odd-power coeffs at even powers: evaluate
        # sum c_k x^(2k)
        acc = 0
        x2 = int(self.gf.mul(x, x))
        for c in poly_odd_removed[::-1]:
            acc = int(self.gf.mul(acc, x2)) ^ int(c)
        return acc

    def _berlekamp_massey(self, synd, lam0, n_erasures):
        gf = self.gf
        # fold erasures: modified syndromes = S(z)·lam0(z)
        if n_erasures:
            synd = self._poly_mul_asc(synd, lam0)[: self.nroots]
        lam = np.array([1], np.int32)
        b = np.array([1], np.int32)
        L, m, bb = 0, 1, 1
        for i in range(n_erasures, self.nroots):
            # discrepancy
            d = int(synd[i])
            for j in range(1, L + 1):
                if j < len(lam):
                    d ^= int(gf.mul(int(lam[j]), int(synd[i - j])))
            if d == 0:
                m += 1
            elif 2 * L <= i - n_erasures:
                t = lam.copy()
                coef = int(gf.mul(d, gf.inv(bb)))
                shifted = np.zeros(m + len(b), np.int32)
                shifted[m:] = np.asarray(gf.mul(coef, b), np.int32)
                size = max(len(lam), len(shifted))
                new = np.zeros(size, np.int32)
                new[: len(lam)] ^= lam
                new[: len(shifted)] ^= shifted
                lam = new
                L = i - n_erasures + 1 - L
                b, bb, m = t, d, 1
            else:
                coef = int(gf.mul(d, gf.inv(bb)))
                shifted = np.zeros(m + len(b), np.int32)
                shifted[m:] = np.asarray(gf.mul(coef, b), np.int32)
                size = max(len(lam), len(shifted))
                new = np.zeros(size, np.int32)
                new[: len(lam)] ^= lam
                new[: len(shifted)] ^= shifted
                lam = new
                m += 1
        if n_erasures:
            lam = self._poly_mul_asc(lam0, lam)
        # trim trailing zeros
        nz = np.flatnonzero(lam)
        return lam[: nz[-1] + 1] if len(nz) else np.array([1], np.int32)


@register_block("RsEncoder")
class RsEncoder(Block):
    """Stream RS encoder: bytes in (uint8 as float32 stream), rate k→n.
    Frames are consecutive k-byte groups (ratio n/k, alignment k). The codec
    runs on the host once per step (:func:`host_call`: one stream
    synchronisation a step)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    n = Setting(default=255, kind="static")
    k = Setting(default=223, kind="static")
    prim_poly = Setting(default=0x11D, kind="static")
    fcr = Setting(default=1, kind="static")
    prim = Setting(default=1, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._rs = ReedSolomon(int(self.settings.get("n")),
                               int(self.settings.get("k")),
                               prim_poly=int(self.settings.get("prim_poly")),
                               fcr=int(self.settings.get("fcr")),
                               prim=int(self.settings.get("prim")))

    @property
    def ratio(self):
        from fractions import Fraction
        return Fraction(int(self.settings.get("n")),
                        int(self.settings.get("k")))

    @property
    def alignment(self):
        return int(self.settings.get("k"))

    def _encode_np(self, x: np.ndarray) -> np.ndarray:
        flat = np.asarray(x).reshape(-1)
        k, n = self._rs.k, self._rs.n
        frames = flat[: len(flat) // k * k].reshape(-1, k).astype(np.int64)
        out = (np.concatenate([self._rs.encode(f) for f in frames])
               if len(frames) else np.zeros(0, np.uint8))
        return out.astype(np.float32).reshape(x.shape[:-1]
                                              + (x.shape[-1] // k * n,))

    def apply(self, state, ins, ctx):
        return state, {"out": host_call(self._encode_np, ins["in"])}


@register_block("RsDecoder")
class RsDecoder(Block):
    """Stream RS decoder: n-byte codewords in, k corrected bytes out
    (ratio k/n, alignment n). Uncorrectable frames pass through their
    data portion unchanged and count in ``n_failed``. The codec runs on the
    host once per step (:func:`host_call`: one stream synchronisation a
    step), so the counters count each delivered frame once."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    n = Setting(default=255, kind="static")
    k = Setting(default=223, kind="static")
    prim_poly = Setting(default=0x11D, kind="static")
    fcr = Setting(default=1, kind="static")
    prim = Setting(default=1, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._rs = ReedSolomon(int(self.settings.get("n")),
                               int(self.settings.get("k")),
                               prim_poly=int(self.settings.get("prim_poly")),
                               fcr=int(self.settings.get("fcr")),
                               prim=int(self.settings.get("prim")))
        self.n_corrected = 0
        self.n_failed = 0

    @property
    def ratio(self):
        from fractions import Fraction
        return Fraction(int(self.settings.get("k")),
                        int(self.settings.get("n")))

    @property
    def alignment(self):
        return int(self.settings.get("n"))

    def _decode_np(self, x: np.ndarray) -> np.ndarray:
        flat = np.asarray(x).reshape(-1)
        n, k = self._rs.n, self._rs.k
        frames = flat[: len(flat) // n * n].reshape(-1, n).astype(np.int64)
        outs = []
        for f in frames:
            try:
                data, nc = self._rs.decode(f)
                self.n_corrected += nc
            except GrError:
                data = (f[: k] & 0xFF).astype(np.uint8)
                self.n_failed += 1
            outs.append(data)
        out = np.concatenate(outs) if outs else np.zeros(0, np.uint8)
        return out.astype(np.float32).reshape(x.shape[:-1]
                                              + (x.shape[-1] // n * k,))

    def apply(self, state, ins, ctx):
        return state, {"out": host_call(self._decode_np, ins["in"])}
