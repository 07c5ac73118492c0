"""Filter design (host-side NumPy math; ≈ reference algorithm/filter/FilterTool.hpp).

Capabilities mirrored from the reference FilterTool:
- IIR pole-zero synthesis: Butterworth, Chebyshev I/II, Bessel analog prototypes
  (FilterTool.hpp:496-533, :824-828), analog band transforms, bilinear transform with
  prewarping, ``iir::designFilter`` (:850) → here :func:`design_iir`;
- windowed-sinc FIR design, low/high/band-pass/band-stop (``fir::designFilter``,
  FilterTool.hpp:1007) → :func:`design_fir`;
- frequency-response evaluation → :func:`freq_response`.

Design runs on the host in float64 (it is O(taps), not a hot path); the resulting
coefficients are baked into device kernels as f32/c64 constants. Formulas follow the
standard DSP literature (Oppenheim/Schafer; Parks–McClellan is future work).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np

from .windows import make_window


class Type(enum.Enum):
    LOWPASS = "lowpass"
    HIGHPASS = "highpass"
    BANDPASS = "bandpass"
    BANDSTOP = "bandstop"


class Design(enum.Enum):
    BUTTERWORTH = "butterworth"
    CHEBYSHEV1 = "chebyshev1"
    CHEBYSHEV2 = "chebyshev2"
    BESSEL = "bessel"


@dataclasses.dataclass
class Zpk:
    z: np.ndarray
    p: np.ndarray
    k: float


@dataclasses.dataclass
class IirResult:
    """Designed IIR filter: transfer function + cascaded biquads (sos)."""

    b: np.ndarray          # numerator
    a: np.ndarray          # denominator (a[0] == 1)
    sos: np.ndarray        # [n_sections, 6] rows (b0 b1 b2 a0 a1 a2)
    zpk: Zpk


# -- analog prototypes (unit cutoff, lowpass) ---------------------------------

def _butterworth_proto(order: int) -> Zpk:
    k = np.arange(order)
    theta = np.pi * (2.0 * k + order + 1.0) / (2.0 * order)
    p = np.exp(1j * theta)
    return Zpk(np.zeros(0, dtype=complex), p, 1.0)


def _cheby1_proto(order: int, ripple_db: float) -> Zpk:
    eps = np.sqrt(10.0 ** (ripple_db / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / order
    k = np.arange(order)
    theta = np.pi * (2.0 * k + 1.0) / (2.0 * order)
    p = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    # unity DC gain (for even order: -ripple at DC, conventional)
    gain = np.real(np.prod(-p))
    if order % 2 == 0:
        gain /= np.sqrt(1.0 + eps * eps)
    return Zpk(np.zeros(0, dtype=complex), p, float(gain))


def _cheby2_proto(order: int, atten_db: float) -> Zpk:
    eps = 1.0 / np.sqrt(10.0 ** (atten_db / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / order
    k = np.arange(order)
    theta = np.pi * (2.0 * k + 1.0) / (2.0 * order)
    # Chebyshev-II: reciprocal of type-I poles; zeros on jw axis at 1/cos positions
    p1 = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    p = 1.0 / p1
    zt = np.cos(theta)
    zt = zt[np.abs(zt) > 1e-12]  # odd order drops the infinite zero
    z = 1j / zt
    gain = np.real(np.prod(-p) / np.prod(-z)) if len(z) else np.real(np.prod(-p))
    return Zpk(z, p, float(gain))


_BESSEL_CACHE: dict[int, np.ndarray] = {}


def _bessel_proto(order: int) -> Zpk:
    """Bessel–Thomson poles: roots of the reverse Bessel polynomial, normalized to
    −3 dB cutoff ≈ 1 (frequency-normalized 'mag' convention)."""
    if order not in _BESSEL_CACHE:
        # reverse Bessel polynomial theta_n(s): a_k = (2n-k)! / (2^(n-k) k! (n-k)!)
        from math import factorial
        n = order
        coeffs = [factorial(2 * n - k) / (2 ** (n - k) * factorial(k) * factorial(n - k))
                  for k in range(n + 1)]
        poly = np.array(coeffs[::-1], dtype=np.float64)  # highest power first
        roots = np.roots(poly)
        # normalize so |H(j1)| = 1/sqrt(2): scale poles by the -3dB frequency
        w = np.logspace(-2, 2, 4096)
        h = np.abs(coeffs[0] / np.polyval(poly, 1j * w))
        w3 = w[np.argmin(np.abs(h - 1.0 / np.sqrt(2.0)))]
        _BESSEL_CACHE[order] = roots / w3
    p = _BESSEL_CACHE[order]
    return Zpk(np.zeros(0, dtype=complex), p, float(np.real(np.prod(-p))))


def _analog_proto(design: Design, order: int, ripple_db: float, atten_db: float) -> Zpk:
    if design is Design.BUTTERWORTH:
        return _butterworth_proto(order)
    if design is Design.CHEBYSHEV1:
        return _cheby1_proto(order, ripple_db)
    if design is Design.CHEBYSHEV2:
        return _cheby2_proto(order, atten_db)
    if design is Design.BESSEL:
        return _bessel_proto(order)
    raise ValueError(f"unknown design {design}")


# -- analog frequency transforms ----------------------------------------------

def _lp2lp(zpk: Zpk, w0: float) -> Zpk:
    deg = len(zpk.p) - len(zpk.z)
    return Zpk(zpk.z * w0, zpk.p * w0, zpk.k * w0 ** deg)


def _lp2hp(zpk: Zpk, w0: float) -> Zpk:
    deg = len(zpk.p) - len(zpk.z)
    z = w0 / zpk.z if len(zpk.z) else np.zeros(0, dtype=complex)
    p = w0 / zpk.p
    zh = np.concatenate([z, np.zeros(deg, dtype=complex)])
    k = zpk.k * np.real(np.prod(-zpk.z) / np.prod(-zpk.p)) if len(zpk.z) \
        else zpk.k / np.real(np.prod(-zpk.p))
    return Zpk(zh, p, float(k))


def _quad_map(x: np.ndarray, w0: float, bw: float) -> np.ndarray:
    """Solve s' from s = (s'^2 + w0^2)/(bw s') for each root x (bandpass map)."""
    a = x * bw / 2.0
    r = np.sqrt(a * a - w0 * w0 + 0j)
    return np.concatenate([a + r, a - r])


def _lp2bp(zpk: Zpk, w0: float, bw: float) -> Zpk:
    deg = len(zpk.p) - len(zpk.z)
    z = _quad_map(zpk.z, w0, bw) if len(zpk.z) else np.zeros(0, dtype=complex)
    p = _quad_map(zpk.p, w0, bw)
    zb = np.concatenate([z, np.zeros(deg, dtype=complex)])
    return Zpk(zb, p, float(zpk.k * bw ** deg))


def _lp2bs(zpk: Zpk, w0: float, bw: float) -> Zpk:
    deg = len(zpk.p) - len(zpk.z)
    # map each root x → roots of s'^2 - (bw/x) s' + w0^2 = 0
    def _map(x):
        a = (bw / x) / 2.0
        r = np.sqrt(a * a - w0 * w0 + 0j)
        return np.concatenate([a + r, a - r])
    z = _map(zpk.z) if len(zpk.z) else np.zeros(0, dtype=complex)
    p = _map(zpk.p)
    extra = np.tile(np.array([1j * w0, -1j * w0]), deg)
    zb = np.concatenate([z, extra])
    k = zpk.k * np.real(np.prod(-zpk.z) / np.prod(-zpk.p)) if len(zpk.z) \
        else zpk.k / np.real(np.prod(-zpk.p))
    return Zpk(zb, p, float(np.real(k)))


# -- bilinear transform --------------------------------------------------------

def _bilinear(zpk: Zpk, fs: float) -> Zpk:
    fs2 = 2.0 * fs
    deg = len(zpk.p) - len(zpk.z)
    zd = (fs2 + zpk.z) / (fs2 - zpk.z) if len(zpk.z) else np.zeros(0, dtype=complex)
    pd = (fs2 + zpk.p) / (fs2 - zpk.p)
    zd = np.concatenate([zd, -np.ones(deg, dtype=complex)])
    k = zpk.k * np.real(np.prod(fs2 - zpk.z) / np.prod(fs2 - zpk.p))
    return Zpk(zd, pd, float(k))


def _zpk_to_ba(zpk: Zpk) -> tuple[np.ndarray, np.ndarray]:
    b = np.real(np.poly(zpk.z)) * zpk.k if len(zpk.z) else np.array([zpk.k])
    a = np.real(np.poly(zpk.p))
    return b, a


def _pair_conjugates(roots: np.ndarray) -> list[np.ndarray]:
    """Group roots into conjugate pairs (+ leftover reals) for SOS building."""
    roots = np.asarray(roots, dtype=complex)
    cplx = sorted([r for r in roots if abs(r.imag) > 1e-10 * max(1.0, abs(r))],
                  key=lambda r: (round(r.real, 10), abs(r.imag)))
    reals = sorted([r.real for r in roots if abs(r.imag) <= 1e-10 * max(1.0, abs(r))])
    pairs: list[np.ndarray] = []
    used = [False] * len(cplx)
    for i, r in enumerate(cplx):
        if used[i]:
            continue
        used[i] = True
        for j in range(i + 1, len(cplx)):
            if not used[j] and abs(cplx[j] - np.conj(r)) < 1e-8 * max(1.0, abs(r)):
                used[j] = True
                pairs.append(np.array([r, cplx[j]]))
                break
        else:
            pairs.append(np.array([r, np.conj(r)]))  # tolerate numeric asymmetry
    i = 0
    while i + 1 < len(reals):
        pairs.append(np.array([reals[i], reals[i + 1]], dtype=complex))
        i += 2
    if i < len(reals):
        pairs.append(np.array([reals[i]], dtype=complex))
    return pairs


def _zpk_to_sos(zpk: Zpk) -> np.ndarray:
    """Split into biquad sections, pairing poles/zeros nearest in frequency."""
    ppairs = _pair_conjugates(zpk.p)
    zpairs = _pair_conjugates(zpk.z)
    # order sections by pole magnitude (closest to unit circle last for stability)
    ppairs.sort(key=lambda pr: np.max(np.abs(pr)))
    sos = []
    zremaining = list(zpairs)
    for i, pp in enumerate(ppairs):
        if zremaining:
            # pick the zero pair closest in angle to this pole pair
            ang = np.angle(pp[0])
            jbest = int(np.argmin([abs(abs(np.angle(zp[0])) - abs(ang))
                                   for zp in zremaining]))
            zp = zremaining.pop(jbest)
        else:
            zp = np.zeros(0, dtype=complex)
        bsec = np.real(np.poly(zp)) if len(zp) else np.array([1.0])
        asec = np.real(np.poly(pp))
        bsec = np.pad(bsec, (0, 3 - len(bsec)))
        asec = np.pad(asec, (0, 3 - len(asec)))
        sos.append(np.concatenate([bsec, asec]))
    if sos:
        sos[0][:3] *= zpk.k
    else:
        sos = [np.array([zpk.k, 0, 0, 1, 0, 0])]
    return np.array(sos)


def ba_to_sos(b: Sequence[float], a: Sequence[float]) -> np.ndarray:
    """Factor a transfer function into biquad sections (via roots → zpk → sos)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    k = b[0] / a[0] if b[0] != 0 else 1.0
    z = np.roots(b / b[0]) if len(b) > 1 and b[0] != 0 else \
        (np.roots(b) if len(b) > 1 else np.zeros(0, complex))
    p = np.roots(a / a[0]) if len(a) > 1 else np.zeros(0, complex)
    if b[0] == 0:
        k = b[np.nonzero(b)[0][0]] / a[0] if np.any(b) else 0.0
    return _zpk_to_sos(Zpk(z, p, float(k)))


def design_iir(design: Design | str, ftype: Type | str, order: int, *,
               sample_rate: float, f_low: float, f_high: float | None = None,
               ripple_db: float = 1.0, atten_db: float = 40.0) -> IirResult:
    """Design a digital IIR filter (≈ iir::designFilter, FilterTool.hpp:850).

    ``f_low``: cutoff (low/high-pass) or lower band edge; ``f_high``: upper band edge
    for band-pass/stop. Frequencies in Hz.
    """
    design = Design(design) if not isinstance(design, Design) else design
    ftype = Type(ftype) if not isinstance(ftype, Type) else ftype
    fs = float(sample_rate)
    proto = _analog_proto(design, order, ripple_db, atten_db)
    warp = lambda f: 2.0 * fs * np.tan(np.pi * f / fs)
    if ftype is Type.LOWPASS:
        analog = _lp2lp(proto, warp(f_low))
    elif ftype is Type.HIGHPASS:
        analog = _lp2hp(proto, warp(f_low))
    else:
        if f_high is None:
            raise ValueError("band filters need f_high")
        w1, w2 = warp(f_low), warp(f_high)
        w0 = np.sqrt(w1 * w2)
        bw = w2 - w1
        analog = _lp2bp(proto, w0, bw) if ftype is Type.BANDPASS \
            else _lp2bs(proto, w0, bw)
    digital = _bilinear(analog, fs)
    b, a = _zpk_to_ba(digital)
    sos = _zpk_to_sos(digital)
    return IirResult(b=b, a=a, sos=sos, zpk=digital)


# -- FIR design ----------------------------------------------------------------

def design_fir(ftype: Type | str, ntaps: int, *, sample_rate: float, f_low: float,
               f_high: float | None = None, window: str = "Hamming",
               beta: float = 8.6, gain: float = 1.0) -> np.ndarray:
    """Windowed-sinc FIR design (≈ fir::designFilter, FilterTool.hpp:1007).

    Returns float64 taps of length ``ntaps`` with unity passband gain × ``gain``.
    """
    ftype = Type(ftype) if not isinstance(ftype, Type) else ftype
    fs = float(sample_rate)
    n = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    w = make_window(window, ntaps, beta=beta, dtype=np.float64)

    def sinc_lp(fc: float) -> np.ndarray:
        x = 2.0 * fc / fs
        h = x * np.sinc(x * n)
        return h

    if ftype is Type.LOWPASS:
        h = sinc_lp(f_low) * w
        h /= np.sum(h)  # unity DC gain
    elif ftype is Type.HIGHPASS:
        if ntaps % 2 == 0:
            raise ValueError("highpass FIR needs odd ntaps (type-I)")
        h = -sinc_lp(f_low) * w
        h[(ntaps - 1) // 2] += w[(ntaps - 1) // 2]
        # unity gain at Nyquist
        nyq = np.sum(h * np.cos(np.pi * np.arange(ntaps)))
        h /= np.abs(nyq)
    elif ftype is Type.BANDPASS:
        if f_high is None:
            raise ValueError("bandpass needs f_high")
        h = (sinc_lp(f_high) - sinc_lp(f_low)) * w
        fc = 0.5 * (f_low + f_high)
        resp = np.sum(h * np.exp(-1j * 2 * np.pi * fc / fs * np.arange(ntaps)))
        h /= np.abs(resp)
    elif ftype is Type.BANDSTOP:
        if f_high is None:
            raise ValueError("bandstop needs f_high")
        if ntaps % 2 == 0:
            raise ValueError("bandstop FIR needs odd ntaps (type-I)")
        h = (sinc_lp(f_low) - sinc_lp(f_high)) * w
        h[(ntaps - 1) // 2] += w[(ntaps - 1) // 2]
        h /= np.sum(h)
    else:
        raise ValueError(f"unknown filter type {ftype}")
    return h * gain


def remez(numtaps: int, bands: Sequence[float], desired: Sequence[float], *,
          weight: Sequence[float] | None = None, fs: float = 1.0,
          grid_density: int = 16, maxiter: int = 60) -> np.ndarray:
    """Parks–McClellan optimal equiripple linear-phase FIR design (Remez exchange).

    Beyond the reference's FilterTool (windowed-sinc only, FilterTool.hpp:1007) —
    added because GNU Radio users expect ``pm_remez``-style design. Supports
    type-I (odd ``numtaps``) and type-II (even) symmetric filters.

    ``bands``: flat band-edge list ``[b0_lo, b0_hi, b1_lo, b1_hi, ...]`` in Hz;
    ``desired``: one gain per band; ``weight``: one relative weight per band.
    Returns float64 taps of length ``numtaps``.
    """
    bands = np.asarray(bands, np.float64).reshape(-1, 2) / fs
    desired = np.asarray(desired, np.float64)
    if len(desired) != len(bands):
        raise ValueError("need one desired gain per band")
    wt = np.ones(len(bands)) if weight is None else np.asarray(weight, np.float64)
    if len(wt) != len(bands):
        raise ValueError("need one weight per band")
    if np.any(bands < 0) or np.any(bands > 0.5) or np.any(np.diff(bands.ravel()) < 0):
        raise ValueError("band edges must be ascending within [0, fs/2]")
    if numtaps < 3:
        raise ValueError("numtaps must be >= 3")
    even = numtaps % 2 == 0
    if even and bands[-1, 1] >= 0.5 - 1e-12 and desired[-1] != 0.0:
        raise ValueError("even numtaps (type-II FIR) forces zero gain at fs/2; "
                         "use odd numtaps for a band that is passband at Nyquist")
    n_cos = (numtaps + 1) // 2          # cosine-polynomial coefficient count
    r = n_cos + 1                       # extremal frequencies (alternation theorem)

    # dense frequency grid over the union of bands
    df = 0.5 / (grid_density * n_cos)
    fgrid, dgrid, wgrid, sgrid = [], [], [], []
    for i, ((lo, hi), d, w) in enumerate(zip(bands, desired, wt)):
        npts = max(int(round((hi - lo) / df)) + 1, 5)
        fgrid.append(np.linspace(lo, hi, npts))
        dgrid.append(np.full(npts, d))
        wgrid.append(np.full(npts, w))
        sgrid.append(np.full(npts, i))
    fgrid = np.concatenate(fgrid)
    D = np.concatenate(dgrid)
    W = np.concatenate(wgrid)
    seg = np.concatenate(sgrid)
    if even:
        # type II: H(f) = cos(pi f) P(f); solve for P with adjusted D, W
        keep = fgrid < 0.5 - 1e-9
        fgrid, D, W, seg = fgrid[keep], D[keep], W[keep], seg[keep]
        cosf = np.cos(np.pi * fgrid)
        D = D / cosf
        W = W * cosf
    xg = np.cos(2.0 * np.pi * fgrid)
    L = len(fgrid)
    if L < r:
        raise ValueError("grid too coarse for this filter order; raise grid_density")

    ext = np.unique(np.round(np.linspace(0, L - 1, r)).astype(int))
    while len(ext) < r:  # dedupe collisions on tiny grids
        pool = np.setdiff1d(np.arange(L), ext)
        ext = np.sort(np.concatenate([ext, pool[: r - len(ext)]]))

    signs = (-1.0) ** np.arange(r)
    c = beta = xk = None
    for _ in range(maxiter):
        xk, Dk, Wk = xg[ext], D[ext], W[ext]
        diff = xk[:, None] - xk[None, :]
        np.fill_diagonal(diff, 1.0)
        sign = np.prod(np.sign(diff), axis=1)
        logp = np.sum(np.log(np.abs(diff)), axis=1)
        gamma = sign * np.exp(-(logp - logp.mean()))  # common scale cancels below
        delta = (gamma @ Dk) / np.sum(gamma * signs / Wk)
        cvals = Dk - signs * delta / Wk
        # barycentric interpolation of degree r-2 through the first r-1 extrema
        beta = gamma[:-1] * (xk[:-1] - xk[-1])
        c = cvals[:-1]
        A = _bary_eval(xg, xk[:-1], beta, c)
        err = W * (A - D)

        # candidate extrema: per-band-segment local maxima AND minima of the
        # SIGNED error (a "-" slot can sit at a local min even while err > 0
        # mid-convergence) + segment endpoints typed by their inward slope
        cand: list[tuple[int, int]] = []   # (grid index, type +1 max / -1 min)
        for s in range(int(seg[-1]) + 1):
            idx = np.nonzero(seg == s)[0]
            if len(idx) == 0:
                continue
            e = err[idx]
            if len(idx) > 2:
                mx = np.nonzero((e[1:-1] >= e[:-2]) & (e[1:-1] >= e[2:]))[0] + 1
                mn = np.nonzero((e[1:-1] <= e[:-2]) & (e[1:-1] <= e[2:]))[0] + 1
                cand.extend((int(idx[i]), +1) for i in mx)
                cand.extend((int(idx[i]), -1) for i in mn)
            if len(idx) == 1:
                cand.append((int(idx[0]), +1 if e[0] >= 0 else -1))
            else:
                cand.append((int(idx[0]), +1 if e[0] >= e[1] else -1))
                cand.append((int(idx[-1]), +1 if e[-1] >= e[-2] else -1))
        cand = sorted(set(cand))
        # enforce type alternation; in same-type runs keep the most extreme
        sel: list[tuple[int, int]] = []
        for i, t in cand:
            if sel and i == sel[-1][0]:
                continue  # plateau point typed both ways — keep one
            if sel and sel[-1][1] == t:
                if t * err[i] > t * err[sel[-1][0]]:
                    sel[-1] = (i, t)
            else:
                sel.append((i, t))
        while len(sel) > r:  # drop the weaker end (preserves alternation)
            if sel[0][1] * err[sel[0][0]] < sel[-1][1] * err[sel[-1][0]]:
                sel.pop(0)
            else:
                sel.pop()
        if len(sel) < r:
            break  # degenerate (over-determined spec); keep last solution
        sel_idx = [i for i, _ in sel]
        new_ext = np.asarray(sel_idx)
        emax = float(np.max(np.abs(err[new_ext])))
        if np.array_equal(new_ext, ext) or \
                emax - abs(delta) <= 1e-6 * max(abs(delta), 1e-12):
            ext = new_ext
            break
        ext = new_ext

    # recover taps: sample H(f) = A(f)·[cos(pi f) if type II]·e^{-j pi f (N-1)}
    nfft = 1
    while nfft < 4 * numtaps:
        nfft *= 2
    fj = np.arange(nfft // 2 + 1) / nfft
    Af = _bary_eval(np.cos(2.0 * np.pi * fj), xk[:-1], beta, c)
    if even:
        Af = Af * np.cos(np.pi * fj)
    H = Af * np.exp(-1j * np.pi * fj * (numtaps - 1))
    h = np.fft.irfft(H, nfft)[:numtaps]
    return 0.5 * (h + h[::-1])  # exact linear-phase symmetry


def _bary_eval(x: np.ndarray, nodes: np.ndarray, beta: np.ndarray,
               vals: np.ndarray) -> np.ndarray:
    """Barycentric Lagrange evaluation, exact at nodes."""
    dx = x[:, None] - nodes[None, :]
    hit = np.abs(dx) < 1e-13
    dx_safe = np.where(hit, 1.0, dx)
    wq = beta / dx_safe
    out = (wq @ vals) / np.sum(wq, axis=1)
    rows, cols = np.nonzero(hit)
    out[rows] = vals[cols]
    return out


def freq_response(b: Sequence[float], a: Sequence[float] = (1.0,), *,
                  n: int = 512, sample_rate: float = 2.0 * np.pi,
                  freqs: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate H(e^{jω}) = B(z)/A(z) on ``n`` points in [0, fs/2] (or at ``freqs``).

    Returns (freqs_hz, complex response).
    """
    if freqs is None:
        freqs = np.linspace(0.0, sample_rate / 2.0, n, endpoint=False)
    w = 2.0 * np.pi * freqs / sample_rate
    zinv = np.exp(-1j * w)
    num = _polyeval(b, zinv)
    den = _polyeval(a, zinv)
    return np.asarray(freqs), num / den


def _polyeval(coeffs: Sequence[float], zinv: np.ndarray) -> np.ndarray:
    """Σ_k c[k] z^{-k} (direct-form transfer-function convention)."""
    c = np.asarray(coeffs, dtype=np.complex128)
    out = np.zeros_like(zinv, dtype=np.complex128)
    for k, ck in enumerate(c):
        out += ck * zinv ** k
    return out


def sos_freq_response(sos: np.ndarray, *, n: int = 512,
                      sample_rate: float = 2.0 * np.pi
                      ) -> tuple[np.ndarray, np.ndarray]:
    freqs = np.linspace(0.0, sample_rate / 2.0, n, endpoint=False)
    h = np.ones(n, dtype=np.complex128)
    for row in np.atleast_2d(sos):
        _, hr = freq_response(row[:3], row[3:], freqs=freqs, sample_rate=sample_rate)
        h *= hr
    return freqs, h
