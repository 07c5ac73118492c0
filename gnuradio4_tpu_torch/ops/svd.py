"""SVD utilities + SVD-based denoising (≈ reference algorithm/filter/SvdFilter.hpp
Hankel-matrix denoiser and core SVD.hpp one-sided Jacobi).

Two engines: ``torch.linalg.svd`` (LAPACK on the CPU, cuSOLVER on the card) and
a one-sided Jacobi sweep written as batched torch ops. The Hankel matrix is an
index gather of overlapping frames; rank truncation keeps the top-k singular
values; the denoised signal is recovered by anti-diagonal averaging. Every
function takes leading batch dimensions (a batch of chunks is one call).
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import check_f32_matmul


def hankel(x: torch.Tensor, window: int) -> torch.Tensor:
    """[..., T] → Hankel [..., T - window + 1, window] (overlapping frames,
    stride 1)."""
    t = x.shape[-1]
    n = t - window + 1
    idx = (torch.arange(n, device=x.device)[:, None]
           + torch.arange(window, device=x.device)[None, :])
    return x[..., idx]


def rank_mask(s: torch.Tensor, *, max_rank: int | None = None,
              energy_fraction: float = 1.0, rel_threshold: float = 0.0,
              abs_threshold: float = 0.0) -> torch.Tensor:
    """Effective-rank selection mask over descending singular values.

    Mirrors the reference's ``computeEffectiveRank`` rule
    (algorithm SvdFilter.hpp:42-64): keep σ_i while i < max_rank,
    σ_i/σ_0 ≥ rel_threshold, σ_i ≥ abs_threshold, and the cumulative energy
    *before* σ_i is below ``energy_fraction``·total (the crossing component is
    kept). Because σ descends, every break condition is a prefix property, so
    the sequential loop collapses to one elementwise mask. Always keeps σ_0.
    """
    e = s * s
    cum_before = torch.cumsum(e, dim=-1) - e
    cutoff = energy_fraction * torch.sum(e, dim=-1, keepdim=True)
    idx = torch.arange(s.shape[-1], device=s.device)
    keep = cum_before < cutoff
    if max_rank is not None:
        keep &= idx < max_rank
    if rel_threshold > 0.0:
        keep &= s >= rel_threshold * s[..., :1]
    if abs_threshold > 0.0:
        keep &= s >= abs_threshold
    keep[..., 0] = True
    return keep


def svd_denoise(x: torch.Tensor, *, window: int = 32, rank: int = 4,
                method: str = "xla", energy_fraction: float = 1.0,
                rel_threshold: float = 0.0, abs_threshold: float = 0.0
                ) -> torch.Tensor:
    """Truncated-SVD denoise of ``x`` [..., T] (each row a signal) via Hankel
    embedding.

    Keeps the largest singular components selected by :func:`rank_mask`
    (``rank`` cap ∧ ``energy_fraction`` ∧ σ thresholds — the reference's
    adaptive-rank rule, SvdFilter.hpp:42-64) and reconstructs by averaging
    anti-diagonals (the unbiased Hankel inverse). ``method='jacobi'`` uses the
    one-sided Jacobi sweep (:func:`jacobi_svd`) instead of ``torch.linalg.svd``.
    """
    t = x.shape[-1]
    h = hankel(x, window)                                   # [..., N, W]
    u, s, vt = svd(h, method=method)
    keep = rank_mask(s, max_rank=rank, energy_fraction=energy_fraction,
                     rel_threshold=rel_threshold, abs_threshold=abs_threshold)
    s_trunc = torch.where(keep, s, torch.zeros((), dtype=s.dtype,
                                               device=s.device))
    check_f32_matmul("svd_denoise")
    h_hat = (u * s_trunc[..., None, :].to(u.dtype)) @ vt
    # anti-diagonal averaging: y[k] = mean over {(i,j): i+j=k} of h_hat[i, j]
    n, w = h_hat.shape[-2:]
    ii = (torch.arange(n, device=x.device)[:, None]
          + torch.arange(w, device=x.device)[None, :]).reshape(-1)
    lead = h_hat.shape[:-2]
    sums = torch.zeros((*lead, t), dtype=h_hat.dtype, device=x.device)
    sums.index_add_(-1, ii, h_hat.reshape(*lead, n * w))
    counts = torch.zeros(t, dtype=torch.float32, device=x.device)
    counts.index_add_(0, ii, torch.ones(n * w, dtype=torch.float32,
                                        device=x.device))
    return (sums / counts).to(x.dtype)


def svd(a: torch.Tensor, *, full_matrices: bool = False, method: str = "xla"):
    """SVD with selectable engine.

    ``method='xla'`` (the JAX package's name for its library SVD) →
    ``torch.linalg.svd``. ``method='jacobi'`` → :func:`jacobi_svd`, the same
    algorithm family as the reference's own implementation (core SVD.hpp:1-10
    one-sided Jacobi).
    """
    if method == "jacobi":
        if a.shape[-2] < a.shape[-1]:
            # jacobi needs m ≥ n; SVD the transpose and swap factors:
            # A = (Aᵀ)ᵀ = (U'SV'ᴴ)ᵀ ⇒ U = conj(V') = vtᵀ*, Vᴴ = U'ᵀ
            u2, s2, vt2 = jacobi_svd(a.transpose(-1, -2))
            return vt2.transpose(-1, -2), s2, u2.transpose(-1, -2)
        return jacobi_svd(a)
    return torch.linalg.svd(a, full_matrices=full_matrices)


def _tournament_schedule(n: int) -> np.ndarray:
    """Round-robin pairings: [n-1 rounds, n/2 pairs, 2] column indices.

    Classic circle method: player 0 fixed, the rest rotate. Over n-1 rounds
    every unordered column pair meets exactly once — one full Jacobi sweep.
    """
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([[players[i], players[n - 1 - i]]
                       for i in range(n // 2)])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, np.int32)          # [n-1, n/2, 2]


def jacobi_svd(a: torch.Tensor, *, sweeps: int = 12, eps: float = 1e-12):
    """One-sided Jacobi SVD (≈ reference core SVD.hpp one-sided Jacobi).

    A FIXED number of sweeps (no convergence test, as in the JAX package);
    within each round of a sweep the round-robin tournament schedule gives
    n/2 DISJOINT column pairs, so all rotations of the round apply at once,
    batched over the pairs and every leading batch dimension (a Python loop
    over sweeps and rounds, ~40 torch ops a round). Converged pairs rotate by
    identity through ``torch.where`` instead of branching.

    Returns ``(u [m,n], s [n], vt [n,n])`` with s descending, for m ≥ n.
    Complex input: the column pair rotation becomes the unitary Givens
    ``[[c, s·φ], [-s·conj(φ), c]]`` with ``φ = γ/|γ|`` the phase of the
    complex column inner product, and ``vt`` is the conjugate transpose.
    """
    orig_n = a.shape[-1]
    if a.shape[-2] < orig_n:
        raise ValueError("jacobi_svd needs m >= n; transpose the input")
    cplx = a.is_complex()
    if orig_n % 2:                       # schedule needs an even player count
        a = torch.cat([a, a[..., :1] * 0], dim=-1)
    n = a.shape[-1]
    sched = torch.from_numpy(_tournament_schedule(n).astype(np.int64)).to(a.device)
    aa = a.clone()
    vv = torch.eye(n, dtype=a.dtype, device=a.device).expand(
        *a.shape[:-2], n, n).clone()
    one = torch.ones((), dtype=torch.float32, device=a.device)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)

    def sqnorm(c):
        return torch.sum(c.abs() ** 2 if cplx else c * c, dim=-2)

    for _ in range(sweeps):
        for r in range(n - 1):
            p, q = sched[r, :, 0], sched[r, :, 1]
            ap, aq = aa[..., :, p], aa[..., :, q]          # [..., m, n/2]
            alpha, beta = sqnorm(ap), sqnorm(aq)
            gamma = torch.sum(ap.conj() * aq if cplx else ap * aq, dim=-2)
            g = gamma.abs()
            # Rutishauser rotation solving  [[alpha,|γ|],[|γ|,beta]]; a
            # complex γ first rotates column q by conj(φ) to make the pair
            # product real.
            if cplx:
                phi = gamma / torch.where(g == 0.0, one, g)
                gr = g
            else:
                gr = gamma
            zeta = (beta - alpha) / (2.0 * torch.where(gr == 0.0, one, gr))
            # sign(0)=0 would freeze equal-norm pairs (α=β ⇒ 45°, t=1)
            sgn = torch.where(zeta == 0.0, one, torch.sign(zeta))
            t = sgn / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
            live = g > eps * torch.sqrt(alpha * beta)
            t = torch.where(live, t, zero)                # identity when converged
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = c * t
            c_ = c[..., None, :].to(aa.dtype)
            if cplx:
                s_p = (s * phi.conj())[..., None, :]       # applies to column q
                s_q = (s * phi)[..., None, :]              # applies to column p
            else:
                s_p = s_q = s[..., None, :]
            aa[..., :, p] = c_ * ap - s_p * aq
            aa[..., :, q] = s_q * ap + c_ * aq
            vp, vq = vv[..., :, p], vv[..., :, q]
            vv[..., :, p] = c_ * vp - s_p * vq
            vv[..., :, q] = s_q * vp + c_ * vq
    s = torch.sqrt(sqnorm(aa))                            # column norms
    order = torch.argsort(-s, dim=-1, stable=True)
    s = torch.gather(s, -1, order)
    cols = order[..., None, :]
    aa = torch.gather(aa, -1, cols.expand(*aa.shape[:-1], n))
    vv = torch.gather(vv, -1, cols.expand(*vv.shape[:-1], n))
    u = aa / torch.where(s[..., None, :] == 0.0, one,
                         s[..., None, :]).to(aa.dtype)
    if orig_n != n:                                       # drop the pad column
        u, s = u[..., :, :orig_n], s[..., :orig_n]
        vv = vv[..., :orig_n, :orig_n]
    vt = (vv.conj() if cplx else vv).transpose(-1, -2)
    return u, s, vt


def low_rank_approx(a: torch.Tensor, rank: int) -> torch.Tensor:
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    check_f32_matmul("low_rank_approx")
    return (u[..., :, :rank] * s[..., None, :rank].to(u.dtype)) @ vt[..., :rank, :]
