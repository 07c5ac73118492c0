"""LDPC codes: GF(2) construction/encoding (host NumPy) and the device-side
normalized min-sum belief-propagation decoder.

Messages live on the Tanner-graph edges. Two decoder forms compute the same
schedule:

- :func:`min_sum_decode`, the segment form: messages [batch, E] over the flat
  edge arrays, segment sums by ``index_add_`` and segment minima by
  ``scatter_reduce(..., "amin", include_self=False)``;
- :func:`min_sum_decode_dense`, the dense check layout: messages
  [batch, m, wr], per-row minima over the short ``wr`` axis and every segment
  sum or gather a float32 matmul with the one-hot ``S`` [m·wr, n].

:func:`decode` chooses from the device: the segment form on the CPU (the JAX
package's CPU form); on CUDA the dense form, the faster one at suite config
7k's shape on the H100 (timed by ``chip_smoke.py``). The iterations are a
Python loop.

Construction: regular Gallager-style (column weight ``wc``) parity matrices
with a deterministic RNG, then Gaussian elimination over GF(2) to a systematic
generator — encoding is a plain 0/1 matmul.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.errors import GrError
from .cuda_kernels import device_constant, frozen
from .precision import check_f32_matmul

_BIG = 1e30


# -- construction (host) -------------------------------------------------------

def make_ldpc(n: int, m: int, *, wc: int = 3, seed: int = 0
              ) -> tuple[np.ndarray, np.ndarray]:
    """Build a regular-ish LDPC code: returns (H [m, n], G [k, n]) with
    G·Hᵀ = 0 and G systematic in the first k columns (k = n − rank(H)).
    Column weight ``wc``; rows balanced."""
    if not (0 < m < n):
        raise GrError(f"ldpc: need 0 < m < n (got m={m}, n={n})")
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.uint8)
    fill = rng.permutation(np.arange(n * wc) % m)
    for j in range(n):
        rows = set()
        for s in fill[j * wc:(j + 1) * wc]:
            r = int(s)
            while r in rows:
                r = int(rng.integers(m))
            rows.add(r)
            H[r, j] = 1
    # systematic form: column-permute + eliminate so the LAST m columns of
    # H are invertible → H = [P | I-ish], G = [I | Pᵀ]
    Hw = H.copy()
    perm = np.arange(n)
    r = 0
    for col in range(n - 1, -1, -1):        # aim pivots at the right side
        if r >= m:
            break
        pivot = None
        for i in range(r, m):
            if Hw[i, col]:
                pivot = i
                break
        if pivot is None:
            continue
        if pivot != r:
            Hw[[r, pivot]] = Hw[[pivot, r]]
        for i in range(m):
            if i != r and Hw[i, col]:
                Hw[i] ^= Hw[r]
        # move this column to position n-1-r
        tgt = n - 1 - r
        if col != tgt:
            Hw[:, [col, tgt]] = Hw[:, [tgt, col]]
            perm[[col, tgt]] = perm[[tgt, col]]
        r += 1
    if r < m:
        # rank-deficient H: drop dependent rows
        Hw = Hw[:r]
        m = r
    k = n - m
    # Hw = [A | B] with B (m x m) a permutation of I from the elimination:
    # reorder the rows to make it exactly I
    B = Hw[:, k:]
    row_for_col = np.argmax(B, axis=0)
    Hw = Hw[row_for_col]
    A = Hw[:, :k]
    # codeword c = [u | p], p = u·Aᵀ (since A·u + I·p = 0 over GF(2))
    G = np.concatenate([np.eye(k, dtype=np.uint8), A.T], axis=1)
    # belief propagation needs the SPARSE parity matrix — the row-reduced Hw
    # is dense. The original H with the same column permutation has the same
    # null space (row ops preserve it), so decode with that; redundant
    # (dependent) rows are harmless extra checks.
    H_dec = H[:, perm].astype(np.uint8)
    assert not ((G @ H_dec.T) % 2).any(), "ldpc: G·Hᵀ != 0"
    return H_dec, G


def encode(G: np.ndarray, u: np.ndarray) -> np.ndarray:
    """u [*, k] data bits → c [*, n] codeword bits (systematic)."""
    u = np.asarray(u, np.uint8)
    return (u @ G) % 2


# -- device decoder -------------------------------------------------------------

class LdpcGraph:
    """Static Tanner-graph arrays for the device decoder, built on the host
    (read-only) and uploaded once per device (:meth:`on`).

    - flat edge arrays ``chk``/``var`` (edge → check / variable index) for the
      segment form;
    - the dense check layout: ``V [m, wr]`` = variable index per check slot
      (padded), ``mask [m, wr]`` (1.0 on real edges) and the one-hot scatter
      matrix ``S [m·wr, n]`` that turns every segment sum into a matmul.
    """

    def __init__(self, H: np.ndarray):
        H = np.asarray(H, np.uint8)
        self.m, self.n = H.shape
        chk, var = np.nonzero(H)
        self.chk_np = chk.astype(np.int64)
        self.var_np = var.astype(np.int64)
        self.n_edges = len(chk)
        self.H = H
        wr = int(np.max(H.sum(axis=1)))
        V = np.zeros((self.m, wr), np.int64)
        mask = np.zeros((self.m, wr), np.float32)
        for i in range(self.m):
            vs = np.nonzero(H[i])[0]
            V[i, : len(vs)] = vs
            mask[i, : len(vs)] = 1.0
        S = np.zeros((self.m * wr, self.n), np.float32)
        S[np.arange(self.m * wr), V.reshape(-1)] = mask.reshape(-1)
        self.wr = wr
        self.V_np = V           # [m, wr] variable index per slot
        self.mask_np = mask     # [m, wr] 1.0 on real edges
        self.S_np = S           # [m·wr, n] masked one-hot scatter
        self._host = {"chk": self.chk_np, "var": self.var_np,
                      "edge": np.arange(self.n_edges), "mask": mask, "S": S,
                      "St": np.ascontiguousarray(S.T)}
        frozen(*self._host.values(), V)

    def on(self, device: torch.device | str) -> dict[str, torch.Tensor]:
        """The graph's arrays as tensors on ``device`` (uploaded once)."""
        return {k: device_constant(a, device) for k, a in self._host.items()}


def _check_iters(n_iters: int) -> None:
    if n_iters < 1:
        raise GrError(f"ldpc: n_iters must be >= 1, got {n_iters}")


def min_sum_decode(graph: LdpcGraph, llr: torch.Tensor, n_iters: int = 25,
                   alpha: float = 0.8125) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized min-sum BP, segment form. ``llr`` is [batch, n] float32
    (positive = bit 0). Returns (hard_bits [batch, n] uint8, syndrome_ok
    [batch] bool)."""
    _check_iters(n_iters)
    d = graph.on(llr.device)
    chk, var, edge = d["chk"], d["var"], d["edge"]
    m, n, E = graph.m, graph.n, graph.n_edges
    l = llr.to(torch.float32)
    b = l.shape[0]
    chk_b = chk.expand(b, E)
    lv = l[:, var]                              # initial messages [b, E]
    v2c = lv

    def seg_min(vals, init):
        return init.scatter_reduce(1, chk_b, vals, "amin", include_self=False)

    inf = torch.full((b, m), float("inf"), device=l.device)
    for _ in range(n_iters):
        # check update: two-minimum trick over each check's edges
        mag = torch.abs(v2c)
        neg = (v2c < 0).to(torch.int32)
        tot_neg = torch.zeros(b, m, dtype=torch.int32, device=l.device
                              ).index_add_(1, chk, neg)
        s_ex = torch.where((tot_neg[:, chk] - neg) % 2 == 1, -1.0, 1.0)
        min1 = seg_min(mag, inf)[:, chk]
        # the first-minimum edge: the smallest edge index reaching min1
        first = seg_min(torch.where(mag <= min1, edge, E),
                        torch.full((b, m), E, device=l.device))[:, chk]
        use2 = edge == first
        min2 = seg_min(torch.where(use2, _BIG, mag), inf)[:, chk]
        c2v = alpha * s_ex * torch.where(use2, min2, min1)
        # variable update: total sum per variable minus own message
        tot = torch.zeros(b, n, device=l.device).index_add_(1, var, c2v)
        v2c = lv + tot[:, var] - c2v
    tot = torch.zeros(b, n, device=l.device).index_add_(1, var, c2v)
    hard = ((l + tot) < 0).to(torch.uint8)
    syn = torch.zeros(b, m, dtype=torch.int32, device=l.device).index_add_(
        1, chk, hard[:, var].to(torch.int32)) % 2
    return hard, ~syn.to(torch.bool).any(dim=-1)


def min_sum_decode_dense(graph: LdpcGraph, llr: torch.Tensor, n_iters: int = 25,
                         alpha: float = 0.8125
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized min-sum BP in the dense check layout: messages [batch, m, wr];
    per-row min/sum over the wr axis; scatter sums and gathers as float32
    matmuls with the one-hot ``S`` (TF32 off, checked). Algebraically the
    segment form (ties between exactly equal minima may pick another edge;
    with continuous LLRs that has measure zero)."""
    _check_iters(n_iters)
    check_f32_matmul("min_sum_decode_dense")
    d = graph.on(llr.device)
    mask, S, St = d["mask"], d["S"], d["St"]
    m, wr = graph.m, graph.wr
    l = llr.to(torch.float32)
    b = l.shape[0]
    live = mask > 0

    def scatter_sum(x):                         # [b, m, wr] → [b, n]
        return x.reshape(b, m * wr) @ S

    def gather(y):                              # [b, n] → [b, m, wr]
        return (y @ St).reshape(b, m, wr)

    lv = gather(l)                              # l[V[i, s]] per slot
    v2c = lv
    for _ in range(n_iters):
        mag = torch.where(live, torch.abs(v2c), _BIG)
        neg = torch.where(live, (v2c < 0).to(torch.float32), 0.0)
        tot_neg = neg.sum(dim=-1, keepdim=True)
        s_ex = 1.0 - 2.0 * ((tot_neg - neg) % 2.0)      # sign excluding self
        min1 = mag.min(dim=-1, keepdim=True).values
        is_first = F.one_hot(mag.argmin(dim=-1), wr) > 0
        min2 = torch.where(is_first, _BIG, mag).min(dim=-1, keepdim=True).values
        c2v = alpha * s_ex * torch.where(is_first, min2, min1) * mask
        v2c = (lv + gather(scatter_sum(c2v)) - c2v) * mask
    hard = ((l + scatter_sum(c2v)) < 0).to(torch.uint8)
    par = (gather(hard.to(torch.float32)) * mask).sum(dim=-1) % 2.0
    return hard, ~(par > 0.5).any(dim=-1)


def decode(graph: LdpcGraph, llr: torch.Tensor, n_iters: int = 25,
           alpha: float = 0.8125) -> tuple[torch.Tensor, torch.Tensor]:
    """Min-sum decode in the form chosen from ``llr``'s device: the segment
    form on the CPU, the dense form on CUDA. At config 7k's shape (2048 frames
    of n = 256, 25 iterations) on an NVIDIA H100 80GB HBM3, 700.00 W, 12
    alternating pairs (PERF.md §6): dense 9.1055 ms against segment 10.1477
    (median), 765 against 1065 kernels per decode."""
    if llr.is_cuda:
        return min_sum_decode_dense(graph, llr, n_iters, alpha)
    return min_sum_decode(graph, llr, n_iters, alpha)


def decode_np(H: np.ndarray, llr: np.ndarray, n_iters: int = 25,
              alpha: float = 0.8125) -> tuple[np.ndarray, np.ndarray]:
    """NumPy reference of :func:`min_sum_decode` (same schedule)."""
    H = np.asarray(H, np.uint8)
    m, n = H.shape
    chk, var = np.nonzero(H)
    E = len(chk)
    out_bits = []
    out_ok = []
    for l in np.atleast_2d(np.asarray(llr, np.float64)):
        v2c = l[var]
        c2v = np.zeros(E)
        for _ in range(n_iters):
            mag = np.abs(v2c)
            neg = (v2c < 0).astype(np.int64)
            tot_neg = np.bincount(chk, weights=neg, minlength=m)
            s_ex = np.where((tot_neg[chk] - neg) % 2 == 1, -1.0, 1.0)
            min1 = np.full(m, np.inf)
            np.minimum.at(min1, chk, mag)
            first_idx = np.full(m, E)
            cand = np.where(mag <= min1[chk], np.arange(E), E)
            np.minimum.at(first_idx, chk, cand)
            masked = np.where(np.arange(E) == first_idx[chk], np.inf, mag)
            min2 = np.full(m, np.inf)
            np.minimum.at(min2, chk, masked)
            use2 = np.arange(E) == first_idx[chk]
            c2v = alpha * s_ex * np.where(use2, min2[chk], min1[chk])
            tot = np.bincount(var, weights=c2v, minlength=n)
            v2c = l[var] + tot[var] - c2v
        tot = np.bincount(var, weights=c2v, minlength=n)
        hard = ((l + tot) < 0).astype(np.uint8)
        syn = np.bincount(chk, weights=hard[var], minlength=m) % 2
        out_bits.append(hard)
        out_ok.append(not syn.any())
    return np.stack(out_bits), np.asarray(out_ok)
