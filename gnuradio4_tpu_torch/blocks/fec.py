"""Convolutional FEC: encoder + streaming Viterbi decoder, the self-
synchronizing scrambler, and the extended Golay (24,12,8) and Hamming
(2^m−1) block codes (the JAX package's ``blocks/fec.py``). Default code: the
ubiquitous K=7, rate-1/2, polynomials 0o171/0o133 (Voyager/CCSDS/802.11).

Every output is bit for bit the JAX package's. Its ``lax.scan`` recurrences
run here in forms with few launches:

- ConvEncoder and Descrambler are feed-forward over GF(2): each output reads
  a window of the input and of the carried register, so one pass over
  ``unfold`` windows computes a whole block.
- Scrambler feeds back its own outputs (a GF(2) IIR). Within a chunk of
  ``_CHUNK`` bits it is affine, y = (H·b + S·s) mod 2 with host-built H and
  S; the register entering each chunk follows s' = M·s ⊕ z, solved for all
  chunks at once by log-depth doubling over host-built powers of M.
- ViterbiDecoder's add-compare-select is serial: one iteration of four
  device ops per received symbol pair (add, min with its index, min,
  subtract), the branch metrics of every pair computed before the loop.
  Ties go to the first candidate, as ``jnp.argmin``'s do. The
  traceback is a composition of maps over the states, computed by pointer
  doubling in ⌈log2(traceback + n)⌉ gathers.
- Golay and Hamming are float32 matmuls mod 2 in full float32 and table
  gathers.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache
from itertools import combinations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.cuda_kernels import device_constant, frozen
from ..ops.precision import check_f32_matmul


@lru_cache(maxsize=32)
def _tables(k: int, polys: tuple[int, int]):
    """Precompute trellis tables (host NumPy, cached per (k, polys), read-only).

    state = last k-1 input bits (newest at LSB). Input bit b moves
    s -> ((s<<1)|b) & mask; the encoder register is ((s<<1)|b) over k bits.
    Returns (enc_out[state, bit, 2], pred[state, 2], pred_bit_is: the input
    bit on entering ``state`` is state&1).
    """
    ns = 1 << (k - 1)
    enc_out = np.zeros((ns, 2, 2), np.int32)
    for s in range(ns):
        for b in (0, 1):
            reg = ((s << 1) | b) & ((1 << k) - 1)
            for j, g in enumerate(polys):
                enc_out[s, b, j] = bin(reg & g).count("1") & 1
    # predecessors of next-state t: the two states s with ((s<<1)|b)&mask == t
    pred = np.zeros((ns, 2), np.int32)
    for t in range(ns):
        base = t >> 1
        pred[t, 0] = base            # previous MSB was 0
        pred[t, 1] = base | (ns >> 1)  # previous MSB was 1
        # NOTE: both predecessors reach t with the SAME input bit b = t&1
    return frozen(enc_out, pred)


@lru_cache(maxsize=32)
def _branch_outputs(k: int, polys: tuple[int, int]) -> np.ndarray:
    """br[t, j] = enc_out[pred[t, j], t & 1], float32 [ns, 2, 2]: the coded
    pair on the branch into state t from its predecessor j."""
    enc_out, pred = _tables(k, polys)
    t_idx = np.arange(1 << (k - 1))
    return frozen(np.stack([enc_out[pred[:, 0], t_idx & 1],
                            enc_out[pred[:, 1], t_idx & 1]], axis=1)
                  .astype(np.float32))


def _register_bits(state: torch.Tensor, width: int) -> torch.Tensor:
    """The low ``width`` bits of a 0-d int32 register, oldest (bit width−1)
    first."""
    shifts = device_constant(_desc_range(width), state.device)
    return ((state >> shifts) & 1).to(torch.int32)


@lru_cache(maxsize=64)
def _desc_range(width: int) -> np.ndarray:
    return frozen(np.arange(width - 1, -1, -1, dtype=np.int32))


def _window_value(ext: torch.Tensor, width: int) -> torch.Tensor:
    """Every ``width``-bit window of a 0/1 int32 stream as an integer, the
    window's last bit at the LSB: [len(ext) − width + 1]."""
    pow2 = device_constant(_pow2_desc(width), ext.device)
    return (ext.unfold(0, width, 1) * pow2).sum(-1, dtype=torch.int32)


@lru_cache(maxsize=64)
def _pow2_desc(width: int) -> np.ndarray:
    return frozen((1 << np.arange(width - 1, -1, -1)).astype(np.int32))


def _parity(v: torch.Tensor) -> torch.Tensor:
    """popcount & 1 over <= 30 bits (the JAX package's fold)."""
    for s in (16, 8, 4, 2, 1):
        v = v ^ (v >> s)
    return v & 1


@register_block("ConvEncoder")
class ConvEncoder(Block):
    """Rate-1/2 convolutional encoder: 1 bit in → 2 coded bits out
    (interleaved y0,y1). State carries the shift register across steps.
    Each output pair is a gather of the k-bit register, read from windows of
    the carried k−1 bits followed by the step's bits."""

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="int32"),)
    constraint = Setting(default=7, kind="static", limits=(3, 12))
    poly0 = Setting(default=0o171, kind="static")
    poly1 = Setting(default=0o133, kind="static")

    @property
    def ratio(self):
        return Fraction(2, 1)

    def _k(self):
        return int(self.settings.get("constraint"))

    def init_state(self, ctx):
        return torch.zeros((), dtype=torch.int32, device=ctx.device)

    def apply(self, state, ins, ctx):
        bits = ins["in"].to(torch.int32)
        k = self._k()
        enc_out, _ = _tables(k, (int(self.settings.get("poly0")),
                                 int(self.settings.get("poly1"))))
        table = device_constant(enc_out, bits.device).reshape(-1, 2)
        reg = _window_value(torch.cat([_register_bits(state, k - 1), bits]), k)
        s_end = reg[-1] & ((1 << (k - 1)) - 1)
        return s_end, {"out": table[reg.long()].reshape(-1)}


@register_block("ViterbiDecoder")
class ViterbiDecoder(Block):
    """Streaming Viterbi decoder for the rate-1/2 code (hard bits or
    soft confidences via ``soft=True``).

    Consumes interleaved coded bits (2 per message bit), emits decoded bits
    with ``traceback`` bits of latency: each step decodes its symbols with a
    truncated traceback into the previous step's tail (path metrics AND the
    last ``traceback`` decision columns are carried state), so the stream is
    seamless across scheduler blocks.
    """

    IN = (Port("in"),)   # int32 hard bits, or float32 soft values in [0,1]
    OUT = (Port("out", dtype="int32"),)
    constraint = Setting(default=7, kind="static", limits=(3, 10))
    poly0 = Setting(default=0o171, kind="static")
    poly1 = Setting(default=0o133, kind="static")
    traceback = Setting(default=64, kind="static", limits=(8, 512))
    soft = Setting(default=False, kind="static",
                   description="input is float32 confidence in [0,1] "
                               "(0=strong 0, 1=strong 1) instead of hard bits")

    @property
    def ratio(self):
        return Fraction(1, 2)

    @property
    def alignment(self):
        return 2

    def _cfg(self):
        return (int(self.settings.get("constraint")),
                (int(self.settings.get("poly0")),
                 int(self.settings.get("poly1"))))

    def init_state(self, ctx):
        k, _ = self._cfg()
        ns = 1 << (k - 1)
        tb = int(self.settings.get("traceback"))
        m0 = torch.full((ns,), 1e6, dtype=torch.float32, device=ctx.device)
        m0[0] = 0.0
        return {"metrics": m0,
                "tail_dec": torch.zeros((tb, ns), dtype=torch.int32,
                                        device=ctx.device)}

    def apply(self, state, ins, ctx):
        k, polys = self._cfg()
        ns = 1 << (k - 1)
        tb = int(self.settings.get("traceback"))
        dev = ins["in"].device
        br = device_constant(_branch_outputs(k, polys), dev)

        r = ins["in"].to(torch.float32).reshape(-1, 2)      # [n, 2]
        n = r.shape[0]
        # branch metrics of every symbol: distance to each entering branch
        d = (br[None] - r[:, None, None, :]).abs()          # [n, ns, 2, 2]
        bm = d[..., 0] + d[..., 1]                           # [n, ns, 2]
        # state t = 2h + b enters from pred[t, j] = h + j·ns/2: the gather of
        # the metrics is the broadcast view m.view(2, ns/2).T over b
        bm = bm.view(n, ns // 2, 2, 2)
        m = state["metrics"]
        m2 = torch.empty(ns, dtype=torch.float32, device=dev)
        decs = torch.empty((n, ns), dtype=torch.int64, device=dev)
        for i in range(n):
            cand = bm[i] + m.view(2, ns // 2).t().unsqueeze(1)
            # the minimum and its first index: jnp.argmin's rule on ties
            torch.min(cand.view(ns, 2), -1, out=(m2, decs[i]))
            m = m2 - m2.min()

        all_dec = torch.cat([state["tail_dec"], decs.to(torch.int32)], 0)
        bits = _traceback(all_dec, torch.argmin(m), n)
        # rows ≥ tb from the end of the traceback are converged: that is
        # exactly the OLDEST n rows — emit them (stream latency = tb bits;
        # the first tb output bits of a fresh stream are startup garbage,
        # like a filter's group-delay transient)
        return ({"metrics": m, "tail_dec": all_dec[all_dec.shape[0] - tb:]},
                {"out": bits})


def _traceback(all_dec: torch.Tensor, s_end: torch.Tensor, n: int
               ) -> torch.Tensor:
    """The decoded bits of the first ``n`` rows of ``all_dec`` [rows, ns]:
    row i's state s_i has s_last = ``s_end`` and s_{i−1} = f_i(s_i), f_i(s) =
    pred[s, all_dec[i, s]] = s >> 1 | all_dec[i, s]·ns/2; its bit is s_i & 1.
    Q_i = f_{i+1} ∘ … ∘ f_last comes from pointer doubling: Q_i ← Q_i ∘
    Q_{i+d} for d = 1, 2, 4, …, identity past the last row."""
    rows, ns = all_dec.shape
    ident = torch.arange(ns, device=all_dec.device)
    f = (ident >> 1) | (all_dec.long() * (ns // 2))      # [rows, ns]
    q = torch.cat([f[1:], ident[None]], 0)
    d = 1
    while d < rows:
        later = torch.cat([q[d:], ident.expand(d, ns)], 0)
        q = torch.gather(q, 1, later)
        d *= 2
    return (q[:n].index_select(1, s_end.view(1))[:, 0] & 1).to(torch.int32)


# Scrambler chunk: outputs within a chunk are one affine map of its inputs
# and of the register entering it
_CHUNK = 256


@lru_cache(maxsize=32)
def _scrambler_affine(taps: int, length: int, chunk: int, n_chunks: int):
    """The Scrambler's recurrence y[n] = b[n] ⊕ parity(taps & reg_n), reg
    shifting in y, over one chunk of ``chunk`` bits as float32 0/1 matrices:
    H [chunk, chunk] (y from the chunk's bits, zero register), S [chunk,
    length] (y from the register's bits, bit j at column j, zero input), and
    the powers M^d, d = 1, 2, 4, … < n_chunks, of the chunk's register
    transition M [length, length] (register bit j after the chunk is
    y[chunk − 1 − j]), each transposed for a row-vector product."""
    t = [(taps >> j) & 1 for j in range(length)]

    def run(b, reg_bits):
        y = np.zeros(chunk, np.int64)
        hist = list(reg_bits)                  # hist[j] = register bit j
        for i in range(chunk):
            y[i] = (b[i] + sum(t[j] * hist[j] for j in range(length))) & 1
            hist = [int(y[i])] + hist[:-1]
        return y

    zeros = np.zeros(length, np.int64)
    h = run(np.eye(1, chunk, 0, dtype=np.int64)[0], zeros)
    rows = np.arange(chunk)[:, None] - np.arange(chunk)[None, :]
    H = np.where(rows >= 0, h[np.maximum(rows, 0)], 0)
    S = np.stack([run(np.zeros(chunk, np.int64), np.eye(length, dtype=np.int64)[j])
                  for j in range(length)], axis=1)
    M = S[chunk - 1 - np.arange(length)]       # [length, length]
    powers, p, d = [], M, 1
    while d < n_chunks:
        powers.append(p.T.astype(np.float32))
        p, d = (p @ p) % 2, 2 * d
    return frozen(H.T.astype(np.float32), S.T.astype(np.float32), *powers)


@register_block("Scrambler")
class Scrambler(Block):
    """Multiplicative (self-synchronizing) LFSR scrambler over bits
    (≈ GNU Radio scrambler_bb): out[n] = in[n] ⊕ parity(mask & reg);
    reg shifts in out[n]. Default CCSDS/V.35-style x^7+x^4+1 (mask 0o221→
    taps at 7,4 ⇒ mask 0x48, length 7)."""

    IN = (Port("in", dtype="int32"),)
    OUT = (Port("out", dtype="int32"),)
    mask = Setting(default=0x48, kind="static",
                   description="feedback tap mask over the register")
    length = Setting(default=7, kind="static", limits=(2, 30))
    seed = Setting(default=0x7F, kind="static")

    _DESCRAMBLE = False

    def init_state(self, ctx):
        return torch.tensor(int(self.settings.get("seed")), dtype=torch.int32,
                            device=ctx.device)

    def apply(self, state, ins, ctx):
        bits = ins["in"].to(torch.int32)
        mask = int(self.settings.get("mask"))
        length = int(self.settings.get("length"))
        regmask = (1 << length) - 1
        hist = _register_bits(state, length)
        # the register is masked to ``length`` bits after the first shift: a
        # carried value wider than that (a wide seed) reaches step 0 alone
        wide = mask & ~regmask
        if self._DESCRAMBLE:
            ext = torch.cat([hist, bits])
            taps = device_constant(_tap_vector(mask & regmask, length),
                                   bits.device)
            fb = (ext[:-1].unfold(0, length, 1) * taps).sum(
                -1, dtype=torch.int32) & 1
            y = bits ^ fb
            if wide:
                y = torch.cat([y[:1] ^ _parity(state & wide), y[1:]])
        else:
            if wide:
                bits = torch.cat([bits[:1] ^ _parity(state & wide), bits[1:]])
            y = self._scramble(bits, hist, mask & regmask, length)
            ext = torch.cat([hist, y])
        reg_end = _window_value(ext[ext.shape[0] - length:], length)[0]
        return reg_end, {"out": y}

    @staticmethod
    def _scramble(bits, hist, taps, length):
        """y[n] = b[n] ⊕ parity(taps & reg_n), reg shifting in y, in chunks:
        Z = B·Hᵀ (zero register), the register entering every chunk by
        doubling over s_{c+1} = M·s_c ⊕ z_c, then Y = Z ⊕ s·Sᵀ (mod 2)."""
        check_f32_matmul("Scrambler")
        n = bits.shape[0]
        chunk = _CHUNK
        nc = -(-n // chunk)
        ht, st, *powers = _scrambler_affine(taps, length, chunk, nc)
        dev = bits.device
        b = F.pad(bits.to(torch.float32), (0, nc * chunk - n)).view(nc, chunk)
        z = torch.remainder(b @ device_constant(ht, dev), 2.0)
        # w_0 = the carried register, w_c = the zero-register tail of chunk
        # c − 1 (register bit j = y[chunk − 1 − j]); prefix over c
        tail = z[:-1, chunk - length:].flip(-1)
        w = torch.cat([hist.flip(0).to(torch.float32)[None], tail], 0)
        d = 1
        for p in powers:
            w = torch.cat([w[:d], torch.remainder(
                w[d:] + w[:-d] @ device_constant(p, dev), 2.0)], 0)
            d *= 2
        y = torch.remainder(z + w @ device_constant(st, dev), 2.0)
        return y.reshape(-1)[:n].to(torch.int32)


@lru_cache(maxsize=64)
def _tap_vector(taps: int, length: int) -> np.ndarray:
    """taps over a window of ``length`` past bits, oldest first (register bit
    length − 1 first)."""
    return frozen(((taps >> np.arange(length - 1, -1, -1)) & 1)
                  .astype(np.int32))


@register_block("Descrambler")
class Descrambler(Scrambler):
    """Inverse of :class:`Scrambler`; self-synchronizes after ``length`` bits
    regardless of seed (≈ GNU Radio descrambler_bb)."""

    _DESCRAMBLE = True


# --------------------------------------------------------- Golay (24,12,8)

def _golay_B() -> np.ndarray:
    """The 12x12 B of G=[I|B] for the extended binary Golay code —
    quadratic-residue construction: b_ij = [(i+j) mod 11 in {0} u QR(11)]
    for i,j < 11, ones border, zero corner.  Symmetric; verified d_min = 8
    by full enumeration in the tests."""
    qr0 = {0, 1, 3, 4, 5, 9}
    B = np.zeros((12, 12), np.uint8)
    for i in range(11):
        for j in range(11):
            B[i, j] = 1 if (i + j) % 11 in qr0 else 0
    B[11, :11] = 1
    B[:11, 11] = 1
    return B


_GOLAY_B = _golay_B()
_GOLAY_G = np.concatenate([np.eye(12, dtype=np.uint8), _GOLAY_B], axis=1)
# G = [I|B], B symmetric => H = [B|I] and syndrome s = r H^T = r1 B + r2
_GOLAY_H = np.concatenate([_GOLAY_B, np.eye(12, dtype=np.uint8)], axis=1)
_GOLAY_G_F32 = frozen(_GOLAY_G.astype(np.float32))
_GOLAY_HT_F32 = frozen(np.ascontiguousarray(_GOLAY_H.T, np.float32))
_POW2_12 = frozen((1 << np.arange(12)).astype(np.float32))


@lru_cache(maxsize=1)
def _golay_syndrome_table() -> np.ndarray:
    """[4096, 24] coset-leader error patterns for every weight <= 3 error
    (2325 correctable syndromes); uncorrectable syndromes map to zeros —
    the decoder then reports detected-uncorrectable via the recomputed
    syndrome. Built once, read-only."""
    table = np.zeros((4096, 24), np.uint8)
    filled = np.zeros(4096, bool)
    idx24 = np.arange(24)
    for weight in (1, 2, 3):
        for pos in combinations(idx24, weight):
            e = np.zeros(24, np.uint8)
            e[list(pos)] = 1
            s = int(((e @ _GOLAY_H.T) % 2 @ (1 << np.arange(12))).sum())
            if not filled[s]:
                filled[s] = True
                table[s] = e
    return frozen(table)


@lru_cache(maxsize=1)
def _golay_table_f32() -> np.ndarray:
    return frozen(_golay_syndrome_table().astype(np.float32))


def golay_encode(msg_bits: np.ndarray) -> np.ndarray:
    """[..., 12k] info bits → [..., 24k] systematic extended-Golay bits."""
    m = np.asarray(msg_bits, np.uint8)
    frames = m.reshape(-1, 12)
    return ((frames @ _GOLAY_G) % 2).astype(np.uint8).reshape(
        m.shape[:-1] + (m.shape[-1] // 12 * 24,))


def golay_decode(code_bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[..., 24k] received bits → ([..., 12k] corrected info bits,
    per-frame corrected-error counts; -1 marks detected-uncorrectable)."""
    table = _golay_syndrome_table()
    r = np.asarray(code_bits, np.uint8).reshape(-1, 24)
    syn = ((r @ _GOLAY_H.T) % 2 @ (1 << np.arange(12))).astype(np.int64)
    err = table[syn]
    fixed = r ^ err
    ok = ((fixed @ _GOLAY_H.T) % 2).sum(axis=1) == 0
    n_err = np.where(ok, err.sum(axis=1), -1).astype(np.int32)
    return fixed[:, :12].reshape(np.asarray(code_bits).shape[:-1] + (-1,)), \
        n_err


@register_block("GolayEncoder")
class GolayEncoder(Block):
    """Extended Golay (24,12,8) encoder: 12 info bits → 24 coded bits per
    frame (systematic; the GF(2) matmul runs on device like LdpcEncoder)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)

    @property
    def ratio(self):
        return Fraction(2, 1)

    @property
    def alignment(self):
        return 12

    def apply(self, state, ins, ctx):
        check_f32_matmul("GolayEncoder")
        x = ins["in"]
        frames = x.reshape(x.shape[:-1] + (-1, 12))
        coded = torch.remainder(frames @ device_constant(_GOLAY_G_F32,
                                                         x.device), 2.0)
        return state, {"out": coded.reshape(x.shape[:-1]
                                            + (x.shape[-1] // 12 * 24,))}


@register_block("GolayDecoder")
class GolayDecoder(Block):
    """Extended Golay (24,12,8) bounded-distance decoder, fully on device:
    syndrome = GF(2) matmul, then ONE gather into the precomputed
    [4096, 24] coset-leader table corrects any <= 3-bit error pattern.
    Weight-4 patterns are detected-uncorrectable (emitted as-is; the
    host-side :func:`golay_decode` additionally reports them)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._table = _golay_table_f32()

    @property
    def ratio(self):
        return Fraction(1, 2)

    @property
    def alignment(self):
        return 24

    def apply(self, state, ins, ctx):
        check_f32_matmul("GolayDecoder")
        x = ins["in"]
        dev = x.device
        r = x.reshape(x.shape[:-1] + (-1, 24))
        syn = (torch.remainder(r @ device_constant(_GOLAY_HT_F32, dev), 2.0)
               @ device_constant(_POW2_12, dev)).to(torch.int32)
        # a gather clamps its index, as jnp indexing does
        err = device_constant(self._table, dev)[syn.clamp(max=4095).long()]
        fixed = torch.remainder(r + err, 2.0)
        out = fixed[..., :12]
        return state, {"out": out.reshape(x.shape[:-1]
                                          + (x.shape[-1] // 24 * 12,))}


# ------------------------------------------------------- Hamming (2^m-1)

def _hamming_matrices(m: int) -> tuple[np.ndarray, np.ndarray]:
    """Systematic (n=2^m-1, k=n-m) Hamming G=[I|P], H=[P^T|I]; H's columns
    enumerate every nonzero m-bit pattern so the syndrome names the error."""
    n = (1 << m) - 1
    cols = np.asarray([[(v >> b) & 1 for b in range(m)]
                       for v in range(1, n + 1)], np.uint8)   # [n, m]
    weights = cols.sum(axis=1)
    data_cols = np.flatnonzero(weights >= 2)     # k columns → data positions
    par_cols = np.flatnonzero(weights == 1)      # m unit columns → parity
    P = cols[data_cols]                           # [k, m]
    order = np.concatenate([data_cols, par_cols])
    return P, order                               # order maps sys → H column


def hamming_encode(msg_bits: np.ndarray, m: int = 3) -> np.ndarray:
    """[..., k·f] info bits → [..., n·f] systematic Hamming bits."""
    P, _ = _hamming_matrices(m)
    k = P.shape[0]
    x = np.asarray(msg_bits, np.uint8).reshape(-1, k)
    par = (x @ P) % 2
    out = np.concatenate([x, par], axis=1)
    return out.reshape(np.asarray(msg_bits).shape[:-1] + (-1,))


def hamming_decode(code_bits: np.ndarray, m: int = 3
                   ) -> tuple[np.ndarray, np.ndarray]:
    """[..., n·f] → ([..., k·f] corrected info bits, per-frame flip counts)."""
    P, order = _hamming_matrices(m)
    k = P.shape[0]
    n = (1 << m) - 1
    r = np.asarray(code_bits, np.uint8).reshape(-1, n)
    syn = ((r[:, :k] @ P) + r[:, k:]) % 2
    syn_val = syn @ (1 << np.arange(m))           # H column value of the error
    # map syndrome value v (1..n) back to the systematic position
    colval = np.zeros(n + 1, np.int64)
    for sys_pos, h_col in enumerate(order):
        colval[h_col + 1] = sys_pos
    err_pos = colval[syn_val]
    fixed = r.copy()
    has_err = syn_val > 0
    fixed[np.arange(len(r)), err_pos] ^= has_err.astype(np.uint8)
    return fixed[:, :k].reshape(np.asarray(code_bits).shape[:-1] + (-1,)), \
        has_err.astype(np.int32)


@register_block("HammingEncoder")
class HammingEncoder(Block):
    """Systematic Hamming (2^m−1, 2^m−1−m) encoder on device (GF(2)
    matmul); m=3 → (7,4), m=4 → (15,11)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    m = Setting(default=3, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        P, _ = _hamming_matrices(int(self.settings.get("m")))
        self._P = frozen(P.astype(np.float32))

    @property
    def ratio(self):
        n = (1 << int(self.settings.get("m"))) - 1
        return Fraction(n, self._P.shape[0])

    @property
    def alignment(self):
        return self._P.shape[0]

    def apply(self, state, ins, ctx):
        check_f32_matmul("HammingEncoder")
        x = ins["in"]
        k = self._P.shape[0]
        frames = x.reshape(x.shape[:-1] + (-1, k))
        par = torch.remainder(frames @ device_constant(self._P, x.device), 2.0)
        out = torch.cat([frames, par], -1)
        n = k + self._P.shape[1]
        return state, {"out": out.reshape(x.shape[:-1]
                                          + (x.shape[-1] // k * n,))}


@register_block("HammingDecoder")
class HammingDecoder(Block):
    """Hamming single-error-correcting decoder on device: syndrome matmul +
    one scatterless correction via a one-hot mask (no dynamic shapes)."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    m = Setting(default=3, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        m = int(self.settings.get("m"))
        P, order = _hamming_matrices(m)
        self._P = frozen(P.astype(np.float32))
        n = (1 << m) - 1
        colval = np.zeros(n + 1, np.int64)
        for sys_pos, h_col in enumerate(order):
            colval[h_col + 1] = sys_pos
        self._colval = frozen(colval)
        self._pow2 = frozen((1 << np.arange(m)).astype(np.float32))
        self._n = n

    @property
    def ratio(self):
        return Fraction(self._P.shape[0], self._n)

    @property
    def alignment(self):
        return self._n

    def apply(self, state, ins, ctx):
        check_f32_matmul("HammingDecoder")
        x = ins["in"]
        dev = x.device
        k, n = self._P.shape[0], self._n
        r = x.reshape(x.shape[:-1] + (-1, n))
        par = torch.remainder(r[..., :k] @ device_constant(self._P, dev)
                              + r[..., k:], 2.0)
        syn_val = (par @ device_constant(self._pow2, dev)).to(torch.int32)
        # a gather clamps its index, as jnp indexing does
        err_pos = device_constant(self._colval, dev)[syn_val.clamp(max=n).long()]
        flip = (F.one_hot(err_pos, n).to(x.dtype)
                * (syn_val > 0)[..., None].to(x.dtype))
        fixed = torch.remainder(r + flip, 2.0)
        return state, {"out": fixed[..., :k].reshape(
            x.shape[:-1] + (x.shape[-1] // n * k,))}
