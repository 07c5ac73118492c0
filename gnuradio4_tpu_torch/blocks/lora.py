"""LoRa-style CSS (chirp spread spectrum) model family.

The physical layer that makes LoRa famous: a symbol is an up-chirp sweeping
the full bandwidth once per 2^SF samples, cyclically shifted by the symbol
value, so demodulation is `multiply by the conjugate base chirp → FFT →
argmax` — the constant-tone bin IS the symbol. That structure is ideal for
a device: the hot path is one batched FFT over `[n_symbols, 2^SF]` frames
(:class:`CssDemod` is a device block: a multiply, ``torch.fft.fft``, ``abs``
and ``argmax``);
the bit layer (Gray mapping, diagonal interleaver, Hamming FEC, whitening,
length header) is a host sink, per the family pattern (blocks/rtty.py).

Fidelity note: chirp modulation/demodulation, Gray mapping, the SF×(4+CR)
diagonal interleaver, Hamming(4+CR,4) nibble FEC and PRBS-9 whitening follow
the published LoRa PHY structure; sync-word/LoRaWAN byte compatibility with
commercial radios is NOT claimed (the preamble here is N upchirps + 2
downchirps, and framing carries an explicit 1-byte length).
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch

from ..core.block import Block, Port, SinkBlock, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.cuda_kernels import device_constant, frozen

N_PREAMBLE = 8


# -- chirp layer --------------------------------------------------------------

def base_chirp(sf: int, *, down: bool = False) -> np.ndarray:
    """One full-bandwidth chirp at fs = BW (N = 2^SF samples), complex64."""
    n = 1 << sf
    k = np.arange(n, dtype=np.float64)
    phase = 2.0 * np.pi * (k * k / (2.0 * n) - k / 2.0)
    c = np.exp(1j * (-phase if down else phase))
    return c.astype(np.complex64)


def css_symbol(sym: int, sf: int) -> np.ndarray:
    """Up-chirp cyclically shifted by the symbol value."""
    return np.roll(base_chirp(sf), -int(sym))


def css_demod_host(x: np.ndarray, sf: int) -> np.ndarray:
    """Host demod of aligned symbols: dechirp → |FFT| → argmax per frame."""
    n = 1 << sf
    frames = x[: len(x) // n * n].reshape(-1, n)
    dechirped = frames * np.conj(base_chirp(sf))[None, :]
    return np.argmax(np.abs(np.fft.fft(dechirped, axis=-1)), axis=-1)


# -- bit layer ----------------------------------------------------------------

def _gray(v: np.ndarray) -> np.ndarray:
    return v ^ (v >> 1)


def _gray_inv(g: np.ndarray) -> np.ndarray:
    v = np.asarray(g).copy()
    shift = 1
    while (v >> shift).any():
        v = v ^ (v >> shift)
        shift <<= 1
    return v


_H_ENC = None


def hamming_encode(nibbles: np.ndarray, cr: int) -> np.ndarray:
    """Hamming(4+cr, 4) per nibble → codewords as ints (cr ∈ 1..4)."""
    nib = np.asarray(nibbles, np.uint8)
    d = (nib[:, None] >> np.arange(4)) & 1            # [n, 4] LSB-first
    p0 = d[:, 0] ^ d[:, 1] ^ d[:, 2]
    p1 = d[:, 1] ^ d[:, 2] ^ d[:, 3]
    p2 = d[:, 0] ^ d[:, 1] ^ d[:, 3]
    p3 = d[:, 0] ^ d[:, 2] ^ d[:, 3]
    par = np.stack([p0, p1, p2, p3], axis=1)[:, :cr]
    bits = np.concatenate([d, par], axis=1)           # [n, 4+cr]
    return (bits << np.arange(4 + cr)).sum(axis=1).astype(np.uint16)


def hamming_decode(codewords: np.ndarray, cr: int) -> np.ndarray:
    """Decode, correcting single bit errors when cr == 4 (SEC)."""
    cw = np.asarray(codewords, np.uint16)
    bits = ((cw[:, None] >> np.arange(4 + cr)) & 1).astype(np.uint8)
    d = bits[:, :4]
    if cr == 4:
        # syndrome over the 4 parity equations; each maps to one data bit
        p = bits[:, 4:]
        s0 = d[:, 0] ^ d[:, 1] ^ d[:, 2] ^ p[:, 0]
        s1 = d[:, 1] ^ d[:, 2] ^ d[:, 3] ^ p[:, 1]
        s2 = d[:, 0] ^ d[:, 1] ^ d[:, 3] ^ p[:, 2]
        s3 = d[:, 0] ^ d[:, 2] ^ d[:, 3] ^ p[:, 3]
        syn = np.stack([s0, s1, s2, s3], axis=1)
        patterns = {(1, 0, 1, 1): 0, (1, 1, 1, 0): 1,
                    (1, 1, 0, 1): 2, (0, 1, 1, 1): 3}
        for pat, bit in patterns.items():
            hit = np.all(syn == np.array(pat, np.uint8), axis=1)
            d[hit, bit] ^= 1
    return (d << np.arange(4)).sum(axis=1).astype(np.uint8)


def interleave(codewords: np.ndarray, sf: int, cr: int) -> np.ndarray:
    """LoRa diagonal interleaver: a block of SF codewords of (4+cr) bits →
    (4+cr) symbols of SF bits: sym[i] bit j = cw[(i + j) % SF] bit i."""
    cw = np.asarray(codewords, np.uint16).reshape(-1, sf)      # [blk, SF]
    nb = 4 + cr
    bits = ((cw[:, :, None] >> np.arange(nb)) & 1)             # [blk,SF,nb]
    i = np.arange(nb)[:, None]
    j = np.arange(sf)[None, :]
    sym_bits = bits[:, (i + j) % sf, i]                        # [blk,nb,SF]
    return (sym_bits << np.arange(sf)).sum(axis=-1).reshape(-1) \
        .astype(np.uint32)


def deinterleave(symbols: np.ndarray, sf: int, cr: int) -> np.ndarray:
    nb = 4 + cr
    sym = np.asarray(symbols, np.uint32).reshape(-1, nb)       # [blk, nb]
    bits = ((sym[:, :, None] >> np.arange(sf)) & 1)            # [blk,nb,SF]
    i = np.arange(nb)[:, None]
    j = np.arange(sf)[None, :]
    cw_bits = np.zeros((sym.shape[0], sf, nb), np.uint16)
    blk_idx = np.arange(sym.shape[0])[:, None, None]
    cw_bits[blk_idx, (i + j) % sf, i + np.zeros_like(j)] = bits
    return (cw_bits << np.arange(nb)).sum(axis=-1).reshape(-1) \
        .astype(np.uint16)


def whitening_sequence(n: int) -> np.ndarray:
    """PRBS-9 (x^9 + x^5 + 1) byte stream, seed all-ones."""
    state = 0x1FF
    out = np.empty(n, np.uint8)
    for i in range(n):
        byte = 0
        for k in range(8):
            bit = state & 1
            byte |= bit << k
            fb = ((state >> 0) ^ (state >> 4)) & 1
            state = (state >> 1) | (fb << 8)
        out[i] = byte
    return out


def encode_payload(payload: bytes, sf: int, cr: int) -> np.ndarray:
    """length byte + payload → whiten → nibbles → Hamming → pad to SF
    blocks → interleave → Gray-encode → symbol values."""
    data = bytes([len(payload)]) + bytes(payload)
    white = bytes(b ^ w for b, w in
                  zip(data, whitening_sequence(len(data))))
    arr = np.frombuffer(white, np.uint8)
    nibbles = np.empty(2 * len(arr), np.uint8)
    nibbles[0::2] = arr & 0xF
    nibbles[1::2] = arr >> 4
    cw = hamming_encode(nibbles, cr)
    pad = (-len(cw)) % sf
    cw = np.concatenate([cw, np.zeros(pad, np.uint16)])
    return _gray_inv(interleave(cw, sf, cr)).astype(np.uint32)


def decode_payload(symbols: np.ndarray, sf: int, cr: int) -> bytes | None:
    """Inverse of :func:`encode_payload`; None if the length is invalid."""
    symbols = np.asarray(symbols, np.uint32)
    nb = 4 + cr
    symbols = symbols[: len(symbols) // nb * nb]
    if not len(symbols):
        return None
    cw = deinterleave(_gray(symbols), sf, cr)
    nibbles = hamming_decode(cw, cr)
    nibbles = nibbles[: len(nibbles) // 2 * 2]     # pad nibbles drop
    raw = (nibbles[0::2] | (nibbles[1::2] << 4)).astype(np.uint8)
    raw = np.bitwise_xor(raw, whitening_sequence(len(raw)))
    if not len(raw):
        return None
    length = int(raw[0])
    if length + 1 > len(raw):
        return None
    return bytes(raw[1: 1 + length])


def lora_modulate(payload: bytes, *, sf: int = 8, cr: int = 4,
                  amplitude: float = 1.0) -> np.ndarray:
    """Full frame at fs = BW: preamble upchirps + 2 downchirps + payload
    symbols."""
    up = base_chirp(sf)
    parts = [up] * N_PREAMBLE + [base_chirp(sf, down=True)] * 2
    for s in encode_payload(payload, sf, cr):
        parts.append(css_symbol(int(s), sf))
    return (amplitude * np.concatenate(parts)).astype(np.complex64)


# -- blocks -------------------------------------------------------------------

@register_block("LoRaSource")
class LoRaSource(SourceBlock):
    """Plays CSS frames for a payload, with a silence gap before/after."""

    OUT = (Port("out", dtype="complex64"),)
    FEED = True
    sf = Setting(default=8, kind="static")
    cr = Setting(default=4, kind="static")
    gap_symbols = Setting(default=4, kind="static")

    def __init__(self, payload: bytes | str = b"", name=None, **settings):
        super().__init__(name=name, **settings)
        if isinstance(payload, str):              # YAML flows pass text
            payload = payload.encode("utf-8")
        sf = int(self.settings.get("sf"))
        gap = np.zeros((1 << sf) * int(self.settings.get("gap_symbols")),
                       np.complex64)
        frame = lora_modulate(bytes(payload), sf=sf,
                              cr=int(self.settings.get("cr")))
        self._wave = np.concatenate([gap, frame, gap])

    def host_feed(self, n, abs_index):
        if abs_index >= len(self._wave):
            return None
        chunk = self._wave[abs_index:abs_index + n]
        return {"out": chunk}, len(chunk)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("CssDemod")
class CssDemod(Block):
    """Device-side CSS demodulator: reshape the IQ stream into `[n, 2^SF]`
    frames, multiply by the conjugate base up-chirp, batched FFT, argmax →
    one symbol index per frame (float32 stream, ratio 1/2^SF); equal
    magnitudes go to the first bin, as ``jnp.argmax``'s do. Symbol alignment
    is the host decoder's job (it searches all 2^SF phases of the
    preamble)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="float32"),)
    sf = Setting(default=8, kind="static")

    @property
    def ratio(self):
        return Fraction(1, 1 << int(self.settings.get("sf")))

    @property
    def alignment(self):
        return 1 << int(self.settings.get("sf"))

    def apply(self, state, ins, ctx):
        sf = int(self.settings.get("sf"))
        n = 1 << sf
        x = ins["in"]
        frames = x.reshape(x.shape[:-1] + (-1, n))
        dech = frames * device_constant(_conj_chirp(sf), x.device)
        mags = torch.fft.fft(dech, dim=-1).abs()
        return state, {"out": mags.argmax(-1).to(torch.float32)}


@lru_cache(maxsize=8)
def _conj_chirp(sf: int) -> np.ndarray:
    """The conjugate base up-chirp (complex64, read-only)."""
    return frozen(np.conj(base_chirp(sf)))


@register_block("LoRaDecoder")
class LoRaDecoder(SinkBlock):
    """CSS receiver sink for an IQ stream: searches all 2^SF sample phases
    for the preamble (N_PREAMBLE equal up-chirp bins followed by the
    downchirp signature), corrects the common CFO/timing bin offset the
    preamble measures, demodulates the payload symbols and runs the bit
    layer. Decoded payloads accumulate in ``frames``."""

    IN = (Port("in", dtype="complex64"),)
    sf = Setting(default=8, kind="static")
    cr = Setting(default=4, kind="static")
    max_buffer_symbols = Setting(default=4096, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.complex64)
        self._pending = 0
        self.frames: list[bytes] = []

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.asarray(arrays["in"][..., :n_valid], np.complex64).reshape(-1)
        self._buf = np.concatenate([self._buf, x])
        n = 1 << int(self.settings.get("sf"))
        cap = n * int(self.settings.get("max_buffer_symbols"))
        if len(self._buf) > cap:
            self._buf = self._buf[-cap:]
        self._pending += n_valid
        if self._pending >= 16 * n:
            self._pending = 0
            self._decode()

    def stop(self):
        self._decode()

    def _decode(self) -> None:
        sf = int(self.settings.get("sf"))
        cr = int(self.settings.get("cr"))
        n = 1 << sf
        x = self._buf
        if len(x) < (N_PREAMBLE + 3) * n:
            return
        # coarse alignment: dechirped-FFT peak bin of every n-sample window
        # at stride n, for each of a few sub-symbol phases; the preamble is
        # a run of N_PREAMBLE EQUAL bins (CFO/timing shifts them together)
        conj_up = np.conj(base_chirp(sf))
        conj_dn = np.conj(base_chirp(sf, down=True))
        for phase in range(0, n, max(1, n // 16)):
            m = (len(x) - phase) // n
            if m < N_PREAMBLE + 3:
                continue
            frames = x[phase: phase + m * n].reshape(m, n)
            spec_up = np.abs(np.fft.fft(frames * conj_up, axis=-1))
            bins = np.argmax(spec_up, axis=-1)
            pk_up = spec_up[np.arange(m), bins]
            mean_up = spec_up.mean(axis=-1)
            strong = pk_up > 4.0 * np.maximum(mean_up, 1e-12)
            for i in range(m - N_PREAMBLE - 2):
                w = bins[i: i + N_PREAMBLE]
                if not (strong[i: i + N_PREAMBLE].all()
                        and np.all(w == w[0])):
                    continue
                # downchirp signature right after the preamble
                dn = np.abs(np.fft.fft(
                    x[phase + (i + N_PREAMBLE) * n:
                      phase + (i + N_PREAMBLE + 1) * n] * conj_dn))
                if dn.max() < 4.0 * max(dn.mean(), 1e-12):
                    continue
                # candidate frame: demod the payload region; a residual
                # sub-stride misalignment can split the worst phase across
                # bins, so a failed decode just moves on to the next phase
                off = int(w[0])
                start = phase + (i + N_PREAMBLE + 2) * n
                m2 = (len(x) - start) // n
                if m2 <= 0:
                    continue
                fr = x[start: start + m2 * n].reshape(m2, n)
                spec = np.abs(np.fft.fft(fr * conj_up, axis=-1))
                b2 = np.argmax(spec, axis=-1)
                # payload ends where the channel goes quiet (peak collapses)
                pk = spec[np.arange(m2), b2]
                alive = pk > 4.0 * np.maximum(spec.mean(axis=-1), 1e-12)
                end = int(np.argmin(alive)) if not alive.all() else m2
                payload = decode_payload((b2[:end] - off) % n, sf, cr)
                if payload is not None:
                    if payload not in self.frames:
                        self.frames.append(payload)
                    # consume through the decoded frame
                    self._buf = self._buf[start + end * n:]
                    return
                break   # this phase's sync failed to decode; try the next
