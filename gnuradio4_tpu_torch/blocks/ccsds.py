"""CCSDS telemetry link layer (CCSDS 131.0-B TM synchronization & channel
coding): the framing that ties the FEC stack into the real satellite
standard — used by everything from cubesats to Meteor-M LRPT.

A coded frame is: 32-bit attached sync marker ``1ACFFC1D`` + an
interleaved RS(255,223) codeblock (depth I: 223·I data bytes → 255·I coded
bytes, byte-interleaved so error bursts spread across codewords) passed
through the CCSDS pseudo-randomizer (x⁸+x⁷+x⁵+x³+1, seed all-ones,
restarted each frame, ASM excluded).

:class:`CcsdsFramer` builds transmit frames from payload bytes;
:class:`CcsdsDeframer` is a host sink that hunts the ASM in a bit stream
at any offset and either polarity (BPSK ambiguity), derandomizes,
deinterleaves and RS-decodes; corrected frames accumulate in ``frames``.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from .reed_solomon import ReedSolomon

ASM = 0x1ACFFC1D
ASM_BITS = np.array([(ASM >> (31 - i)) & 1 for i in range(32)], np.uint8)


def randomizer_sequence(n: int) -> np.ndarray:
    """CCSDS pseudo-randomizer bytes: LFSR x⁸+x⁷+x⁵+x³+1, seed 0xFF —
    the standard's bit sequence packed MSB-first."""
    state = 0xFF
    out = np.empty(n, np.uint8)
    for i in range(n):
        byte = 0
        for _ in range(8):
            bit = (state >> 7) & 1
            byte = (byte << 1) | bit
            fb = ((state >> 7) ^ (state >> 6) ^ (state >> 4)
                  ^ (state >> 2)) & 1
            state = ((state << 1) | fb) & 0xFF
        out[i] = byte
    return out


def _bytes_to_bits(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, np.uint8)
    return ((data[:, None] >> (7 - np.arange(8))) & 1).reshape(-1)


def _bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    bits = np.asarray(bits, np.uint8)[: len(bits) // 8 * 8]
    return (bits.reshape(-1, 8) << (7 - np.arange(8))).sum(axis=1) \
        .astype(np.uint8)


class CcsdsCoder:
    """Frame build/parse helpers shared by the blocks."""

    def __init__(self, interleave: int = 1, *, ccsds_field: bool = True):
        self.I = int(interleave)
        if ccsds_field:
            self.rs = ReedSolomon(255, 223, prim_poly=0x187, fcr=112,
                                  prim=11)
        else:
            self.rs = ReedSolomon(255, 223)
        self.data_len = 223 * self.I
        self.code_len = 255 * self.I

    def encode_frame(self, payload: bytes) -> np.ndarray:
        """223·I payload bytes → frame bits (ASM + randomized codeblock)."""
        if len(payload) != self.data_len:
            raise GrError(f"ccsds: payload must be {self.data_len} bytes "
                          f"(got {len(payload)})")
        data = np.frombuffer(bytes(payload), np.uint8)
        # byte interleaving: codeword j takes bytes j, j+I, j+2I, ...
        cws = [self.rs.encode(data[j::self.I]) for j in range(self.I)]
        block = np.empty(self.code_len, np.uint8)
        for j in range(self.I):
            block[j::self.I] = cws[j]
        block ^= randomizer_sequence(self.code_len)
        return np.concatenate([ASM_BITS, _bytes_to_bits(block)])

    def decode_block(self, bits: np.ndarray) -> tuple[bytes, int] | None:
        """Codeblock bits (after the ASM) → (payload bytes, n_corrected),
        or None if any codeword is uncorrectable."""
        block = _bits_to_bytes(bits[: self.code_len * 8])
        if len(block) < self.code_len:
            return None
        block = block ^ randomizer_sequence(self.code_len)
        data = np.empty(self.data_len, np.uint8)
        n_corr = 0
        for j in range(self.I):
            try:
                d, nc = self.rs.decode(block[j::self.I])
            except GrError:
                return None
            data[j::self.I] = d
            n_corr += nc
        return bytes(data), n_corr


@register_block("CcsdsFramer")
class CcsdsFramer(SourceBlock):
    """Plays CCSDS coded frames for a payload byte string (padded to whole
    codeblocks), as a bit stream (float32 0/1)."""

    OUT = (Port("out", dtype="float32"),)
    FEED = True
    interleave = Setting(default=1, kind="static")
    repeat = Setting(default=False, kind="static")

    def __init__(self, payload: bytes | str = b"", name=None, **settings):
        super().__init__(name=name, **settings)
        if isinstance(payload, str):
            payload = payload.encode("utf-8")
        coder = CcsdsCoder(int(self.settings.get("interleave")))
        pad = (-len(payload)) % coder.data_len
        payload = bytes(payload) + b"\x00" * pad
        frames = [coder.encode_frame(payload[i:i + coder.data_len])
                  for i in range(0, len(payload), coder.data_len)] \
            if payload else []
        self._wave = (np.concatenate(frames).astype(np.float32)
                      if frames else np.zeros(0, np.float32))

    def host_feed(self, n, abs_index):
        total = len(self._wave)
        if not total:
            return None
        if bool(self.settings.get("repeat")):
            idx = np.arange(abs_index, abs_index + n) % total
            return {"out": self._wave[idx]}, n
        if abs_index >= total:
            return None
        chunk = self._wave[abs_index:abs_index + n]
        return {"out": chunk}, len(chunk)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("CcsdsDeframer")
class CcsdsDeframer(SinkBlock):
    """Hunts the 1ACFFC1D sync marker in a bit stream (any bit offset,
    either polarity), derandomizes + deinterleaves + RS-decodes each
    codeblock. ``frames`` collects corrected payloads; ``n_corrected``
    counts repaired symbol errors."""

    IN = (Port("in", dtype="float32"),)
    interleave = Setting(default=1, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._coder = CcsdsCoder(int(self.settings.get("interleave")))
        self._bits = np.zeros(0, np.uint8)
        self.frames: list[bytes] = []
        self.n_corrected = 0

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.asarray(arrays["in"][..., :n_valid]).reshape(-1)
        self._bits = np.concatenate([self._bits,
                                     (x > 0.5).astype(np.uint8)])
        self._scan()

    def stop(self):
        self._scan()

    def _scan(self) -> None:
        frame_bits = 32 + self._coder.code_len * 8
        while True:
            n = len(self._bits)
            if n < frame_bits:
                return
            hit = None
            for inv in (0, 1):
                pat = ASM_BITS ^ inv
                # correlate: positions where all 32 bits match
                if n < 32:
                    break
                windows = np.lib.stride_tricks.sliding_window_view(
                    self._bits, 32)
                match = np.flatnonzero((windows == pat).all(axis=1))
                for p in match:
                    if p + frame_bits <= n:
                        hit = (int(p), inv)
                        break
                if hit:
                    break
            if hit is None:
                # keep a tail that could still contain a partial frame
                if n > frame_bits:
                    self._bits = self._bits[n - frame_bits:]
                return
            p, inv = hit
            body = self._bits[p + 32: p + frame_bits] ^ inv
            got = self._coder.decode_block(body)
            if got is not None:
                payload, nc = got
                self.frames.append(payload)
                self.n_corrected += nc
                self._bits = self._bits[p + frame_bits:]
            else:
                self._bits = self._bits[p + 1:]
