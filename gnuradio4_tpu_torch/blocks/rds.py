"""RDS (Radio Data System, IEC 62106) coding layer + decoder sink.

Beyond-reference model family (the reference has no RDS; GNU Radio users get
it from gr-rds): completes the FM receiver story — the 57 kHz subcarrier of
the FM multiplex carries differentially-encoded, biphase-modulated 1187.5 bps
data in 104-bit groups of four 26-bit blocks (16 data + 10 check bits,
shortened cyclic code with per-block offset words).

Device path: the existing chain recovers half-symbols
(FreqXlatingFir 57 kHz → CostasLoop(order=2) → MMSymbolSync); the
:class:`RdsDecoder` sink does the host-side bit/block/group layer —
pairing-parity and polarity ambiguities are resolved by the differential code
and by trying both half-symbol phases against block sync.

The encode helpers make this a transmit-capable implementation too (used by
the tests to synthesize a full multiplex from group data).
"""

from __future__ import annotations

import numpy as np

from ..core.block import Block, Port, SinkBlock
from ..core.registry import register_block
from ..core.settings import Setting

# generator g(x) = x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1
_G = 0x5B9
OFFSET_A, OFFSET_B, OFFSET_C, OFFSET_Cp, OFFSET_D = (
    0x0FC, 0x198, 0x168, 0x350, 0x1B4)
_OFFSET_NAME = {OFFSET_A: "A", OFFSET_B: "B", OFFSET_C: "C",
                OFFSET_Cp: "C'", OFFSET_D: "D"}


def rds_checkword(data16: int) -> int:
    """10-bit checkword: remainder of m(x)·x^10 mod g(x)."""
    reg = (data16 & 0xFFFF) << 10
    for i in range(25, 9, -1):
        if reg & (1 << i):
            reg ^= _G << (i - 10)
    return reg & 0x3FF


def encode_block(data16: int, offset: int) -> int:
    """26-bit block: data · 2^10 | (checkword ⊕ offset word)."""
    return ((data16 & 0xFFFF) << 10) | (rds_checkword(data16) ^ offset)


def block_syndrome(block26: int) -> int:
    """Syndrome of a received 26-bit block — equals the offset word when the
    block is error-free (the code part cancels)."""
    reg = block26 & 0x3FFFFFF
    for i in range(25, 9, -1):
        if reg & (1 << i):
            reg ^= _G << (i - 10)
    return reg & 0x3FF


def encode_group(b1: int, b2: int, b3: int, b4: int,
                 *, version_b: bool = False) -> list[int]:
    """One 104-bit group as a list of bits (offsets A,B,C|C',D)."""
    offs = (OFFSET_A, OFFSET_B, OFFSET_Cp if version_b else OFFSET_C, OFFSET_D)
    bits: list[int] = []
    for data, off in zip((b1, b2, b3, b4), offs):
        blk = encode_block(data, off)
        bits.extend((blk >> (25 - i)) & 1 for i in range(26))
    return bits


def make_0a_groups(pi: int, pty: int, ps: str) -> list[list[int]]:
    """Four 0A groups carrying the 8-char programme-service name."""
    ps = (ps + " " * 8)[:8]
    groups = []
    for addr in range(4):
        b2 = (0x0 << 12) | (0 << 11) | (0 << 10) | ((pty & 0x1F) << 5) | addr
        b4 = (ord(ps[2 * addr]) << 8) | ord(ps[2 * addr + 1])
        groups.append(encode_group(pi, b2, 0xE0E0, b4))   # C = AF filler
    return groups


def make_2a_groups(pi: int, pty: int, text: str) -> list[list[int]]:
    """Radiotext (2A) groups, 4 chars each, padded with 0x0D terminator."""
    text = text[:64]
    if len(text) % 4:
        text += "\r" + " " * ((4 - (len(text) + 1) % 4) % 4)
    groups = []
    for addr in range(len(text) // 4):
        seg = text[4 * addr:4 * addr + 4]
        b2 = (0x2 << 12) | ((pty & 0x1F) << 5) | (addr & 0xF)
        b3 = (ord(seg[0]) << 8) | ord(seg[1])
        b4 = (ord(seg[2]) << 8) | ord(seg[3])
        groups.append(encode_group(pi, b2, b3, b4))
    return groups


def differential_encode(bits: np.ndarray) -> np.ndarray:
    """d[n] = b[n] ⊕ d[n−1] (the RDS differential encoder)."""
    out = np.zeros(len(bits), np.uint8)
    prev = 0
    for n, b in enumerate(np.asarray(bits, np.uint8)):
        prev = int(b) ^ prev
        out[n] = prev
    return out


def biphase_halves(diff_bits: np.ndarray) -> np.ndarray:
    """Biphase (Manchester) coding: bit 1 → (+1,−1), bit 0 → (−1,+1),
    one pair of half-symbols per data bit (2×1187.5 baud)."""
    d = np.asarray(diff_bits, np.uint8)
    first = np.where(d == 1, 1.0, -1.0)
    return np.stack([first, -first], axis=-1).reshape(-1).astype(np.float32)


def modulate_mpx(groups: list[list[int]], *, fs: float = 228000.0,
                 carrier_hz: float = 57000.0, phase: float = 0.0,
                 amplitude: float = 1.0) -> np.ndarray:
    """Synthesize the 57 kHz DSB-SC RDS component of an FM multiplex from
    group bit lists (test/transmit stimulus; rectangular half-symbol pulses —
    the receiver's channel filter does the shaping)."""
    bits = np.concatenate([np.asarray(g, np.uint8) for g in groups])
    halves = biphase_halves(differential_encode(bits))
    sps = fs / (2 * 1187.5)
    if abs(sps - round(sps)) > 1e-9:
        raise ValueError(f"fs={fs} is not an integer multiple of 2375 Hz")
    wave = np.repeat(halves, int(round(sps)))
    n = np.arange(len(wave), dtype=np.float64)
    carrier = np.cos(2 * np.pi * carrier_hz / fs * n + phase)
    return (amplitude * wave * carrier).astype(np.float32)


def _classify(syn: int) -> str | None:
    return _OFFSET_NAME.get(syn)


def decode_bits(data_bits: np.ndarray) -> list[tuple[int, int, int, int, bool]]:
    """Block-sync + group assembly over a differentialy-decoded bit array.

    Returns [(b1, b2, b3, b4, version_b), …] for every group whose four
    blocks all pass the syndrome check at 26-bit spacing.
    """
    bits = np.asarray(data_bits, np.uint8)
    n = len(bits)
    groups = []
    pos = 0
    while pos + 104 <= n:
        words = [int("".join(map(str, bits[pos + 26 * k:pos + 26 * k + 26])), 2)
                 for k in range(4)]
        names = [_classify(block_syndrome(w)) for w in words]
        if (names[0] == "A" and names[1] == "B" and names[2] in ("C", "C'")
                and names[3] == "D"):
            groups.append(tuple((w >> 10) & 0xFFFF for w in words)
                          + (names[2] == "C'",))
            pos += 104
        else:
            pos += 1
    return groups


@register_block("RdsDecoder")
class RdsDecoder(SinkBlock):
    """RDS bit/block/group decoder sink.

    Feed it the recovered half-symbol stream (one sample per biphase half,
    2375 Hz — e.g. MMSymbolSync output; real part is used). It resolves the
    half-symbol pairing phase and carrier polarity itself (differential code
    + block-sync search over both pairings) and accumulates:

    - ``pi`` — programme identification (majority vote)
    - ``pty`` — programme type
    - ``ps`` — 8-char programme service name (from 0A/0B groups)
    - ``radiotext`` — 2A radiotext
    - ``groups`` — every (b1, b2, b3, b4, version_b) tuple seen
    """

    IN = (Port("in"),)
    max_buffer_bits = Setting(default=1 << 20, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._halves: list[np.ndarray] = []
        self.groups: list[tuple] = []
        self._ps = bytearray(b" " * 8)
        self._rt = bytearray(b" " * 64)
        self._pi_votes: dict[int, int] = {}
        self.pty: int | None = None
        self._pending = 0

    # -- stream side -----------------------------------------------------------
    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid > 0:
            x = np.asarray(arrays["in"][..., :n_valid])
            self._halves.append(np.real(x).astype(np.float64).reshape(-1))
            self._pending += n_valid
            # live updates: a full re-decode costs microseconds at 2375 Hz
            if self._pending >= 2048:
                self._pending = 0
                self._process()

    def stop(self):
        self._process()

    # -- decoding --------------------------------------------------------------
    def _process(self) -> None:
        if not self._halves:
            return
        h = np.concatenate(self._halves)
        cap = int(self.settings.get("max_buffer_bits"))
        if len(h) > 2 * cap:
            h = h[-2 * cap:]
        self._halves = [h]          # bound storage too, not just the window
        best: list[tuple] = []
        for parity in (0, 1):
            hh = h[parity:]
            m = (len(hh) // 2) * 2
            if m < 2:
                continue
            soft = hh[0:m:2] - hh[1:m:2]
            bits = (soft > 0).astype(np.uint8)
            data = bits[1:] ^ bits[:-1]          # differential decode
            got = decode_bits(data)
            if len(got) > len(best):
                best = got
        self.groups = best
        # full re-decode each time → rebuild the votes instead of accumulating
        # (re-counting the same groups skews PI, and last-group-wins would let
        # one late noise group overwrite a pty established by hundreds)
        self._pi_votes = {}
        pty_votes: dict[int, int] = {}
        for b1, b2, b3, b4, _vb in best:
            self._pi_votes[b1] = self._pi_votes.get(b1, 0) + 1
            pty_votes[(b2 >> 5) & 0x1F] = pty_votes.get((b2 >> 5) & 0x1F,
                                                        0) + 1
            self.pty = max(pty_votes.items(), key=lambda kv: kv[1])[0]
            gtype, version_b = (b2 >> 12) & 0xF, bool((b2 >> 11) & 1)
            if gtype == 0:
                addr = b2 & 0x3
                # PS characters ride block 4 in BOTH 0A and 0B (block 3 of a
                # 0B group is the repeated PI code, not text)
                self._ps[2 * addr] = (b4 >> 8) & 0xFF
                self._ps[2 * addr + 1] = b4 & 0xFF
            elif gtype == 2 and not version_b:
                addr = b2 & 0xF
                for k, ch in enumerate(((b3 >> 8) & 0xFF, b3 & 0xFF,
                                        (b4 >> 8) & 0xFF, b4 & 0xFF)):
                    self._rt[4 * addr + k] = ch

    # -- results ---------------------------------------------------------------
    @property
    def pi(self) -> int | None:
        if not self._pi_votes:
            return None
        return max(self._pi_votes.items(), key=lambda kv: kv[1])[0]

    @property
    def ps(self) -> str:
        return self._ps.decode("latin-1")

    @property
    def radiotext(self) -> str:
        return self._rt.decode("latin-1").split("\r")[0].rstrip()


@register_block("RdsSource")
class RdsSource(Block):
    """Transmit-side RDS source: emits the 57 kHz DSB-SC multiplex component
    for a station described by settings (cyclic 0A PS + 2A radiotext group
    schedule). Self-contained — pair with an FM modulator or feed a receiver
    chain directly (examples/rds_receiver.yaml)."""

    OUT = (Port("out", dtype="float32"),)
    FEED = True
    pi = Setting(default=0x52A1, kind="static")
    pty = Setting(default=0, kind="static")
    ps = Setting(default="GR4-TPU ", kind="static")
    radiotext = Setting(default="", kind="static")
    carrier_hz = Setting(default=57000.0, kind="static", unit="Hz")
    sample_rate = Setting(default=228000.0, kind="static", unit="Hz")
    amplitude = Setting(default=1.0, kind="static")
    n_samples = Setting(default=0, kind="static",
                        description="stop after N samples (0 = endless)")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        groups = make_0a_groups(int(self.settings.get("pi")),
                                int(self.settings.get("pty")),
                                str(self.settings.get("ps")))
        rt = str(self.settings.get("radiotext"))
        if rt:
            groups = groups + make_2a_groups(int(self.settings.get("pi")),
                                             int(self.settings.get("pty")), rt)
        # seamless cyclic playback: the differential encoder must return to
        # its start state at the wrap, i.e. the total bit parity must be even
        # — otherwise the same group is corrupted at every loop seam
        if sum(int(b) for g in groups for b in g) % 2:
            groups = groups * 2
        self._wave = modulate_mpx(
            groups, fs=float(self.settings.get("sample_rate")),
            carrier_hz=float(self.settings.get("carrier_hz")),
            amplitude=float(self.settings.get("amplitude")))

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def host_feed(self, n, abs_index):
        idx = (np.arange(abs_index, abs_index + n) % len(self._wave))
        return {"out": self._wave[idx]}, n

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}
