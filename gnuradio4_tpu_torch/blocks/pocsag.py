"""POCSAG paging protocol (ITU-R M.584) with BCH(31,21) error correction.

Beyond-reference model family: POCSAG pages ride 32-bit codewords — a flag
bit, 20 data bits, 10 BCH(31,21) check bits and an even-parity bit — in
batches of one frame-sync word + 8 frames × 2 codewords, after a 576-bit
reversal preamble. The address codeword's frame position carries the RIC's
three LSBs; alphanumeric messages pack 7-bit ASCII LSB-first across message
codewords. FSK at 512/1200/2400 bps.

The BCH decode corrects up to two bit errors per codeword via a precomputed
syndrome table — the classic hard-decision bounded-distance decoder.

Device path: `QuadratureDemod` (FSK → NRZ levels) feeds
:class:`PocsagDecoder`, which recovers the bit clock, hunts the sync word,
BCH-corrects every codeword and assembles messages per pager address.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock
from ..core.registry import register_block
from ..core.settings import Setting

_GEN = 0x769                 # BCH(31,21): x^10+x^9+x^8+x^6+x^5+x^3+1
SYNC = 0x7CD215D8
IDLE = 0x7A89C197
_CHARBITS = 7


def _bch_remainder(data21: int) -> int:
    reg = data21 << 10
    for i in range(30, 9, -1):
        if reg & (1 << i):
            reg ^= _GEN << (i - 10)
    return reg & 0x3FF


def encode_codeword(data21: int) -> int:
    """21 data bits → 32-bit codeword (BCH check bits + even parity)."""
    w31 = ((data21 & 0x1FFFFF) << 10) | _bch_remainder(data21)
    parity = bin(w31).count("1") & 1
    return (w31 << 1) | parity


def _syndrome(w31: int) -> int:
    reg = w31 & 0x7FFFFFFF
    for i in range(30, 9, -1):
        if reg & (1 << i):
            reg ^= _GEN << (i - 10)
    return reg & 0x3FF


def _build_syndrome_table() -> dict[int, int]:
    """syndrome → error pattern for all 1- and 2-bit errors of the 31-bit word."""
    table: dict[int, int] = {}
    for i in range(31):
        e = 1 << i
        table.setdefault(_syndrome(e), e)
    for i in range(31):
        for j in range(i + 1, 31):
            e = (1 << i) | (1 << j)
            table.setdefault(_syndrome(e), e)
    return table


_SYNDROMES = _build_syndrome_table()


def correct_codeword(cw32: int) -> tuple[int, int] | None:
    """BCH-correct a received codeword → (data21, n_corrected) or None."""
    w31 = (cw32 >> 1) & 0x7FFFFFFF
    syn = _syndrome(w31)
    if syn != 0:
        e = _SYNDROMES.get(syn)
        if e is None:
            return None
        w31 ^= e
        n = bin(e).count("1")
    else:
        n = 0
    return (w31 >> 10) & 0x1FFFFF, n


def make_address_codeword(ric: int, function: int) -> tuple[int, int]:
    """→ (frame index 0-7, codeword). The RIC's 3 LSBs select the frame."""
    frame = ric & 0x7
    # layout: flag=0, 18 address bits (RIC >> 3), 2 function bits
    data21 = (0 << 20) | (((ric >> 3) & 0x3FFFF) << 2) | (function & 0x3)
    return frame, encode_codeword(data21)


def make_message_codewords(text: str) -> list[int]:
    """Alphanumeric message → codewords (7-bit ASCII, LSB first, 20-bit fields)."""
    bits: list[int] = []
    for ch in text:
        code = ord(ch) & 0x7F
        bits.extend((code >> i) & 1 for i in range(_CHARBITS))   # LSB first
    while len(bits) % 20:
        bits.append(0)
    words = []
    for i in range(0, len(bits), 20):
        field = 0
        for b in bits[i:i + 20]:
            field = (field << 1) | b
        words.append(encode_codeword((1 << 20) | field))          # flag=1
    return words


def encode_transmission(ric: int, function: int, text: str,
                        *, preamble_bits: int = 576) -> np.ndarray:
    """Full POCSAG transmission bits: reversal preamble + sync'd batches."""
    frame, addr_cw = make_address_codeword(ric, function)
    msg_cws = make_message_codewords(text)
    slots: list[int] = []
    slots.extend([IDLE] * (2 * frame))
    slots.append(addr_cw)
    slots.extend(msg_cws)
    while len(slots) % 16:
        slots.append(IDLE)
    bits: list[int] = [(1 - (i & 1)) for i in range(preamble_bits)]  # 1010…
    for batch in range(0, len(slots), 16):
        for w in [SYNC] + slots[batch:batch + 16]:
            bits.extend((w >> (31 - i)) & 1 for i in range(32))
    return np.asarray(bits, np.uint8)


def decode_transmission(bits: np.ndarray) -> list[dict]:
    """Parse a bit stream: sync hunt (≤2 bit errors), batch walk, BCH-correct
    each codeword, assemble per-address alphanumeric messages."""
    bits = np.asarray(bits, np.uint8)
    n = len(bits)
    pages: list[dict] = []
    current: dict | None = None
    corrected = 0

    def flush():
        nonlocal current
        if current is not None:
            # strip the zero-padding tail (NUL chars)
            current["message"] = current["message"].split("\x00")[0]
            current["corrected_bits"] = current.pop("_corr")
            current.pop("_field_bits", None)
            pages.append(current)
            current = None

    i = 0
    while i + 32 <= n:
        word = 0
        for b in bits[i:i + 32]:
            word = (word << 1) | int(b)
        if bin(word ^ SYNC).count("1") <= 2:
            # batch: 16 codewords follow
            i += 32
            for slot in range(16):
                if i + 32 > n:
                    break
                w = 0
                for b in bits[i:i + 32]:
                    w = (w << 1) | int(b)
                i += 32
                if bin(w ^ IDLE).count("1") <= 2:
                    flush()
                    continue
                dec = correct_codeword(w)
                if dec is None:
                    flush()
                    continue
                data21, nerr = dec
                corrected += nerr
                if data21 & (1 << 20):                 # message codeword
                    if current is not None:
                        field = data21 & 0xFFFFF
                        current["_field_bits"].extend(
                            (field >> (19 - k)) & 1 for k in range(20))
                        chars = current["_field_bits"]
                        msg = ""
                        for c in range(0, len(chars) - _CHARBITS + 1,
                                       _CHARBITS):
                            code = 0
                            for k in range(_CHARBITS):   # LSB first
                                code |= chars[c + k] << k
                            msg += chr(code)
                        current["message"] = msg
                        current["_corr"] += nerr
                else:                                   # address codeword
                    flush()
                    frame = slot // 2
                    ric = ((data21 >> 2) & 0x3FFFF) << 3 | frame
                    current = {"ric": ric, "function": data21 & 0x3,
                               "message": "", "_field_bits": [], "_corr": nerr}
        else:
            i += 1
    flush()
    return pages


@register_block("PocsagDecoder")
class PocsagDecoder(SinkBlock):
    """POCSAG pager decoder sink for an FSK-discriminator NRZ stream.

    ``sps`` = discriminator samples per bit; ``invert`` flips the FSK sense
    (POCSAG convention: high tone = 0). Accumulates ``pages``."""

    IN = (Port("in", dtype="float32"),)
    sps = Setting(default=32.0, kind="static")
    invert = Setting(default=True, kind="static")
    max_buffer_s = Setting(default=120.0, kind="static",
                           description="discriminator history bound; decoding "
                                       "is incremental")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.float64)
        self._archived: list[dict] = []
        self._pending = 0
        self.pages: list[dict] = []

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.real(np.asarray(arrays["in"][..., :n_valid]))
        self._buf = np.concatenate([self._buf,
                                    x.reshape(-1).astype(np.float64)])
        self._pending += n_valid
        if self._pending >= 16384:
            self._pending = 0
            self._process()

    def stop(self):
        self._process()

    def _process(self) -> None:
        if not len(self._buf):
            return
        from .ax25 import demod_bits
        disc = -self._buf if bool(self.settings.get("invert")) else self._buf
        bits = demod_bits(disc, float(self.settings.get("sps")))
        # wholesale view: a page still receiving message codewords at the
        # buffer end is provisional — re-decoding with more data REPLACES it
        # with the completed version (a grown-prefix suffix emit would freeze
        # the truncated message)
        self.pages = self._archived + decode_transmission(bits)
        cap = int(float(self.settings.get("max_buffer_s"))
                  * float(self.settings.get("sps")) * 1200.0)
        if len(self._buf) > cap:
            # freeze the current view and restart the buffer; a page mid-air
            # at the trim instant is lost — the cap trades that rare loss for
            # bounded memory on endless runs
            self._archived = list(self.pages)
            self._buf = np.zeros(0, np.float64)
