"""IEEE 802.15.4 (ZigBee) 2.4 GHz O-QPSK DSSS physical + MAC link layer.

Beyond-reference model family (gr-ieee802-15-4 equivalent): 250 kb/s data
ride 62.5 ksym/s 4-bit symbols, each spread to a 32-chip PN sequence at
2 Mchip/s and modulated O-QPSK with half-sine pulse shaping (even chips on
I, odd chips on Q offset by one chip period — the MSK-equivalent
constant-envelope waveform, IEEE 802.15.4-2006 sections 6.5.2.3/6.5.2.4).

Chip table (Table 73): symbol 0 is the published 32-chip sequence; symbols
1-7 are successive 4-chip cyclic right shifts; symbols 8-15 repeat 0-7
with the odd-indexed chips complemented.

Frame (section 6.3): SHR = 4 zero preamble bytes + SFD 0xA7, PHR = 7-bit
frame length, PSDU ending in the 2-byte FCS — CRC-16/KERMIT (ITU-T
x^16+x^12+x^5+1, init 0, LSB-first, appended little-endian; section 7.2.1.9).
Nibbles transmit low-first within each byte.

Device/host split (the receiver-family pattern, blocks/ais.py /
blocks/ble.py): synthesis is a vectorized half-sine chip timeline; the
:class:`Ieee802154Decoder` sink consumes complex baseband, finds the SHR
by complex correlation (which also yields the carrier-phase derotation),
hard-decides chips at half-sine peaks, nearest-matches against the chip
table, and FCS-gates reassembled frames with a light MAC header parse.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting

CHIP_RATE = 2_000_000.0
SYMBOL_CHIPS = 32
SFD = 0xA7

# Table 73 symbol-0 sequence, c0..c31
_SEQ0 = np.asarray([1, 1, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1, 1,
                    0, 1, 0, 1, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0],
                   np.uint8)


def chip_table() -> np.ndarray:
    """[16, 32] chip sequences: 4-chip cyclic shifts + odd-chip conjugation."""
    tab = np.empty((16, SYMBOL_CHIPS), np.uint8)
    for k in range(8):
        tab[k] = np.roll(_SEQ0, 4 * k)
    flip = np.zeros(SYMBOL_CHIPS, np.uint8)
    flip[1::2] = 1
    tab[8:] = tab[:8] ^ flip
    return tab


_CHIPS = chip_table()


# ------------------------------------------------------------------ FCS

def crc16_kermit(data: bytes) -> int:
    """CRC-16/KERMIT == the 802.15.4 FCS (reflected 0x1021, init 0)."""
    state = 0
    for byte in bytes(data):
        state ^= byte
        for _ in range(8):
            state = (state >> 1) ^ 0x8408 if state & 1 else state >> 1
    return state


def append_fcs(payload: bytes) -> bytes:
    c = crc16_kermit(payload)
    return bytes(payload) + bytes([c & 0xFF, (c >> 8) & 0xFF])


def check_fcs(psdu: bytes) -> bool:
    if len(psdu) < 2:
        return False
    c = crc16_kermit(psdu[:-2])
    return psdu[-2] == (c & 0xFF) and psdu[-1] == ((c >> 8) & 0xFF)


# ------------------------------------------------------------ symbol maps

def bytes_to_symbols(data: bytes) -> np.ndarray:
    b = np.frombuffer(bytes(data), np.uint8)
    return np.stack([b & 0xF, b >> 4], axis=1).reshape(-1)  # low nibble first


def symbols_to_bytes(symbols: np.ndarray) -> bytes:
    s = np.asarray(symbols, np.uint8)[: len(symbols) // 2 * 2].reshape(-1, 2)
    return bytes((s[:, 0] | (s[:, 1] << 4)).astype(np.uint8))


def frame_symbols(psdu: bytes) -> np.ndarray:
    """SHR + PHR + PSDU as 4-bit symbols (PSDU must already carry the FCS)."""
    if not 2 <= len(psdu) <= 127:
        raise ValueError("PSDU length must be 2..127 bytes (incl. FCS)")
    return bytes_to_symbols(bytes(4) + bytes([SFD, len(psdu)]) + bytes(psdu))


# ------------------------------------------------------------- modulator

def oqpsk_modulate(symbols: np.ndarray, *, sps: int = 4,
                   amplitude: float = 1.0) -> np.ndarray:
    """O-QPSK half-sine baseband IQ at ``sps`` samples per chip: even chips
    (±1) ride I, odd chips ride Q delayed one chip; each chip's half-sine
    spans two chip periods, so pulse peaks land mid-way through the NEXT
    chip — the decoder samples there."""
    chips = _CHIPS[np.asarray(symbols, np.uint8)].reshape(-1)
    levels = chips.astype(np.float64) * 2 - 1
    n_pairs = len(levels) // 2
    pulse = np.sin(np.pi * np.arange(2 * sps) / (2 * sps))   # half-sine, 2 Tc
    # each I pulse starts at chip-pair boundary 2m Tc; Q starts at (2m+1) Tc
    n = (2 * n_pairs + 1) * sps + len(pulse)
    i_t = np.zeros(n)
    q_t = np.zeros(n)
    for m in range(n_pairs):
        s = 2 * m * sps
        i_t[s:s + 2 * sps] += levels[2 * m] * pulse
        q_t[s + sps:s + 3 * sps] += levels[2 * m + 1] * pulse
    return (amplitude * (i_t + 1j * q_t)).astype(np.complex64)


def ieee802154_modulate(payload: bytes, *, sps: int = 4,
                        amplitude: float = 1.0) -> np.ndarray:
    """Complete frame waveform for a MAC payload (FCS appended here)."""
    return oqpsk_modulate(frame_symbols(append_fcs(payload)), sps=sps,
                          amplitude=amplitude)


# --------------------------------------------------------------- decoder

def _shr_reference(sps: int) -> np.ndarray:
    return oqpsk_modulate(bytes_to_symbols(bytes(4) + bytes([SFD])), sps=sps)


def _sample_chips(x: np.ndarray, start: int, n_chips: int,
                  sps: int) -> np.ndarray:
    """Hard chip decisions at the half-sine peaks: chip k (0-based from
    ``start``, the first I pulse onset) peaks at start + (k+1)·sps, on I
    for even k and Q for odd k."""
    k = np.arange(n_chips)
    idx = start + (k + 1) * sps
    idx = np.minimum(idx, len(x) - 1)
    vals = np.where(k % 2 == 0, np.real(x[idx]), np.imag(x[idx]))
    return (vals > 0).astype(np.uint8)


def _nearest_symbols(chips: np.ndarray) -> tuple[np.ndarray, int]:
    """Chip blocks [n, 32] → (symbols, total Hamming distance)."""
    d = (chips[:, None, :] != _CHIPS[None, :, :]).sum(axis=2)
    sym = d.argmin(axis=1)
    return sym.astype(np.uint8), int(d.min(axis=1).sum())


def parse_mac_header(psdu: bytes) -> dict:
    """Light MAC parse (section 7.2): FCF, seq, 16-bit short addressing."""
    out: dict = {"psdu": bytes(psdu)}
    if len(psdu) < 3:
        return out
    fcf = psdu[0] | (psdu[1] << 8)
    out["frame_type"] = {0: "beacon", 1: "data", 2: "ack",
                         3: "command"}.get(fcf & 0x7, f"reserved_{fcf & 7}")
    out["seq"] = psdu[2]
    dst_mode = (fcf >> 10) & 0x3
    src_mode = (fcf >> 14) & 0x3
    intra_pan = (fcf >> 6) & 1
    i = 3
    try:
        if dst_mode == 2:
            out["dst_pan"] = psdu[i] | (psdu[i + 1] << 8)
            out["dst_addr"] = psdu[i + 2] | (psdu[i + 3] << 8)
            i += 4
        if src_mode == 2:
            if not intra_pan:
                out["src_pan"] = psdu[i] | (psdu[i + 1] << 8)
                i += 2
            out["src_addr"] = psdu[i] | (psdu[i + 1] << 8)
            i += 2
        if dst_mode in (0, 2) and src_mode in (0, 2):
            out["payload"] = bytes(psdu[i:-2])
    except IndexError:
        pass
    return out


def decode_stream(x: np.ndarray, *, sps: int = 4,
                  corr_threshold: float = 0.6,
                  max_chip_errors_per_symbol: int = 8) -> list[dict]:
    """Frame hunt in complex baseband: SHR correlation peak → carrier-phase
    derotation + chip timing → PHR length → chip-table nearest match →
    FCS gate → MAC parse.  Returns decoded frame dicts in stream order."""
    x = np.asarray(x, np.complex64)
    ref = _shr_reference(sps)
    if len(x) < len(ref):
        return []
    corr = np.correlate(x, ref, mode="valid")
    norm = np.sqrt(np.convolve(np.abs(x) ** 2, np.ones(len(ref)),
                               mode="valid") * np.sum(np.abs(ref) ** 2))
    score = np.abs(corr) / np.maximum(norm, 1e-12)
    frames: list[dict] = []
    pos = 0
    shr_chips = 10 * SYMBOL_CHIPS                  # 5 bytes = 10 symbols
    while pos + len(ref) <= len(x):
        window = score[pos:]
        hits = np.flatnonzero(window >= corr_threshold)
        if not len(hits):
            break
        # refine to the local correlation maximum within one chip
        p = pos + hits[0]
        lo, hi = max(p - sps, 0), min(p + sps + 1, len(score))
        p = lo + int(np.argmax(score[lo:hi]))
        y = x * np.exp(-1j * np.angle(corr[p]))    # coherent derotation
        # PHR symbols follow the SHR
        phr_start = p
        chips = _sample_chips(y, phr_start, shr_chips + 2 * SYMBOL_CHIPS,
                              sps)
        syms, _ = _nearest_symbols(
            chips[shr_chips:].reshape(-1, SYMBOL_CHIPS))
        length = int(symbols_to_bytes(syms)[0]) & 0x7F
        total_chips = shr_chips + (2 + 2 * length) * SYMBOL_CHIPS
        if length < 2 or phr_start + (total_chips + 2) * sps > len(x):
            pos = p + sps
            continue
        chips = _sample_chips(y, phr_start, total_chips, sps)
        body = chips[shr_chips + 2 * SYMBOL_CHIPS:]
        syms, dist = _nearest_symbols(body.reshape(-1, SYMBOL_CHIPS))
        if dist > max_chip_errors_per_symbol * len(syms):
            pos = p + sps
            continue
        psdu = symbols_to_bytes(syms)
        if check_fcs(psdu):
            frame = parse_mac_header(psdu)
            frame["fcs_ok"] = True
            frame["chip_errors"] = dist
            frame["sample_offset"] = int(p)
            frames.append(frame)
            pos = p + total_chips * sps
        else:
            pos = p + sps
    return frames


# ---------------------------------------------------------------- blocks

def build_data_frame(payload: bytes, *, seq: int = 0, dst_pan: int = 0x1AAA,
                     dst_addr: int = 0xFFFF, src_addr: int = 0x0001) -> bytes:
    """MAC data frame (intra-PAN, 16-bit addressing) WITHOUT the FCS."""
    fcf = 0x8841            # data | intra-PAN | 16-bit dst + src addressing
    hdr = bytes([fcf & 0xFF, fcf >> 8, seq & 0xFF,
                 dst_pan & 0xFF, dst_pan >> 8,
                 dst_addr & 0xFF, dst_addr >> 8,
                 src_addr & 0xFF, src_addr >> 8])
    return hdr + bytes(payload)


@register_block("Ieee802154Source")
class Ieee802154Source(SourceBlock):
    """Transmit-side stimulus: plays O-QPSK frames for a list of MAC
    payload dicts (keys accepted by :func:`build_data_frame`, plus
    ``payload``) with silence gaps, optionally cyclic."""

    OUT = (Port("out", dtype="complex64"),)
    FEED = True
    sps = Setting(default=4, kind="static",
                  description="samples per 2 Mchip/s chip")
    gap_s = Setting(default=100e-6, kind="static")
    repeat = Setting(default=False, kind="static")

    def __init__(self, frames: list[dict] = (), name=None, **settings):
        super().__init__(name=name, **settings)
        sps = int(self.settings.get("sps"))
        fs = sps * CHIP_RATE
        gap = np.zeros(int(float(self.settings.get("gap_s")) * fs),
                       np.complex64)
        parts: list[np.ndarray] = [gap]
        for fr in frames:
            kw = {k: v for k, v in fr.items() if k != "payload"}
            psdu = build_data_frame(fr["payload"], **kw)
            parts.append(ieee802154_modulate(psdu, sps=sps))
            parts.append(gap)
        self._wave = (np.concatenate(parts) if parts
                      else np.zeros(0, np.complex64))

    def host_feed(self, n, abs_index):
        total = len(self._wave)
        if not total:
            return None
        if self.settings.get("repeat"):
            idx = np.arange(abs_index, abs_index + n) % total
            return {"out": self._wave[idx]}, n
        if abs_index >= total:
            return None
        chunk = self._wave[abs_index:abs_index + n]
        return {"out": chunk}, len(chunk)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("Ieee802154Decoder")
class Ieee802154Decoder(SinkBlock):
    """802.15.4 receiver sink for complex baseband at ``sps`` samples per
    chip (coherent: the SHR correlation supplies the carrier phase, so it
    takes IQ directly rather than a discriminator stream).  Accumulates
    FCS-verified ``frames``.  Incremental with a bounded history."""

    IN = (Port("in", dtype="complex64"),)
    sps = Setting(default=4, kind="static")
    corr_threshold = Setting(default=0.6, kind="static")
    max_buffer_s = Setting(default=5.0, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.complex64)
        self._pending = 0
        self._base = 0                  # absolute sample index of _buf[0]
        self._seen_offsets: set[int] = set()
        self.frames: list[dict] = []

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.asarray(arrays["in"][..., :n_valid])
        self._buf = np.concatenate([self._buf,
                                    x.reshape(-1).astype(np.complex64)])
        self._pending += n_valid
        if self._pending >= 65536:
            self._pending = 0
            self._process()

    def stop(self):
        self._process()

    def _process(self) -> None:
        if not len(self._buf):
            return
        sps = int(self.settings.get("sps"))
        for f in decode_stream(
                self._buf, sps=sps,
                corr_threshold=float(self.settings.get("corr_threshold"))):
            abs_off = int(f["sample_offset"]) + self._base
            if abs_off in self._seen_offsets:
                continue            # re-found inside the retained tail
            self._seen_offsets.add(abs_off)
            f["sample_offset"] = abs_off
            self.frames.append(f)
        cap = int(float(self.settings.get("max_buffer_s")) * sps * CHIP_RATE)
        if len(self._buf) > cap:
            # retain one max-frame window across the trim (127-byte PSDU =
            # 2·(127+6)·8 chips ≈ 4256 chips + sync margin), chip-aligned so
            # correlation timing is preserved (ADVICE r2: the old
            # reset-to-empty lost any frame spanning the trim)
            keep = 8192 * sps
            self._base += len(self._buf) - keep
            self._buf = self._buf[-keep:]
