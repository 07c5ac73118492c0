"""ADS-B / Mode S decoder (1090 MHz extended squitter, DO-260/ICAO Annex 10).

Beyond-reference model family (GNU Radio users get this from gr-adsb): Mode S
frames are pulse-position-modulated at 1 Mbps — each bit is a (pulse, gap) or
(gap, pulse) pair of 0.5 µs chips — preceded by an 8 µs preamble with pulses
at 0, 1, 3.5 and 4.5 µs. At the canonical 2 Msps magnitude stream one chip is
one sample. Integrity is a 24-bit CRC (generator 0x1FFF409) whose remainder
is zero over a valid DF17/DF11 frame.

The device chain delivers the magnitude stream (e.g. SdrSource → ComplexToMag);
:class:`AdsbDecoder` does the host-side frame layer: preamble correlation,
PPM slicing, CRC gate, and DF17 identification (callsign) decode. The encode
helpers make the module transmit-capable for tests/simulation.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock
from ..core.registry import register_block
from ..core.settings import Setting

_GEN = 0x1FFF409           # 25-bit Mode S CRC generator
_PREAMBLE_CHIPS = np.array([1, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0],
                           np.float32)           # 16 half-µs chips
_CHARSET = "#ABCDEFGHIJKLMNOPQRSTUVWXYZ##### ###############0123456789######"


def crc24(bits: np.ndarray) -> int:
    """Mode S CRC-24 remainder over a bit array (MSB first)."""
    reg = 0
    for b in np.asarray(bits, np.uint8):
        reg = ((reg << 1) | int(b)) & 0x1FFFFFF
        if reg & 0x1000000:
            reg ^= _GEN
    # flush 24 zero bits
    for _ in range(24):
        reg = (reg << 1) & 0x1FFFFFF
        if reg & 0x1000000:
            reg ^= _GEN
    return reg & 0xFFFFFF


def _int_to_bits(value: int, width: int) -> list[int]:
    return [(value >> (width - 1 - i)) & 1 for i in range(width)]


def encode_frame(df: int, payload_bits: list[int]) -> np.ndarray:
    """Build a 112-bit frame: DF (5 bits) + payload + CRC-24 parity."""
    head = _int_to_bits(df, 5) + list(payload_bits)
    if len(head) != 88:
        raise ValueError(f"df+payload must be 88 bits, got {len(head)}")
    parity = crc24(np.asarray(head, np.uint8))
    return np.asarray(head + _int_to_bits(parity, 24), np.uint8)


def make_df17_identification(icao: int, callsign: str,
                             *, capability: int = 5) -> np.ndarray:
    """DF17 aircraft-identification (TC=4) extended squitter."""
    cs = (callsign.upper() + " " * 8)[:8]
    me = _int_to_bits(4, 5) + _int_to_bits(0, 3)       # TC=4, category 0
    for ch in cs:
        code = _CHARSET.index(ch) if ch in _CHARSET else 32
        me += _int_to_bits(code, 6)
    payload = _int_to_bits(capability, 3) + _int_to_bits(icao, 24) + me
    return encode_frame(17, payload)


def modulate(frames: list[np.ndarray], *, gap_us: float = 20.0,
             amplitude: float = 1.0, fs: float = 2e6) -> np.ndarray:
    """PPM magnitude waveform at ``fs`` (2 Msps ⇒ 1 chip = 1 sample)."""
    if abs(fs - 2e6) > 1e-6:
        raise ValueError("modulate() supports the canonical 2 Msps only")
    gap = np.zeros(int(round(gap_us * 2)), np.float32)
    parts = [gap]
    for bits in frames:
        chips = np.zeros(16 + 2 * len(bits), np.float32)
        chips[:16] = _PREAMBLE_CHIPS
        for k, b in enumerate(np.asarray(bits, np.uint8)):
            chips[16 + 2 * k + (0 if b else 1)] = 1.0
        parts += [amplitude * chips, gap]
    return np.concatenate(parts)


def decode_callsign(me_bits: np.ndarray) -> str:
    """Callsign from the 56-bit ME field of a TC 1-4 identification frame."""
    chars = []
    for k in range(8):
        code = 0
        for b in me_bits[8 + 6 * k: 8 + 6 * k + 6]:
            code = (code << 1) | int(b)
        chars.append(_CHARSET[code] if 0 <= code < len(_CHARSET) else "#")
    return "".join(chars).strip()


def decode_bits_stream(mag: np.ndarray, *, threshold: float = 0.2,
                       return_resume: bool = False):
    """Scan a 2 Msps magnitude stream for valid Mode S frames.

    Returns [{df, icao, bits, callsign?}, …] for every 112-bit frame whose
    CRC-24 remainder is zero; candidates are gated by the 4-pulse preamble
    layout check the way hardware slicers do it. With ``return_resume`` also
    returns the first unscanned index, so a streaming caller can drop
    everything before it without re-decoding frames at the next chunk.
    """
    mag = np.asarray(mag, np.float64)
    out: list[dict] = []
    n = len(mag)
    frame_len = 16 + 224
    # a valid start has a pulse in chip 0, so only above-threshold samples
    # can begin a preamble — skip the quiet majority without a Python loop
    # (2 Msps would crawl through a per-sample scan)
    candidates = np.nonzero(mag >= 0.5 * threshold)[0]
    ci = 0
    i = 0
    while i + frame_len <= n:
        while ci < len(candidates) and candidates[ci] < i:
            ci += 1
        if ci >= len(candidates):
            i = n            # no possible start anywhere ahead: fully scanned
            break
        i = int(candidates[ci])
        if i + frame_len > n:
            break
        win = mag[i:i + 16]
        peak = win.max()
        if peak < threshold:
            i += 1
            continue
        pulses = win[[0, 2, 7, 9]]
        gaps = win[[1, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15]]
        # every pulse chip strong, every quiet chip weak — rejects ±1-chip
        # mis-alignments that a mean-based gate lets through
        if pulses.min() < 0.5 * peak or gaps.max() > 0.5 * pulses.min():
            i += 1
            continue
        body = mag[i + 16: i + 16 + 224]
        first, second = body[0::2], body[1::2]
        bits = (first > second).astype(np.uint8)
        if crc24(bits) == 0 and bits[:5].any():
            df = int("".join(map(str, bits[:5])), 2)
            rec = {"df": df, "bits": bits,
                   "icao": int("".join(map(str, bits[8:32])), 2)}
            if df == 17:
                tc = int("".join(map(str, bits[32:37])), 2)
                if 1 <= tc <= 4:
                    rec["callsign"] = decode_callsign(bits[32:88])
                elif 9 <= tc <= 18:
                    rec["position_fields"] = parse_position_fields(bits)
            out.append(rec)
            i += frame_len
        else:
            i += 1
    if return_resume:
        return out, i
    return out


@register_block("AdsbDecoder")
class AdsbDecoder(SinkBlock):
    """Mode S frame decoder sink for a 2 Msps magnitude stream.

    Accumulates ``frames`` (dicts with df/icao/bits and callsign for DF17
    identification squitters); ``aircraft`` maps ICAO → last seen callsign.
    """

    IN = (Port("in", dtype="float32"),)
    threshold = Setting(default=0.2, kind="static",
                        description="preamble peak detection level")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._tail = np.zeros(0, np.float64)
        self.frames: list[dict] = []
        self.aircraft: dict[int, dict] = {}   # icao → {callsign?, lat?, lon?, alt_ft?}
        self._cpr: dict[int, dict] = {}       # icao → last even/odd CPR fields

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.real(np.asarray(arrays["in"][..., :n_valid])).reshape(-1)
        buf = np.concatenate([self._tail, x.astype(np.float64)])
        found, resume = decode_bits_stream(
            buf, threshold=float(self.settings.get("threshold")),
            return_resume=True)
        for rec in found:
            self.frames.append(rec)
            ac = self.aircraft.setdefault(rec["icao"], {})
            if "callsign" in rec:
                ac["callsign"] = rec["callsign"]
            pf = rec.get("position_fields")
            if pf is not None:
                if pf["alt_ft"] is not None:
                    ac["alt_ft"] = pf["alt_ft"]
                pair = self._cpr.setdefault(rec["icao"], {})
                pair["odd" if pf["odd"] else "even"] = pf
                if "even" in pair and "odd" in pair:
                    pos = cpr_decode(pair["even"]["lat_cpr"],
                                     pair["even"]["lon_cpr"],
                                     pair["odd"]["lat_cpr"],
                                     pair["odd"]["lon_cpr"],
                                     use_odd=pf["odd"])
                    if pos is not None:
                        ac["lat"], ac["lon"] = pos
        self._tail = buf[resume:]     # unscanned remainder only — no rescans


# -- airborne position (CPR, DO-260 §A.1.7 / "the 1090 MHz riddle") -----------

_NZ = 15


def hex_to_bits(frame_hex: str) -> np.ndarray:
    """112-bit frame from its hex transcript (e.g. dump1090 output)."""
    v = int(frame_hex, 16)
    n = len(frame_hex) * 4
    return np.asarray([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def _nl(lat: float) -> int:
    """Number of longitude zones at a latitude (NL function)."""
    if abs(lat) >= 87.0:
        return 1 if abs(lat) > 87.0 else 2
    if lat == 0.0:
        return 59
    a = 1.0 - np.cos(np.pi / (2.0 * _NZ))
    b = np.cos(np.pi / 180.0 * lat) ** 2
    return int(np.floor(2.0 * np.pi
                        / np.arccos(1.0 - a / b)))


def cpr_encode(lat: float, lon: float, odd: bool) -> tuple[int, int]:
    """17-bit CPR airborne encoding of a position."""
    dlat = 360.0 / (4 * _NZ - (1 if odd else 0))
    yz = int(np.floor(131072.0 * ((lat % dlat) / dlat) + 0.5)) % 131072
    rlat = dlat * (yz / 131072.0 + np.floor(lat / dlat))
    nl = max(_nl(rlat) - (1 if odd else 0), 1)
    dlon = 360.0 / nl
    xz = int(np.floor(131072.0 * ((lon % dlon) / dlon) + 0.5)) % 131072
    return yz, xz


def cpr_decode(lat_even: int, lon_even: int, lat_odd: int, lon_odd: int,
               *, use_odd: bool = False) -> tuple[float, float] | None:
    """Globally-unambiguous position from an even/odd CPR frame pair.

    Returns None when the pair straddles a longitude-zone boundary
    (NL mismatch — the receiver waits for the next frame)."""
    cle, clo = lat_even / 131072.0, lat_odd / 131072.0
    dlat_e, dlat_o = 360.0 / 60.0, 360.0 / 59.0
    j = np.floor(59.0 * cle - 60.0 * clo + 0.5)
    lat_e = dlat_e * ((j % 60) + cle)
    lat_o = dlat_o * ((j % 59) + clo)
    if lat_e >= 270.0:
        lat_e -= 360.0
    if lat_o >= 270.0:
        lat_o -= 360.0
    if _nl(lat_e) != _nl(lat_o):
        return None
    lat = lat_o if use_odd else lat_e
    nl = _nl(lat)
    ce, co = lon_even / 131072.0, lon_odd / 131072.0
    m = np.floor(ce * (nl - 1) - co * nl + 0.5)
    ni = max(nl - (1 if use_odd else 0), 1)
    lon = (360.0 / ni) * ((m % ni) + (co if use_odd else ce))
    if lon >= 180.0:
        lon -= 360.0
    return float(lat), float(lon)


def decode_altitude_ft(alt12: np.ndarray) -> int | None:
    """Barometric altitude from the 12-bit AC field (Q-bit granularity)."""
    bits = np.asarray(alt12, np.uint8)
    if bits[7] != 1:                      # Q=0 (100 ft Gillham code) — rare
        return None
    n = 0
    for b in np.concatenate([bits[:7], bits[8:]]):
        n = (n << 1) | int(b)
    return 25 * n - 1000


def make_df17_airborne_position(icao: int, lat: float, lon: float,
                                alt_ft: int, *, odd: bool,
                                capability: int = 5) -> np.ndarray:
    """DF17 airborne-position squitter (TC=11, barometric, Q-bit altitude)."""
    yz, xz = cpr_encode(lat, lon, odd)
    n_alt = (alt_ft + 1000) // 25
    alt11 = _int_to_bits(n_alt, 11)
    alt12 = alt11[:7] + [1] + alt11[7:]                 # insert Q bit
    me = (_int_to_bits(11, 5) + [0, 0] + [0] + alt12 + [0]
          + [1 if odd else 0] + _int_to_bits(yz, 17) + _int_to_bits(xz, 17))
    payload = _int_to_bits(capability, 3) + _int_to_bits(icao, 24) + me
    return encode_frame(17, payload)


def parse_position_fields(bits: np.ndarray) -> dict:
    """CPR fields from a DF17 TC 9-18 frame's bit array."""
    me = bits[32:88]
    return {"odd": bool(me[21]),
            "lat_cpr": int("".join(map(str, me[22:39])), 2),
            "lon_cpr": int("".join(map(str, me[39:56])), 2),
            "alt_ft": decode_altitude_ft(me[8:20])}
