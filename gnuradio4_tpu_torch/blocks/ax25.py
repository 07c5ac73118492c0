"""AX.25 / APRS packet radio (AFSK-1200 "Bell 202", HDLC framing).

Beyond-reference model family (GNU Radio users reach for direwolf/gr-ax25):
APRS packets are AX.25 UI frames — HDLC bit-stuffed payloads between 0x7E
flags with an X.25 FCS (reflected CRC-16-CCITT) — NRZI coded and AFSK
modulated at 1200 baud (mark 1200 Hz, space 2200 Hz).

Device path: the classic dual-tone correlator as a flowgraph — two
`FreqXlatingFir` branches (1200/2200 Hz, one-bit boxcar taps) → `Abs` →
`Subtract` give the mark−space envelope difference (sign = mark);
:func:`afsk_discriminate` is the same math on the host. :class:`Ax25Decoder`
does the link layer (DPLL bit clock, NRZI, HDLC destuffing, FCS gate,
address parse). The encode helpers make the module transmit-capable.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock
from ..core.registry import register_block
from ..core.settings import Setting

_FLAG = [0, 1, 1, 1, 1, 1, 1, 0]


def crc16_x25(data: bytes) -> int:
    """X.25 FCS: reflected CRC-16-CCITT, init 0xFFFF, xor-out 0xFFFF."""
    reg = 0xFFFF
    for byte in data:
        reg ^= byte
        for _ in range(8):
            reg = (reg >> 1) ^ 0x8408 if reg & 1 else reg >> 1
    return reg ^ 0xFFFF


def _encode_address(call: str, ssid: int, *, last: bool) -> bytes:
    call = (call.upper() + "      ")[:6]
    out = bytes((ord(c) << 1) & 0xFF for c in call)
    return out + bytes([0x60 | ((ssid & 0xF) << 1) | (1 if last else 0)])


def build_ui_frame(dest: str, src: str, info: str,
                  *, path: list[str] = (), dest_ssid: int = 0,
                  src_ssid: int = 0) -> bytes:
    """AX.25 UI frame bytes (addresses, control 0x03, PID 0xF0, info)."""
    addrs = [_encode_address(dest, dest_ssid, last=False)]
    vias = list(path)
    if vias:
        addrs.append(_encode_address(src, src_ssid, last=False))
        for k, via in enumerate(vias):
            addrs.append(_encode_address(via, 0, last=(k == len(vias) - 1)))
    else:
        addrs.append(_encode_address(src, src_ssid, last=True))
    return b"".join(addrs) + bytes([0x03, 0xF0]) + info.encode("ascii")


def _decode_address(chunk: bytes) -> tuple[str, int, bool]:
    call = "".join(chr(b >> 1) for b in chunk[:6]).strip()
    ssid = (chunk[6] >> 1) & 0xF
    return call, ssid, bool(chunk[6] & 1)


def parse_frame(frame: bytes) -> dict | None:
    """Addresses + info from FCS-validated AX.25 frame bytes."""
    if len(frame) < 16:
        return None
    addrs = []
    pos = 0
    while pos + 7 <= len(frame):
        call, ssid, last = _decode_address(frame[pos:pos + 7])
        addrs.append((call, ssid))
        pos += 7
        if last:
            break
    if len(addrs) < 2 or pos + 2 > len(frame):
        return None
    control, pid = frame[pos], frame[pos + 1]
    return {"dest": addrs[0], "src": addrs[1], "path": addrs[2:],
            "control": control, "pid": pid,
            "info": frame[pos + 2:].decode("ascii", "replace")}


def hdlc_bits(payload: bytes, *, preamble_flags: int = 16,
              tail_flags: int = 4) -> np.ndarray:
    """HDLC on-air bits: flags + LSB-first payload+FCS with zero stuffing."""
    fcs = crc16_x25(payload)
    data = payload + bytes([fcs & 0xFF, (fcs >> 8) & 0xFF])
    bits: list[int] = []
    ones = 0
    for byte in data:
        for i in range(8):                     # LSB first
            b = (byte >> i) & 1
            bits.append(b)
            if b:
                ones += 1
                if ones == 5:
                    bits.append(0)             # stuff
                    ones = 0
            else:
                ones = 0
    return np.asarray(_FLAG * preamble_flags + bits + _FLAG * tail_flags,
                      np.uint8)


def nrzi_encode(bits: np.ndarray) -> np.ndarray:
    """NRZI: 0 → toggle tone, 1 → hold (the HDLC convention)."""
    out = np.zeros(len(bits), np.uint8)
    level = 1
    for n, b in enumerate(np.asarray(bits, np.uint8)):
        if b == 0:
            level ^= 1
        out[n] = level
    return out


def afsk_modulate(payload: bytes, *, fs: float = 48000.0, baud: float = 1200.0,
                  f_mark: float = 1200.0, f_space: float = 2200.0,
                  amplitude: float = 0.8, **hdlc_kw) -> np.ndarray:
    """Phase-continuous Bell-202 AFSK waveform for one AX.25 frame."""
    tones = nrzi_encode(hdlc_bits(payload, **hdlc_kw))
    spb = fs / baud
    n_total = int(round(len(tones) * spb))
    idx = np.minimum((np.arange(n_total) / spb).astype(np.int64),
                     len(tones) - 1)
    freq = np.where(tones[idx] == 1, f_mark, f_space)
    phase = 2.0 * np.pi * np.cumsum(freq) / fs
    return (amplitude * np.sin(phase)).astype(np.float32)


def demod_bits(freq_stream: np.ndarray, sps: float) -> np.ndarray:
    """Tone decisions at bit centers with a DPLL bit clock.

    ``freq_stream`` is a detector stream whose sign selects the tone (the
    mark−space correlator difference, or an FM discriminator); envelope
    crossings nudge the sampling phase the way hardware modems recover the
    1200 baud clock from zero crossings.
    """
    x = np.asarray(freq_stream, np.float64)
    out: list[int] = []
    pll, inc = 0.0, 1.0 / sps           # pll ∈ [−0.5, 0.5), wraps at +0.5
    prev_sign = 1.0 if x[0] >= 0 else -1.0
    acc = 0.0                           # integrate-and-dump over the bit
    run = 0                             # samples since the last sign change
    min_run = max(int(sps / 4), 1)      # chatter gate for the clock nudge
    for v in x:
        sign = 1.0 if v >= 0 else -1.0
        if sign != prev_sign:
            # transition ≈ bit boundary: pull the wrap point toward mid-bit
            # (direwolf-style multiplicative nudge). Only persistent levels
            # count — image/noise chatter must not drag the clock.
            if run >= min_run:
                pll *= 0.5
            prev_sign = sign
            run = 0
        else:
            run += 1
        acc = acc * 0.5 + v             # leaky integrator, ~2-sample memory:
        pll += inc                      # the correlator already integrated a
        if pll >= 0.5:                  # full bit — sample its peak at the
            pll -= 1.0                  # wrap instead of re-averaging across
            out.append(1 if acc >= 0 else 0)   # the smeared envelope edges
    return np.asarray(out, np.uint8)


def nrzi_decode(tones: np.ndarray) -> np.ndarray:
    t = np.asarray(tones, np.uint8)
    return np.concatenate([[1], (t[1:] == t[:-1]).astype(np.uint8)])


def deframe(bits: np.ndarray) -> list[bytes]:
    """HDLC deframe: split on 0x7E flags, destuff, LSB-first bytes, FCS gate."""
    bits = np.asarray(bits, np.uint8)
    flag = np.asarray(_FLAG, np.uint8)
    # find flag positions
    starts = [i for i in range(len(bits) - 7)
              if np.array_equal(bits[i:i + 8], flag)]
    frames: list[bytes] = []
    for a, b in zip(starts, starts[1:]):
        seg = bits[a + 8:b]
        if len(seg) < 8 * 17:
            continue
        # destuff: drop the 0 after five consecutive 1s
        out_bits: list[int] = []
        ones = 0
        ok = True
        k = 0
        while k < len(seg):
            bit = int(seg[k])
            if ones == 5:
                if bit == 1:
                    ok = False          # 6 ones inside a frame: abort/flag
                    break
                ones = 0
                k += 1
                continue
            out_bits.append(bit)
            ones = ones + 1 if bit else 0
            k += 1
        if not ok or len(out_bits) % 8:
            continue
        data = bytearray()
        for i in range(0, len(out_bits), 8):
            byte = 0
            for j in range(8):                  # LSB first
                byte |= out_bits[i + j] << j
            data.append(byte)
        data = bytes(data)
        if len(data) >= 17 and crc16_x25(data[:-2]) == (data[-2] | (data[-1] << 8)):
            frames.append(data[:-2])
    return frames


@register_block("Ax25Decoder")
class Ax25Decoder(SinkBlock):
    """AX.25 link-layer decoder sink for an FM-discriminator stream.

    ``sps`` = discriminator samples per 1200-baud bit. Accumulates ``packets``
    as dicts with dest/src/path/info (FCS-validated only).
    """

    IN = (Port("in", dtype="float32"),)
    sps = Setting(default=10.0, kind="static",
                  description="discriminator samples per bit")
    max_buffer_s = Setting(default=60.0, kind="static",
                           description="detector-stream history bound (s of "
                                       "samples at sps×1200); decoding is "
                                       "incremental — packets appear during "
                                       "the run")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._buf = np.zeros(0, np.float64)
        self._n_seen = 0            # frames already emitted from this buffer
        self._pending = 0
        self.packets: list[dict] = []

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        x = np.real(np.asarray(arrays["in"][..., :n_valid]))
        self._buf = np.concatenate([self._buf,
                                    x.reshape(-1).astype(np.float64)])
        self._pending += n_valid
        if self._pending >= 4096:
            self._pending = 0
            self._process()

    def stop(self):
        self._process()

    def _process(self) -> None:
        if not len(self._buf):
            return
        # decoding a growing buffer is deterministic, so the frame list only
        # extends — emit the suffix beyond what was already reported
        tones = demod_bits(self._buf, float(self.settings.get("sps")))
        frames = deframe(nrzi_decode(tones))
        for f in frames[self._n_seen:]:
            p = parse_frame(f)
            if p is not None:
                self.packets.append(p)
        self._n_seen = len(frames)
        cap = int(float(self.settings.get("max_buffer_s"))
                  * float(self.settings.get("sps")) * 1200.0)
        if len(self._buf) > cap:
            # trim to the last half-cap and re-baseline the frame count over
            # the kept tail (frames fully inside it were already reported);
            # a frame straddling the cut is lost — the cap trades that for
            # bounded memory on endless runs
            self._buf = self._buf[-cap // 2:]
            tail_tones = demod_bits(self._buf,
                                    float(self.settings.get("sps")))
            self._n_seen = len(deframe(nrzi_decode(tail_tones)))


def afsk_discriminate(audio: np.ndarray, *, fs: float = 48000.0,
                      baud: float = 1200.0, f_mark: float = 1200.0,
                      f_space: float = 2200.0) -> np.ndarray:
    """Non-coherent dual-tone detector: per-sample mark−space envelope
    difference over one-bit correlation windows (the classic Bell-202
    demodulator — far better ISI behavior than an FM discriminator through
    a sharp lowpass). Positive output = mark."""
    x = np.asarray(audio, np.float64)
    n = np.arange(len(x))
    win = max(int(round(fs / baud)), 1)
    kernel = np.ones(win) / win
    def env(f0):
        z = x * np.exp(-2j * np.pi * f0 / fs * n)
        return np.abs(np.convolve(z, kernel, mode="same"))
    return env(f_mark) - env(f_space)
