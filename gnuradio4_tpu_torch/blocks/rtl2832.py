"""RTL2832U + R820T user-space SDR driver (≈ reference blocks/sdr
RTL2832Device.hpp:107-1412 + RTL2832Source.hpp — a from-scratch protocol driver
over vendor USB control transfers, no librtlsdr/libusb dependency).

Protocol facts come from the public RTL2832U and Rafael R820T datasheets (the
same sources the reference cites): vendor control requests address register
blocks (USB/SYS/I2C), the demodulator is programmed through paged registers,
and the tuner hangs off an I2C repeater. Samples arrive as unsigned-8-bit
interleaved IQ on bulk endpoint 0x81 and convert through the existing
native u8→complex path (native/convert.py).

The driver is written against the :mod:`.usb` backend protocol, so the full
init/tune/stream machinery is exercised hardware-free by the behavioral
:class:`FakeRtlUsb` (which inverts the PLL/resampler register math back into
frequencies — tests assert the round trip), and binds to real dongles through
``LinuxUsbDevice`` when one is present.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

from ..core.errors import GrError
from .usb import (FakeUsbDevice, LinuxUsbDevice, UsbDeviceInfo,
                  enumerate_usb_devices)

# -- protocol constants (RTL2832U datasheet) ----------------------------------
XTAL_FREQ = 28_800_000          # crystal, Hz
IF_FREQ = 3_570_000             # R820T low-side IF, Hz
BULK_ENDPOINT = 0x81
VENDOR_OUT, VENDOR_IN = 0x40, 0xC0
WRITE_FLAG = 0x10               # wIndex bit 4 selects write

BLOCK_USB, BLOCK_SYS, BLOCK_IIC = 0x0100, 0x0200, 0x0600

USB_SYSCTL = 0x2000
USB_EPA_CTL = 0x2148
USB_EPA_MAXPKT = 0x2158
DEMOD_CTL = 0x3000
DEMOD_CTL_1 = 0x300B

R820T_I2C_ADDR = 0x34           # 8-bit write address
EEPROM_I2C_ADDR = 0xA0
R820T_CHIP_ID = 0x69            # reg 0 reads 0x96, bit-reversed on the bus

VCO_MIN = 1_770_000_000
VCO_MAX = 2 * VCO_MIN

KNOWN_IDS = ((0x0BDA, 0x2832), (0x0BDA, 0x2838), (0x0413, 0x6680),
             (0x1D19, 0x1101), (0x1F4D, 0xB803))

# R820T register-file defaults for registers 0x05..0x1F (datasheet power-on
# recommended values — the writable shadow window)
R820T_INIT = bytes((
    0x83, 0x32, 0x75, 0xC0, 0x40, 0xD6, 0x6C, 0xF5, 0x63, 0x75,
    0x68, 0x6C, 0x83, 0x80, 0x00, 0x0F, 0x00, 0xC0, 0x30, 0x48,
    0xCC, 0x60, 0x00, 0x54, 0xAE, 0x4A, 0xC0))

# tracking-filter / RF-mux band table: (upper_mhz, open_drain, rf_mux_ploy,
# tf_c) — coarse 3-band split per the datasheet application notes
R820T_MUX = (
    (140, 0x02, 0x02, 0xDF),
    (420, 0x02, 0x41, 0x31),
    (10_000, 0x00, 0x40, 0x00),
)

# R820T tuner gain steps (dB*10 → (lna, mixer) index pairs), ascending
_GAIN_STEPS = [(0, 0, 0), (37, 1, 1), (77, 2, 2), (117, 3, 3), (144, 4, 4),
               (192, 5, 5), (227, 6, 6), (248, 7, 7), (280, 8, 8),
               (337, 9, 9), (377, 10, 10), (408, 11, 11), (434, 12, 12),
               (444, 13, 13), (496, 14, 14), (566, 15, 15)]


class Rtl2832Device:
    """The demod+tuner protocol driver over a USB backend."""

    def __init__(self, usb: Any | None = None):
        self.usb = usb
        self.xtal = float(XTAL_FREQ)
        self.ppm = 0
        self.sample_rate = 0.0
        self.center_frequency = 0.0
        self._shadow = bytearray(R820T_INIT)   # R820T regs 0x05..0x1F

    # -- lifecycle -------------------------------------------------------------
    def open(self, device_index: int = 0) -> None:
        if self.usb is None:
            infos = enumerate_usb_devices(KNOWN_IDS)
            if device_index >= len(infos):
                raise GrError(f"no RTL2832 dongle at index {device_index} "
                              f"(found {len(infos)})")
            self.usb = LinuxUsbDevice()
            self.usb.open(infos[device_index])
        elif not self.usb.is_open:
            self.usb.open(None)
        self._init_device()
        self._init_demod()
        self._detect_tuner()
        self._init_tuner()

    def close(self) -> None:
        if self.usb is not None and self.usb.is_open:
            self.usb.close()

    # -- register plumbing -----------------------------------------------------
    def _write_block(self, block: int, addr: int, data: bytes) -> None:
        self.usb.control_out(VENDOR_OUT, 0, addr, block | WRITE_FLAG, data)

    def _read_block(self, block: int, addr: int, n: int) -> bytes:
        return self.usb.control_in(VENDOR_IN, 0, addr, block, n)

    def _set_usb_reg(self, addr: int, value: int, n: int) -> None:
        self._write_block(BLOCK_USB, addr, value.to_bytes(n, "big"))

    def _set_sys_reg(self, addr: int, value: int) -> None:
        self._write_block(BLOCK_SYS, addr, bytes((value,)))

    def _set_demod_reg(self, page: int, addr: int, value: int, n: int) -> None:
        # paged demod write: wValue = (addr << 8) | 0x20, wIndex = page | write
        data = value.to_bytes(n, "big")
        self.usb.control_out(VENDOR_OUT, 0, (addr << 8) | 0x20,
                             (page | WRITE_FLAG), data)

    def _i2c_write(self, i2c_addr: int, payload: bytes) -> None:
        self._write_block(BLOCK_IIC, i2c_addr, payload)

    def _i2c_read_reg(self, i2c_addr: int, reg: int, n: int = 1) -> bytes:
        self._i2c_write(i2c_addr, bytes((reg,)))
        return self._read_block(BLOCK_IIC, i2c_addr, n)

    def _tuner_write(self, reg: int, value: int) -> None:
        if not (0x05 <= reg <= 0x1F):
            raise GrError(f"R820T register {reg:#x} outside shadow window")
        self._shadow[reg - 0x05] = value & 0xFF
        self._open_i2c()
        self._i2c_write(R820T_I2C_ADDR, bytes((reg, value & 0xFF)))
        self._close_i2c()

    def _tuner_write_mask(self, reg: int, value: int, mask: int) -> None:
        old = self._shadow[reg - 0x05]
        self._tuner_write(reg, (old & ~mask) | (value & mask))

    def _open_i2c(self) -> None:
        self._set_demod_reg(1, 0x01, 0x18, 1)   # IIC repeater on

    def _close_i2c(self) -> None:
        self._set_demod_reg(1, 0x01, 0x10, 1)

    # -- bring-up (datasheet power-on sequence) --------------------------------
    def _init_device(self) -> None:
        self._set_usb_reg(USB_SYSCTL, 0x09, 1)       # full-speed GPIO
        self._set_usb_reg(USB_EPA_MAXPKT, 0x0002, 2)  # 512-byte packets
        self._set_usb_reg(USB_EPA_CTL, 0x1002, 2)    # stall + FIFO flush
        self._set_sys_reg(DEMOD_CTL_1, 0x22)         # IR wake, low-I crystal
        self._set_sys_reg(DEMOD_CTL, 0xE8)           # PLL+ADC on, reset off

    def _init_demod(self) -> None:
        self._set_demod_reg(1, 0x01, 0x14, 1)        # soft reset
        self._set_demod_reg(1, 0x01, 0x10, 1)
        self._set_demod_reg(1, 0x15, 0x00, 1)        # spectrum not inverted
        # zero the IF (tuner supplies the IF downconversion)
        self._set_demod_reg(1, 0x16, 0x0000, 2)
        for i, c in enumerate(_FIR_DEFAULT):
            self._set_demod_reg(1, 0x1C + i, c, 1)
        self._set_demod_reg(0, 0x19, 0x05, 1)        # disable AGC loop default

    def _detect_tuner(self) -> None:
        self._open_i2c()
        chip = self._i2c_read_reg(R820T_I2C_ADDR, 0x00, 1)
        self._close_i2c()
        if not chip or chip[0] != R820T_CHIP_ID:
            got = f"{chip[0]:#x}" if chip else "no response"
            raise GrError(f"unsupported/absent tuner (R0 = {got}); this "
                          f"driver supports the R820T family")
        # R820T path: enable the RTL2832's zero-IF bypass for the tuner IF
        self._set_demod_reg(1, 0xB1, 0x1B, 1)

    def _init_tuner(self) -> None:
        for i, v in enumerate(R820T_INIT):
            self._tuner_write(0x05 + i, v)

    # -- configuration ---------------------------------------------------------
    def set_freq_correction(self, ppm: int) -> None:
        self.ppm = int(ppm)
        self.xtal = XTAL_FREQ * (1.0 + ppm * 1e-6)
        if self.sample_rate:
            self.set_sample_rate(self.sample_rate)

    def set_sample_rate(self, rate: float) -> float:
        """Program the RTL2832 resampler; returns the ACHIEVABLE rate
        (xtal·2²²/ratio with the bottom two ratio bits forced to zero)."""
        if not 225_000 <= rate <= 3_200_000:
            raise GrError(f"sample rate {rate} out of the RTL2832 range")
        ratio = int(self.xtal * (1 << 22) / rate) & 0x0FFFFFFC
        self._set_demod_reg(1, 0x9F, (ratio >> 16) & 0xFFFF, 2)
        self._set_demod_reg(1, 0xA1, ratio & 0xFFFF, 2)
        actual = self.xtal * (1 << 22) / ratio
        self.sample_rate = actual
        return actual

    def set_center_frequency(self, freq: float) -> float:
        """Tune the R820T PLL to freq+IF (low-side injection); returns the
        frequency actually achieved by the integer+sigma-delta divider."""
        lo = freq + IF_FREQ
        # band mux (open-drain, RF poly mux, tracking filter)
        mhz = freq / 1e6
        for upper, od, mux, tf in R820T_MUX:
            if mhz <= upper:
                self._tuner_write_mask(0x17, od, 0x08)
                self._tuner_write(0x1A, mux)
                self._tuner_write(0x1B, tf)
                break
        # mixer divider: vco = lo · div ∈ [1.77, 3.54] GHz
        div_exp = None
        for k in range(1, 7):
            if VCO_MIN <= lo * (1 << k) <= VCO_MAX:
                div_exp = k
                break
        if div_exp is None:
            raise GrError(f"frequency {freq/1e6:.3f} MHz outside the R820T "
                          f"VCO range")
        vco = lo * (1 << div_exp)
        self._tuner_write_mask(0x10, (div_exp - 1) << 5, 0xE0)
        # integer-N + 16-bit sigma-delta fraction of vco / (2·xtal)
        n_total = vco / (2.0 * self.xtal)
        nint = int(n_total)
        sdm = int(round((n_total - nint) * 65536.0))
        if sdm == 65536:
            nint, sdm = nint + 1, 0
        ni, si = divmod(nint - 13, 4)
        self._tuner_write(0x14, (ni & 0x3F) | (si << 6))
        self._tuner_write_mask(0x12, 0x00 if sdm else 0x08, 0x08)
        self._tuner_write(0x16, (sdm >> 8) & 0xFF)
        self._tuner_write(0x15, sdm & 0xFF)
        actual_lo = 2.0 * self.xtal * (nint + sdm / 65536.0) / (1 << div_exp)
        self.center_frequency = actual_lo - IF_FREQ
        return self.center_frequency

    def set_gain_mode(self, auto: bool) -> None:
        # LNA/mixer AGC enables live in regs 0x05/0x07 top bits
        self._tuner_write_mask(0x05, 0x00 if auto else 0x10, 0x10)
        self._tuner_write_mask(0x07, 0x10 if auto else 0x00, 0x10)

    def set_tuner_gain(self, gain_db: float) -> float:
        self.set_gain_mode(False)
        tenth = int(round(gain_db * 10))
        best = min(_GAIN_STEPS, key=lambda s: abs(s[0] - tenth))
        self._tuner_write_mask(0x05, best[1], 0x0F)       # LNA gain index
        self._tuner_write_mask(0x07, best[2], 0x0F)       # mixer gain index
        return best[0] / 10.0

    def set_agc_mode(self, on: bool) -> None:
        self._set_demod_reg(0, 0x19, 0x25 if on else 0x05, 1)

    def reset_buffer(self) -> None:
        self._set_usb_reg(USB_EPA_CTL, 0x1002, 2)
        self._set_usb_reg(USB_EPA_CTL, 0x0000, 2)

    # -- streaming -------------------------------------------------------------
    def read_samples(self, n: int) -> np.ndarray:
        """Read n complex samples (2n u8 bytes) from the bulk endpoint."""
        raw = self.usb.bulk_read(BULK_ENDPOINT, 2 * n)
        from ..native import convert as cv
        return cv.u8iq_to_c64(np.frombuffer(raw, np.uint8))

    # -- EEPROM ----------------------------------------------------------------
    def read_eeprom(self, length: int = 32) -> bytes:
        self._open_i2c()
        self._i2c_write(EEPROM_I2C_ADDR, b"\x00")
        data = self._read_block(BLOCK_IIC, EEPROM_I2C_ADDR, length)
        self._close_i2c()
        return data

    def eeprom_info(self) -> dict[str, Any]:
        """Parse vid/pid from the EEPROM header (bytes 0-1 magic 0x28 0x32)."""
        raw = self.read_eeprom(8)
        if len(raw) < 6 or raw[0] != 0x28:
            raise GrError("EEPROM signature missing")
        vid, pid = struct.unpack_from("<HH", raw, 2)
        return {"vid": vid, "pid": pid,
                "remote_wakeup": bool(raw[6] & 0x01) if len(raw) > 6 else False}


# demod anti-alias FIR defaults (RTL2832 datasheet table)
_FIR_DEFAULT = (0xCA, 0xDC, 0xD7, 0xD8, 0xE0, 0xF2, 0x0E, 0x35, 0x06, 0x50,
                0x9C, 0x0D, 0x71, 0x11, 0x14, 0x71, 0x74, 0x19, 0x41, 0xA5)


# -- behavioral fake (the LoopbackDevice of the USB world) --------------------


class FakeRtlUsb(FakeUsbDevice):
    """Behavioral RTL2832U+R820T model: decodes the driver's register writes,
    inverts the PLL/resampler math back into (center_frequency, sample_rate),
    and serves u8 IQ with test tones at absolute RF frequencies — the full
    open→tune→stream chain is assertable without hardware."""

    def __init__(self, rf_tones=(), tone_amps=(), eeprom: bytes | None = None,
                 waveform=None, waveform_freq: float = 0.0):
        super().__init__()
        self.rf_tones = list(rf_tones)
        self.tone_amps = list(tone_amps) or [0.5] * len(self.rf_tones)
        # optional complex-baseband transmission centered at waveform_freq
        # (absolute RF), repeated cyclically — a modulated fake station
        self.waveform = None if waveform is None else np.asarray(
            waveform, np.complex128)
        self.waveform_freq = float(waveform_freq)
        self.regs: dict[tuple[int, int], int] = {}
        self.demod: dict[tuple[int, int], int] = {}
        self.tuner: dict[int, int] = {}
        self._i2c_ptr: dict[int, int] = {}
        self.eeprom = eeprom or (b"\x28\x32" + struct.pack("<HH", 0x0BDA, 0x2838)
                                 + b"\xA5\x01" + b"\x00" * 26)
        self._phase = 0
        self.on_control_out(self._ctrl_out)
        self.on_control_in(self._ctrl_in)
        self.on_bulk_read(self._gen_samples)

    # decoded state ------------------------------------------------------------
    @property
    def sample_rate(self) -> float:
        hi = self.demod.get((1, 0x9F), 0)
        lo = self.demod.get((1, 0xA1), 0)
        ratio = (hi << 16) | lo
        return XTAL_FREQ * (1 << 22) / ratio if ratio else 0.0

    @property
    def center_frequency(self) -> float:
        div_exp = ((self.tuner.get(0x10, 0) >> 5) & 0x07) + 1
        r14 = self.tuner.get(0x14, 0)
        nint = (r14 & 0x3F) * 4 + (r14 >> 6) + 13
        sdm = (self.tuner.get(0x16, 0) << 8) | self.tuner.get(0x15, 0)
        lo = 2.0 * XTAL_FREQ * (nint + sdm / 65536.0) / (1 << div_exp)
        return lo - IF_FREQ

    # transfer decoding --------------------------------------------------------
    def _ctrl_out(self, request: int, value: int, index: int, data: bytes):
        block = index & ~WRITE_FLAG
        if block in (BLOCK_USB, BLOCK_SYS):
            self.regs[(block, value)] = int.from_bytes(data, "big")
        elif block == BLOCK_IIC:
            i2c_addr = value
            if len(data) == 1:
                self._i2c_ptr[i2c_addr] = data[0]
            elif len(data) == 2 and i2c_addr == R820T_I2C_ADDR:
                self.tuner[data[0]] = data[1]
        elif index & WRITE_FLAG and (value & 0xFF) == 0x20:
            page = index & ~WRITE_FLAG & 0xFF
            self.demod[(page, value >> 8)] = int.from_bytes(data, "big")

    def _ctrl_in(self, value: int, index: int, length: int) -> bytes:
        if index == BLOCK_IIC:
            i2c_addr = value
            ptr = self._i2c_ptr.get(i2c_addr, 0)
            if i2c_addr == R820T_I2C_ADDR:
                if ptr == 0:
                    return bytes((R820T_CHIP_ID,)) + b"\x00" * (length - 1)
                return bytes(self.tuner.get(ptr + i, 0) & 0xFF
                             for i in range(length))
            if i2c_addr == EEPROM_I2C_ADDR:
                return self.eeprom[ptr: ptr + length].ljust(length, b"\x00")
        return b"\x00" * length

    def _gen_samples(self, endpoint: int, length: int) -> bytes:
        assert endpoint == BULK_ENDPOINT
        n = length // 2
        fs = self.sample_rate or 1.0
        fc = self.center_frequency
        t = (self._phase + np.arange(n)) / fs
        self._phase += n
        x = np.zeros(n, np.complex128)
        for f, a in zip(self.rf_tones, self.tone_amps):
            x += a * np.exp(2j * np.pi * (f - fc) * t)
        if self.waveform is not None:
            idx = (self._phase - n + np.arange(n)) % len(self.waveform)
            mix = np.exp(2j * np.pi * (self.waveform_freq - fc) * t)
            x += self.waveform[idx] * mix
        iq = np.empty(2 * n, np.uint8)
        iq[0::2] = np.clip(np.round(x.real * 127.5 + 127.5), 0, 255)
        iq[1::2] = np.clip(np.round(x.imag * 127.5 + 127.5), 0, 255)
        return iq.tobytes()


# -- SdrDevice adapter + driver registration ----------------------------------


def _make_rtlsdr_device():
    from .sdr import SdrDevice

    class RtlSdrDevice(SdrDevice):
        """SdrSource-compatible adapter over Rtl2832Device (driver='rtlsdr').
        Inject ``usb=`` for a fake backend; defaults to enumerating real
        dongles through usbdevfs."""

        def __init__(self, usb: Any | None = None, device_index: int = 0):
            self._drv = Rtl2832Device(usb=usb)
            self._index = device_index

        def configure(self, *, sample_rate, center_frequency, gain=0.0,
                      antenna="", bandwidth=0.0, channels=1):
            if channels != 1:
                raise GrError("RTL2832 is a single-channel receiver")
            self._drv.open(self._index)
            self.sample_rate = self._drv.set_sample_rate(sample_rate)
            self.center_frequency = self._drv.set_center_frequency(
                center_frequency)
            if gain:
                self.gain = self._drv.set_tuner_gain(gain)
            else:
                self._drv.set_gain_mode(True)
                self.gain = 0.0
            self.channels = 1

        def activate(self):
            self._drv.reset_buffer()

        def read_stream(self, n):
            return self._drv.read_samples(n), {}

        def deactivate(self):
            self._drv.close()

    return RtlSdrDevice


def register() -> None:
    from .sdr import register_sdr_driver
    register_sdr_driver("rtlsdr", _make_rtlsdr_device())


register()
