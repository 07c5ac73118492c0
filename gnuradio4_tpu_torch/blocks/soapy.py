"""SoapySDR binding over the stable C ABI (≈ reference blocks/sdr
SoapyRaiiWrapper.hpp:11 — the same ABI-safe surface, bound with ctypes instead
of C++ RAII; no SoapySDR headers or build-time dependency).

The binding dlopens ``libSoapySDR`` at runtime: real hardware works wherever
the vendor library + driver modules are installed, and the test suite builds a
tiny fake libSoapySDR (tests/fake_soapy.cpp) implementing the same C symbols —
so enumerate/make/configure/stream is exercised end-to-end without radios,
exactly like the reference's LoopbackDevice strategy.

Registered as ``SdrSource(driver="soapy", ...)`` via :func:`register`.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Any

import numpy as np

from ..core.errors import GrError

SOAPY_SDR_TX, SOAPY_SDR_RX = 0, 1
SOAPY_SDR_CF32 = b"CF32"


class _Kwargs(ctypes.Structure):
    _fields_ = [("size", ctypes.c_size_t),
                ("keys", ctypes.POINTER(ctypes.c_char_p)),
                ("vals", ctypes.POINTER(ctypes.c_char_p))]


def _make_kwargs(d: dict[str, str]) -> _Kwargs:
    n = len(d)
    keys = (ctypes.c_char_p * n)(*[k.encode() for k in d])
    vals = (ctypes.c_char_p * n)(*[str(v).encode() for v in d.values()])
    kw = _Kwargs(size=n, keys=ctypes.cast(keys, ctypes.POINTER(ctypes.c_char_p)),
                 vals=ctypes.cast(vals, ctypes.POINTER(ctypes.c_char_p)))
    kw._keep = (keys, vals)   # keep the arrays alive with the struct
    return kw


class SoapyBinding:
    """ctypes surface over the SoapySDR C API (subset the blocks need)."""

    def __init__(self, lib_path: str | None = None):
        path = lib_path or ctypes.util.find_library("SoapySDR")
        if path is None:
            for cand in ("libSoapySDR.so.0.8", "libSoapySDR.so"):
                try:
                    self.lib = ctypes.CDLL(cand)
                    break
                except OSError:
                    continue
            else:
                raise GrError("libSoapySDR not found — install SoapySDR or "
                              "pass lib_path")
        else:
            try:
                self.lib = ctypes.CDLL(path)
            except OSError as e:
                raise GrError(f"cannot load libSoapySDR from {path!r}: "
                              f"{e}") from e
        lib = self.lib
        # this binding declares the 0.8-era stream ABI (setupStream RETURNS
        # the stream pointer; pre-0.8 took a SoapySDRStream** out-param and
        # returned int) — calling a 0.7 library through it would corrupt
        # memory, so reject old ABIs up front
        try:
            lib.SoapySDR_getABIVersion.restype = ctypes.c_char_p
            abi = lib.SoapySDR_getABIVersion().decode()
        except AttributeError:
            abi = "unknown"
        if abi != "unknown":
            try:
                major, minor = (int(x) for x in abi.split("-")[0].split(".")[:2])
                if (major, minor) < (0, 8):
                    raise GrError(f"SoapySDR ABI {abi} is too old — this "
                                  f"binding requires the 0.8+ stream API")
            except ValueError:
                pass   # unparseable ABI string: proceed, the fake lib does this
        lib.SoapySDRDevice_enumerate.restype = ctypes.POINTER(_Kwargs)
        lib.SoapySDRDevice_enumerate.argtypes = [ctypes.POINTER(_Kwargs),
                                                 ctypes.POINTER(ctypes.c_size_t)]
        lib.SoapySDRDevice_make.restype = ctypes.c_void_p
        lib.SoapySDRDevice_make.argtypes = [ctypes.POINTER(_Kwargs)]
        lib.SoapySDRDevice_unmake.restype = ctypes.c_int
        lib.SoapySDRDevice_unmake.argtypes = [ctypes.c_void_p]
        lib.SoapySDRDevice_setSampleRate.restype = ctypes.c_int
        lib.SoapySDRDevice_setSampleRate.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double]
        lib.SoapySDRDevice_getSampleRate.restype = ctypes.c_double
        lib.SoapySDRDevice_getSampleRate.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t]
        lib.SoapySDRDevice_setFrequency.restype = ctypes.c_int
        lib.SoapySDRDevice_setFrequency.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double,
            ctypes.POINTER(_Kwargs)]
        lib.SoapySDRDevice_setGain.restype = ctypes.c_int
        lib.SoapySDRDevice_setGain.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double]
        lib.SoapySDRDevice_setupStream.restype = ctypes.c_void_p
        lib.SoapySDRDevice_setupStream.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t,
            ctypes.POINTER(_Kwargs)]
        lib.SoapySDRDevice_activateStream.restype = ctypes.c_int
        lib.SoapySDRDevice_activateStream.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_size_t]
        lib.SoapySDRDevice_deactivateStream.restype = ctypes.c_int
        lib.SoapySDRDevice_deactivateStream.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
        lib.SoapySDRDevice_closeStream.restype = ctypes.c_int
        lib.SoapySDRDevice_closeStream.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_void_p]
        lib.SoapySDRDevice_readStream.restype = ctypes.c_int
        lib.SoapySDRDevice_readStream.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_long]

    def enumerate(self) -> int:
        n = ctypes.c_size_t(0)
        self.lib.SoapySDRDevice_enumerate(None, ctypes.byref(n))
        return int(n.value)


class SoapyDevice:
    """SdrDevice-shaped adapter over one Soapy device handle."""

    def __init__(self, *, lib_path: str | None = None,
                 device_args: dict[str, str] | None = None):
        self._b = SoapyBinding(lib_path)
        self._args = dict(device_args or {})
        self._dev = None
        self._stream = None

    def configure(self, *, sample_rate, center_frequency, gain=0.0,
                  antenna="", bandwidth=0.0, channels=1):
        lib = self._b.lib
        kw = _make_kwargs(self._args)
        self._dev = lib.SoapySDRDevice_make(ctypes.byref(kw))
        if not self._dev:
            raise GrError("SoapySDRDevice_make failed")
        if channels != 1:
            raise GrError("soapy binding: 1 RX channel for now")
        lib.SoapySDRDevice_setSampleRate(self._dev, SOAPY_SDR_RX, 0,
                                         float(sample_rate))
        self.sample_rate = float(lib.SoapySDRDevice_getSampleRate(
            self._dev, SOAPY_SDR_RX, 0))
        lib.SoapySDRDevice_setFrequency(self._dev, SOAPY_SDR_RX, 0,
                                        float(center_frequency), None)
        self.center_frequency = float(center_frequency)
        if gain:
            lib.SoapySDRDevice_setGain(self._dev, SOAPY_SDR_RX, 0, float(gain))
        self.gain = float(gain)
        self.channels = 1
        chans = (ctypes.c_size_t * 1)(0)
        self._stream = lib.SoapySDRDevice_setupStream(
            self._dev, SOAPY_SDR_RX, SOAPY_SDR_CF32, chans, 1, None)
        if not self._stream:
            raise GrError("SoapySDRDevice_setupStream failed")

    def activate(self):
        self._b.lib.SoapySDRDevice_activateStream(self._dev, self._stream,
                                                  0, 0, 0)

    def read_stream(self, n):
        buf = np.empty(n, np.complex64)
        buffs = (ctypes.c_void_p * 1)(buf.ctypes.data)
        flags = ctypes.c_int(0)
        time_ns = ctypes.c_longlong(0)
        got = self._b.lib.SoapySDRDevice_readStream(
            self._dev, self._stream, buffs, n, ctypes.byref(flags),
            ctypes.byref(time_ns), 1_000_000)
        if got < 0:
            return None, {"error": got}
        return buf[:got], {}

    def deactivate(self):
        lib = self._b.lib
        if self._stream:
            lib.SoapySDRDevice_deactivateStream(self._dev, self._stream, 0, 0)
            lib.SoapySDRDevice_closeStream(self._dev, self._stream)
            self._stream = None
        if self._dev:
            lib.SoapySDRDevice_unmake(self._dev)
            self._dev = None

    def write_stream(self, samples):
        raise GrError("soapy binding: TX not wired yet")


def register(lib_path: str | None = None) -> None:
    """Register driver='soapy' (call with lib_path to pin a library)."""
    from .sdr import register_sdr_driver
    register_sdr_driver("soapy",
                        lambda: SoapyDevice(lib_path=lib_path))


try:                         # best-effort: only if the vendor lib is present
    SoapyBinding()
    register()
except Exception:            # no libSoapySDR on this machine — fake-only use
    pass
