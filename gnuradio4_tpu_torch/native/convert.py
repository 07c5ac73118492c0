"""ctypes bindings for the native sample-format converters (NumPy fallback).

``convert.cpp`` is built with ``g++ -O3 -march=native`` at first use into
``_build/`` (``build.py``), with a plain ``-O3`` retry where the compiler
refuses ``-march=native``: the library is built on the machine that runs it.
Without a compiler each conversion takes its NumPy form, which computes the
same values.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .build import build_library

_SOURCES = ("convert.cpp",)
_FLAGS = (("-O3", "-march=native"), ("-O3",))
_lib = None
_lock = threading.Lock()


def build_native(force: bool = False) -> bool:
    return build_library("gr4convert", _SOURCES, _FLAGS, force=force) is not None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = build_library("gr4convert", _SOURCES, _FLAGS)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        for name, argtypes in {
            "gr4_i16_to_f32": [i16p, f32p, ctypes.c_size_t, ctypes.c_float],
            "gr4_u8_to_f32": [u8p, f32p, ctypes.c_size_t, ctypes.c_float],
            "gr4_i16iq_to_c64": [i16p, f32p, ctypes.c_size_t, ctypes.c_float],
            "gr4_u8iq_to_c64": [u8p, f32p, ctypes.c_size_t, ctypes.c_float],
            "gr4_f32_to_i16": [f32p, i16p, ctypes.c_size_t, ctypes.c_float],
            "gr4_deinterleave_f32": [f32p, f32p, f32p, ctypes.c_size_t],
        }.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = None, argtypes
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def i16_to_f32(x: np.ndarray, scale: float = 1.0 / 32768.0) -> np.ndarray:
    x = np.ascontiguousarray(x, np.int16)
    lib = _load()
    if lib is None:
        return x.astype(np.float32) * np.float32(scale)
    y = np.empty(x.size, np.float32)
    lib.gr4_i16_to_f32(x.ravel(), y, x.size, scale)
    return y.reshape(x.shape)


def u8_to_f32(x: np.ndarray, scale: float = 1.0 / 127.5) -> np.ndarray:
    x = np.ascontiguousarray(x, np.uint8)
    lib = _load()
    if lib is None:
        return (x.astype(np.float32) - np.float32(127.5)) * np.float32(scale)
    y = np.empty(x.size, np.float32)
    lib.gr4_u8_to_f32(x.ravel(), y, x.size, scale)
    return y.reshape(x.shape)


def i16iq_to_c64(x: np.ndarray, scale: float = 1.0 / 32768.0) -> np.ndarray:
    x = np.ascontiguousarray(x, np.int16).ravel()
    n = x.size // 2
    lib = _load()
    if lib is None:
        f = x[: 2 * n].astype(np.float32) * np.float32(scale)
        return f.view(np.complex64)
    y = np.empty(2 * n, np.float32)
    lib.gr4_i16iq_to_c64(x[: 2 * n], y, n, scale)
    return y.view(np.complex64)


def u8iq_to_c64(x: np.ndarray, scale: float = 1.0 / 127.5) -> np.ndarray:
    x = np.ascontiguousarray(x, np.uint8).ravel()
    n = x.size // 2
    lib = _load()
    if lib is None:
        f = (x[: 2 * n].astype(np.float32) - np.float32(127.5)) * np.float32(scale)
        return f.view(np.complex64)
    y = np.empty(2 * n, np.float32)
    lib.gr4_u8iq_to_c64(x[: 2 * n], y, n, scale)
    return y.view(np.complex64)


def f32_to_i16(x: np.ndarray, scale: float = 32767.0) -> np.ndarray:
    """Scale, clip to int16 and round half away from zero."""
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        v = np.clip(x * np.float32(scale), -32768, 32767)
        return np.trunc(v + np.copysign(np.float32(0.5), v)).astype(np.int16)
    y = np.empty(x.size, np.int16)
    lib.gr4_f32_to_i16(x.ravel(), y, x.size, scale)
    return y.reshape(x.shape)
