"""ALSA audio backend over the libasound C ABI (the native-hardware analog of
the reference's libsoundio backend, blocks/audio AudioBackends.hpp:28) — bound
with ctypes at runtime, no build-time dependency.

Uses the small "safe" subset: ``snd_pcm_open`` + ``snd_pcm_set_params`` +
``snd_pcm_readi``/``snd_pcm_writei`` with float32 interleaved frames. Real
sound hardware works wherever libasound is installed; the test suite compiles
a fake libasound (tests/fake_alsa.cpp) implementing the same symbols, so
open/configure/read/write is exercised on machines with no audio at all.

Registered as ``AudioSource/AudioSink(backend="alsa")`` via :func:`register`.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from ..core.errors import GrError
from .audio import AudioBackend, register_audio_backend

SND_PCM_STREAM_PLAYBACK = 0
SND_PCM_STREAM_CAPTURE = 1
SND_PCM_FORMAT_FLOAT_LE = 14
SND_PCM_ACCESS_RW_INTERLEAVED = 3


class AlsaBackend(AudioBackend):
    def __init__(self, device: str = "default", lib_path: str | None = None,
                 latency_us: int = 100_000):
        path = lib_path or ctypes.util.find_library("asound")
        if path is None:
            raise GrError("libasound not found — install ALSA or pass lib_path")
        try:
            self.lib = ctypes.CDLL(path)
        except OSError as e:
            raise GrError(f"cannot load libasound from {path!r}: {e}") from e
        lib = self.lib
        lib.snd_pcm_open.restype = ctypes.c_int
        lib.snd_pcm_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int]
        lib.snd_pcm_set_params.restype = ctypes.c_int
        lib.snd_pcm_set_params.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
            ctypes.c_uint, ctypes.c_int, ctypes.c_uint]
        lib.snd_pcm_readi.restype = ctypes.c_long
        lib.snd_pcm_readi.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_ulong]
        lib.snd_pcm_writei.restype = ctypes.c_long
        lib.snd_pcm_writei.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_ulong]
        lib.snd_pcm_recover.restype = ctypes.c_int
        lib.snd_pcm_recover.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
        lib.snd_pcm_close.restype = ctypes.c_int
        lib.snd_pcm_close.argtypes = [ctypes.c_void_p]
        self.device = device
        self.latency_us = latency_us
        self._pcm = ctypes.c_void_p()
        self.channels = 1

    def _open(self, stream: int, sample_rate: float, channels: int) -> None:
        rc = self.lib.snd_pcm_open(ctypes.byref(self._pcm),
                                   self.device.encode(), stream, 0)
        if rc < 0:
            raise GrError(f"snd_pcm_open({self.device!r}) failed: {rc}")
        rc = self.lib.snd_pcm_set_params(
            self._pcm, SND_PCM_FORMAT_FLOAT_LE, SND_PCM_ACCESS_RW_INTERLEAVED,
            max(1, channels), int(sample_rate), 1, self.latency_us)
        if rc < 0:
            raise GrError(f"snd_pcm_set_params failed: {rc}")
        self.rate = float(sample_rate)
        self.channels = max(1, channels)

    def open_capture(self, sample_rate, channels):
        self._open(SND_PCM_STREAM_CAPTURE, sample_rate, channels)

    def open_playback(self, sample_rate, channels):
        self._open(SND_PCM_STREAM_PLAYBACK, sample_rate, channels)

    def read(self, n):
        buf = np.empty((n, self.channels), np.float32)   # interleaved frames
        got = self.lib.snd_pcm_readi(self._pcm, buf.ctypes.data, n)
        if got < 0:
            if self.lib.snd_pcm_recover(self._pcm, int(got), 1) < 0:
                return None   # unrecoverable → EOS
            return np.zeros((self.channels, 0) if self.channels > 1 else (0,),
                            np.float32)
        frames = buf[:got]
        return frames[:, 0] if self.channels == 1 else frames.T.copy()

    def write(self, samples):
        x = np.asarray(samples, np.float32)
        frames = x[:, None] if x.ndim == 1 else np.ascontiguousarray(x.T)
        wrote = self.lib.snd_pcm_writei(self._pcm, frames.ctypes.data,
                                        frames.shape[0])
        if wrote < 0:
            self.lib.snd_pcm_recover(self._pcm, int(wrote), 1)

    def close(self):
        if self._pcm:
            self.lib.snd_pcm_close(self._pcm)
            self._pcm = ctypes.c_void_p()


def register(lib_path: str | None = None, device: str = "default") -> None:
    register_audio_backend(
        "alsa", lambda **kw: AlsaBackend(device=kw.get("device", device),
                                         lib_path=lib_path))


try:                          # best-effort: register when libasound exists
    import ctypes.util as _u
    if _u.find_library("asound"):
        register()
except Exception:
    pass
