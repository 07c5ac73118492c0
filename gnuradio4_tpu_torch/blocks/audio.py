"""Audio blocks over a backend abstraction (≈ reference blocks/audio/
AudioBlocks.hpp:32,361 AudioSource/AudioSink over AudioBackends.hpp:28 —
libsoundio native + WebAudio backends).

The backend registry ships:
- ``null``: sink discards / source emits silence (paced)
- ``file``: source reads a WAV file, sink writes one (16-bit PCM); the
  ``device`` setting names the file
- ``loopback``: source/sink pairs share an in-memory native ring (tests; ≈
  the reference's headless-CI audio strategy)
- ``alsa`` (``alsa.py``) where libasound loads.
A real device backend plugs in by registering another :class:`AudioBackend`.
"""

from __future__ import annotations

import threading
import time
import wave
from typing import Any

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.errors import GrError
from ..core.feeder import read_exact
from ..core.registry import register_block
from ..core.settings import Setting
from ..native.ring import HostRing


class AudioBackend:
    """Capture/playback interface (≈ AudioBackends.hpp)."""

    def open_capture(self, sample_rate: float, channels: int): ...
    def read(self, n: int) -> np.ndarray | None:
        raise NotImplementedError
    def open_playback(self, sample_rate: float, channels: int): ...
    def write(self, samples: np.ndarray) -> None:
        raise NotImplementedError
    def close(self): ...


class NullAudioBackend(AudioBackend):
    def __init__(self):
        self.rate = 48000.0
        self._t0 = None

    def open_capture(self, sample_rate, channels):
        self.rate = sample_rate
        self.channels = channels

    def read(self, n):
        # paced silence (wall-clock source semantics)
        if self._t0 is None:
            self._t0 = time.monotonic()
            self._served = 0
        target = self._t0 + (self._served + n) / self.rate
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(min(delay, 1.0))
        self._served += n
        shape = (n,) if self.channels <= 1 else (self.channels, n)
        return np.zeros(shape, np.float32)

    def open_playback(self, sample_rate, channels):
        self.rate = sample_rate

    def write(self, samples):
        pass


class LoopbackAudioBackend(AudioBackend):
    """Shared ring: what the sink plays, the source captures."""

    _rings: dict[str, HostRing] = {}
    _pending_readers: dict[str, int] = {}
    _lock = threading.Lock()

    def __init__(self, key: str = "default"):
        self.key = key
        self.channels = 1

    def _ring(self) -> HostRing:
        with self._lock:
            if self.key not in self._rings:
                ring = HostRing(1 << 18, np.float32)
                # pre-attach the capture reader so playback written before the
                # capture side opens is retained (writer can't run ahead of it)
                self._pending_readers[self.key] = ring.add_reader()
                self._rings[self.key] = ring
            return self._rings[self.key]

    def open_capture(self, sample_rate, channels):
        self.channels = channels
        ring = self._ring()
        with self._lock:
            rid = self._pending_readers.pop(self.key, None)
        self._reader = rid if rid is not None else ring.add_reader()

    def read(self, n):
        try:
            return read_exact(self._ring(), self._reader, n, timeout=10.0)
        except TimeoutError:
            return np.zeros(n, np.float32)

    def open_playback(self, sample_rate, channels):
        self.channels = channels

    def write(self, samples):
        self._ring().write(np.asarray(samples, np.float32).ravel())

    def close(self):
        self._ring().set_eos()


class FileAudioBackend(AudioBackend):
    """A WAV file as the device: capture reads it (16-bit PCM → float32 ÷32768,
    the end of the file is the end of the stream), playback writes it
    (float32 → 16-bit PCM ×32768, rounded and clipped, as WavSink does)."""

    def __init__(self, path: str):
        if not path or path == "default":
            raise GrError("audio backend 'file' needs the WAV path as device=")
        self.path = path
        self.channels = 1
        self._data: np.ndarray | None = None
        self._pos = 0
        self._w = None

    def open_capture(self, sample_rate, channels):
        with wave.open(self.path, "rb") as w:
            if w.getsampwidth() != 2:
                raise GrError(f"{self.path}: {8 * w.getsampwidth()}-bit WAV; "
                              f"the file backend reads 16-bit PCM")
            self.channels = w.getnchannels()
            self.rate = float(w.getframerate())
            raw = w.readframes(w.getnframes())
        x = np.frombuffer(raw, "<i2").astype(np.float32) / np.float32(32768.0)
        self._data = x.reshape(-1, self.channels).T
        self._pos = 0

    def read(self, n):
        if self._pos >= self._data.shape[-1]:
            return None
        x = self._data[:, self._pos:self._pos + n]
        self._pos += x.shape[-1]
        return x[0].copy() if self.channels == 1 else x.copy()

    def open_playback(self, sample_rate, channels):
        self.channels = max(1, channels)
        self._w = wave.open(self.path, "wb")
        self._w.setnchannels(self.channels)
        self._w.setsampwidth(2)
        self._w.setframerate(int(sample_rate))

    def write(self, samples):
        pcm = np.clip(np.round(np.asarray(samples, np.float32) * 32768.0),
                      -32768, 32767).astype("<i2")
        self._w.writeframes((pcm.T if pcm.ndim == 2 else pcm).tobytes())

    def close(self):
        if self._w is not None:
            self._w.close()
            self._w = None


_BACKENDS = {
    "null": NullAudioBackend,
    "file": FileAudioBackend,
    "loopback": LoopbackAudioBackend,
}


def _backend_kwargs(block) -> dict[str, Any]:
    """The backend's constructor arguments from a block's ``device``."""
    dev = str(block.settings.get("device"))
    return {"loopback": {"key": dev}, "file": {"path": dev}}.get(
        str(block.settings.get("backend")), {})


def register_audio_backend(name: str, factory) -> None:
    _BACKENDS[name] = factory


def make_backend(name: str, **kw) -> AudioBackend:
    try:
        return _BACKENDS[name](**kw)
    except KeyError:
        raise GrError(f"unknown audio backend {name!r}; have {sorted(_BACKENDS)}")


@register_block("AudioSource")
class AudioSource(SourceBlock):
    OUT = (Port("out", dtype="float32"),)
    FEED = True
    backend = Setting(default="null", kind="static")
    device = Setting(default="default", kind="static")
    sample_rate = Setting(default=48000.0, kind="static")
    channels = Setting(default=1, kind="static")
    n_samples = Setting(default=0, kind="static")

    def __init__(self, name=None, backend_obj: AudioBackend | None = None,
                 **settings):
        super().__init__(name=name, **settings)
        self._backend = backend_obj
        self._served = 0

    def out_channels(self, port, in_channels):
        c = int(self.settings.get("channels"))
        return 0 if c <= 1 else c

    def start(self):
        if self._backend is None:
            self._backend = make_backend(str(self.settings.get("backend")),
                                         **_backend_kwargs(self))
        self._backend.open_capture(float(self.settings.get("sample_rate")),
                                   int(self.settings.get("channels")))

    def host_feed(self, n, abs_index):
        if self._backend is None:
            self.start()
        total = int(self.settings.get("n_samples"))
        if total and abs_index >= total:
            return None
        got = self._backend.read(n)
        if got is None:
            return None
        nv = got.shape[-1]
        if total:
            nv = min(nv, total - abs_index)
        return {"out": got}, nv

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}

    def stop(self):
        if self._backend:
            self._backend.close()


@register_block("AudioSink")
class AudioSink(SinkBlock):
    IN = (Port("in", dtype="float32"),)
    backend = Setting(default="null", kind="static")
    device = Setting(default="default", kind="static")
    sample_rate = Setting(default=48000.0, kind="static")

    def __init__(self, name=None, backend_obj: AudioBackend | None = None,
                 **settings):
        super().__init__(name=name, **settings)
        self._backend = backend_obj
        self.n_played = 0

    def consume(self, arrays, tags, n_valid, abs_index):
        if self._backend is None:
            self._backend = make_backend(str(self.settings.get("backend")),
                                         **_backend_kwargs(self))
            x = arrays["in"]
            ch = 1 if x.ndim == 1 else x.shape[0]
            self._backend.open_playback(float(self.settings.get("sample_rate")), ch)
        self._backend.write(arrays["in"][..., :n_valid])
        self.n_played += n_valid

    def stop(self):
        if self._backend:
            self._backend.close()
