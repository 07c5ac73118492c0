"""URI-based IO factory (≈ reference algorithm/fileio/FileIo.hpp: URI-addressed
file/HTTP(S) sources & sinks).

``source_for_uri`` / ``sink_for_uri`` route a URI to the right block:

    file:///data/capture.f32?dtype=float32&repeat=1
    file:///data/iq.dat?wire_format=i16iq
    http://host:8080/stream?parse=bytes&dtype=float32
    wav:///music.wav          (or any file path ending .wav)
    audio://loopback/devname
    sdr://loopback?sample_rate=1e6&center_frequency=100e6
"""

from __future__ import annotations

import urllib.parse
from typing import Any

from ..core.block import Block
from ..core.errors import GrError


def _q(query: str) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in urllib.parse.parse_qsl(query):
        try:
            fv = float(v)
            out[k] = int(fv) if fv.is_integer() and "." not in v and "e" not in v.lower() else fv
        except ValueError:
            out[k] = {"1": True, "true": True, "0": False,
                      "false": False}.get(v.lower(), v)
    return out


def source_for_uri(uri: str, **overrides: Any) -> Block:
    from .fileio import FileSource, WavSource
    from .http import HttpSource
    from .audio import AudioSource
    from .sdr import SdrSource

    p = urllib.parse.urlparse(uri)
    kw = {**_q(p.query), **overrides}
    scheme = p.scheme or "file"
    path = (p.netloc + p.path) if scheme in ("file", "wav") else uri.split("?")[0]
    if scheme == "file":
        if path.lower().endswith(".wav"):
            return WavSource(path=path, **kw)
        return FileSource(path=path, **kw)
    if scheme == "wav":
        return WavSource(path=path, **kw)
    if scheme in ("http", "https"):
        return HttpSource(url=uri.split("?", 1)[0] if "parse" in kw or "dtype"
                          in kw else uri, **kw)
    if scheme == "audio":
        return AudioSource(backend=p.netloc or "null",
                           device=p.path.lstrip("/") or "default", **kw)
    if scheme == "sdr":
        return SdrSource(driver=p.netloc or "loopback", **kw)
    raise GrError(f"no source for URI scheme {scheme!r} ({uri})")


def sink_for_uri(uri: str, **overrides: Any) -> Block:
    from .fileio import FileSink, WavSink
    from .http import HttpSink
    from .audio import AudioSink
    from .sdr import SdrSink

    p = urllib.parse.urlparse(uri)
    kw = {**_q(p.query), **overrides}
    scheme = p.scheme or "file"
    path = (p.netloc + p.path) if scheme in ("file", "wav") else uri.split("?")[0]
    if scheme == "file":
        if path.lower().endswith(".wav"):
            return WavSink(path=path, **kw)
        return FileSink(path=path, **kw)
    if scheme == "wav":
        return WavSink(path=path, **kw)
    if scheme in ("http", "https"):
        return HttpSink(url=uri.split("?", 1)[0], **kw)
    if scheme == "audio":
        return AudioSink(backend=p.netloc or "null",
                         device=p.path.lstrip("/") or "default", **kw)
    if scheme == "sdr":
        return SdrSink(driver=p.netloc or "loopback", **kw)
    raise GrError(f"no sink for URI scheme {scheme!r} ({uri})")
