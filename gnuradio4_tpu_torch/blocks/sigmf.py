"""SigMF (Signal Metadata Format) recording support.

The SDR ecosystem's standard on-disk recording format (gr-sigmf in GNU
Radio): a raw `.sigmf-data` sample file paired with a `.sigmf-meta` JSON
document — `global` (datatype, sample rate, description), `captures`
(per-segment center frequency / timestamp / sample-index) and `annotations`
(labelled sample ranges). Spec: https://sigmf.org (v1.0.0 core namespace).

:class:`SigmfSink` records a stream: the capture segment carries the
flowgraph sample rate and any `frequency` tag it sees; stream tags with string
payloads become annotations anchored at their absolute sample index.
:class:`SigmfSource` plays a recording back, re-emitting the capture metadata
as stream tags (sample_rate / frequency at the capture boundaries, annotation
labels at their sample index) — so a recorded flowgraph resumes with its tag
sideband intact. The source maps the data file and reads one step of it per
feed (the page cache serves it), converting the integer IQ types on the way
(``ci16_le`` through ``native/convert.py``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.tags import Keys, Tag
from ..native import convert as cv

SIGMF_VERSION = "1.0.0"

# SigMF core datatypes (little-endian) ↔ numpy
_DTYPES = {
    "cf64_le": np.complex128, "cf32_le": np.complex64,
    "rf64_le": np.float64, "rf32_le": np.float32,
    "ri32_le": np.int32, "ri16_le": np.int16, "ri8": np.int8,
    "ru32_le": np.uint32, "ru16_le": np.uint16, "ru8": np.uint8,
    "ci16_le": None,       # interleaved int16 I/Q (converted on read/write)
    "ci8": None,           # interleaved int8 I/Q
}
# the interleaved integer IQ types: (wire dtype, full scale on write)
_IQ = {"ci16_le": (np.int16, 32767.0), "ci8": (np.int8, 127.0)}
_TO_SIGMF = {np.dtype(np.complex128): "cf64_le",
             np.dtype(np.complex64): "cf32_le",
             np.dtype(np.float64): "rf64_le",
             np.dtype(np.float32): "rf32_le",
             np.dtype(np.int32): "ri32_le",
             np.dtype(np.int16): "ri16_le",
             np.dtype(np.int8): "ri8",
             np.dtype(np.uint16): "ru16_le",
             np.dtype(np.uint8): "ru8"}


def _paths(base: str) -> tuple[Path, Path]:
    p = Path(base)
    stem = p.with_suffix("") if p.suffix in (".sigmf-data", ".sigmf-meta") \
        else p
    return (stem.with_suffix(".sigmf-data"),
            stem.with_suffix(".sigmf-meta"))


def _iq_to_wire(x: np.ndarray, datatype: str) -> np.ndarray:
    """Complex samples → interleaved integer I/Q, scaled to full scale,
    rounded half to even and clipped."""
    wire, full = _IQ[datatype]
    info = np.iinfo(wire)
    pairs = (x.view(np.float32) if x.dtype == np.complex64
             else np.stack([x.real, x.imag], -1).ravel())
    return np.clip(np.round(pairs * full), info.min, info.max).astype(wire)


def _wire_to_iq(raw: np.ndarray, datatype: str) -> np.ndarray:
    """Interleaved integer I/Q → complex64 (÷32768 for ci16_le, ÷128 for ci8)."""
    if datatype == "ci16_le":
        return cv.i16iq_to_c64(raw)
    f = raw[: raw.size // 2 * 2].astype(np.float32) / np.float32(128.0)
    return f.view(np.complex64)


def _meta(datatype: str, sample_rate: float, description: str,
          frequency: float | None, annotations: list[dict]) -> dict:
    capture: dict = {"core:sample_start": 0}
    if frequency is not None:
        capture["core:frequency"] = float(frequency)
    return {
        "global": {"core:datatype": datatype,
                   "core:sample_rate": float(sample_rate),
                   "core:version": SIGMF_VERSION,
                   **({"core:description": description} if description else {})},
        "captures": [capture],
        "annotations": list(annotations),
    }


def _read_meta(base: str) -> dict:
    meta = json.loads(_paths(base)[1].read_text())
    dt_name = meta["global"]["core:datatype"]
    if dt_name not in _DTYPES:
        raise GrError(f"sigmf: unsupported datatype {dt_name!r}")
    return meta


def read_sigmf(base: str) -> tuple[np.ndarray, dict]:
    """Load a recording: (samples, meta dict)."""
    meta = _read_meta(base)
    dt_name = meta["global"]["core:datatype"]
    data_p = _paths(base)[0]
    if dt_name in _IQ:
        return _wire_to_iq(np.fromfile(data_p, _IQ[dt_name][0]), dt_name), meta
    return np.fromfile(data_p, _DTYPES[dt_name]), meta


def write_sigmf(base: str, samples: np.ndarray, *, sample_rate: float,
                frequency: float | None = None,
                description: str = "", annotations: list[dict] = (),
                datatype: str | None = None) -> None:
    """Write a recording (one capture segment starting at sample 0)."""
    data_p, meta_p = _paths(base)
    x = np.asarray(samples)
    if datatype in _IQ:
        _iq_to_wire(x, datatype).tofile(data_p)
        dt_name = datatype
    else:
        dt_name = datatype or _TO_SIGMF.get(x.dtype)
        if dt_name is None:
            raise GrError(f"sigmf: cannot map dtype {x.dtype} — pass "
                          f"datatype= explicitly")
        x.tofile(data_p)
    meta_p.write_text(json.dumps(
        _meta(dt_name, sample_rate, description, frequency, annotations),
        indent=2))


@register_block("SigmfSink")
class SigmfSink(SinkBlock):
    """Records a stream as a SigMF pair. The capture segment gets the
    flowgraph sample rate; a `frequency` tag (e.g. from an SDR source)
    fills `core:frequency`; string-payload tags become annotations at
    their absolute sample index.

    ``datatype`` (a constructor argument, as :func:`write_sigmf` takes it)
    stores a complex stream as ``ci16_le`` or ``ci8``; by default the
    stream's own dtype names the SigMF type."""

    IN = (Port("in"),)
    path = Setting(default="", kind="static",
                   description="base path ('.sigmf-data/-meta' appended)")
    description = Setting(default="", kind="static")
    sample_rate = Setting(default=0.0, kind="static",
                          description="0 = take the rate from the connected "
                                      "edge / sample_rate tags")

    def __init__(self, name=None, datatype: str | None = None, **settings):
        super().__init__(name=name, **settings)
        if datatype is not None and datatype not in _IQ:
            raise GrError(f"{self.name}: datatype {datatype!r} is not one of "
                          f"{sorted(_IQ)} (other types follow the stream)")
        self._datatype = datatype
        self._f = None
        self._dtype = None
        self._sample_rate = 0.0
        self._frequency: float | None = None
        self._annotations: list[dict] = []
        self.n_written = 0

    def start(self):
        data_p, _ = _paths(str(self.settings.get("path")))
        self._f = open(data_p, "wb")
        self.n_written = 0
        self._annotations = []
        self._frequency = None

    def consume(self, arrays, tags, n_valid, abs_index):
        if self._f is None:
            self.start()
        data = np.ascontiguousarray(arrays["in"][..., :n_valid])
        if self._dtype is None:
            self._dtype = data.dtype
        for t in tags.get("in", []):
            if Keys.SAMPLE_RATE in t.map:
                self._sample_rate = float(t.map[Keys.SAMPLE_RATE])
            if "frequency" in t.map:
                self._frequency = float(t.map["frequency"])
            for k, v in t.map.items():
                if isinstance(v, str) and k not in (Keys.CONTEXT,):
                    self._annotations.append({
                        "core:sample_start": int(abs_index + t.index),
                        "core:sample_count": 1,
                        "core:label": f"{k}={v}"})
        if self._datatype is not None:
            data = _iq_to_wire(data, self._datatype)
        self._f.write(data.tobytes())
        self.n_written += n_valid

    def stop(self):
        if self._f is None:
            return
        self._f.close()
        self._f = None
        if not self._sample_rate:
            self._sample_rate = float(self.settings.get("sample_rate"))
        if not self._sample_rate and self._graph is not None:
            # the rate solver stamped every edge (Graph.resolve_rates)
            for e in self._graph.edges:
                if e.dst is self and getattr(e, "sample_rate", 0.0):
                    self._sample_rate = float(e.sample_rate)
                    break
        _, meta_p = _paths(str(self.settings.get("path")))
        dt_name = self._datatype or _TO_SIGMF.get(
            np.dtype(self._dtype or np.float32), "rf32_le")
        meta_p.write_text(json.dumps(
            _meta(dt_name, self._sample_rate,
                  str(self.settings.get("description") or ""), self._frequency,
                  self._annotations), indent=2))


@register_block("SigmfSource")
class SigmfSource(SourceBlock):
    """Plays a SigMF recording; capture metadata re-enters the flowgraph as
    stream tags (sample_rate + frequency at each capture's sample_start,
    annotation labels at their index)."""

    OUT = (Port("out"),)
    FEED = True
    path = Setting(default="", kind="static")
    repeat = Setting(default=False, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._raw: np.ndarray | None = None    # the data file, mapped
        self._per_sample = 1                   # wire items per sample
        self._meta: dict = {}

    def out_dtype(self, port, in_dtypes):
        base = str(self.settings.get("path"))
        if base:
            try:                        # meta only — never scan the data
                _, meta_p = _paths(base)
                meta = json.loads(meta_p.read_text())
                name = meta["global"]["core:datatype"]
                if name in _IQ:
                    return "complex64"
                dt = _DTYPES.get(name)
                if dt is not None:
                    return str(np.dtype(dt))
            except (OSError, KeyError, ValueError):
                pass
        return "float32"

    def start(self):
        base = str(self.settings.get("path"))
        data_p, meta_p = _paths(base)
        if not meta_p.is_file():
            raise GrError(f"{self.name}: no such recording {base!r}")
        self._meta = _read_meta(base)
        name = self._meta["global"]["core:datatype"]
        wire = _IQ[name][0] if name in _IQ else _DTYPES[name]
        self._per_sample = 2 if name in _IQ else 1
        self._raw = (np.memmap(data_p, dtype=wire, mode="r")
                     if data_p.stat().st_size else np.zeros(0, wire))

    @property
    def sample_rate(self) -> float:
        return float(self._meta.get("global", {})
                     .get("core:sample_rate", 0.0))

    def _samples(self, lo: int, n: int) -> np.ndarray:
        """Samples [lo, lo + n) of the recording (fewer at its end), read
        from the mapped file and converted."""
        k = self._per_sample
        raw = self._raw[lo * k:(lo + n) * k]
        name = self._meta["global"]["core:datatype"]
        return _wire_to_iq(raw, name) if name in _IQ else np.array(raw)

    def host_feed(self, n, abs_index):
        if self._raw is None:
            self.start()
        total = len(self._raw) // self._per_sample
        if bool(self.settings.get("repeat")) and total:
            pieces, pos = [], abs_index % total
            while sum(len(p) for p in pieces) < n:
                pieces.append(self._samples(pos, n - sum(len(p) for p in pieces)))
                pos = 0
            return {"out": np.concatenate(pieces)}, n
        if abs_index >= total:
            return None
        chunk = self._samples(abs_index, n)
        return {"out": chunk}, len(chunk)

    def emit_tags(self, ctx):
        out: list[Tag] = []
        lo = ctx.abs_index
        hi = lo + ctx.out_len.get("out", 0)
        for cap in self._meta.get("captures", []):
            s = int(cap.get("core:sample_start", 0))
            if lo <= s < hi:
                m: dict = {}
                if self.sample_rate:
                    m[Keys.SAMPLE_RATE] = self.sample_rate
                if "core:frequency" in cap:
                    m["frequency"] = float(cap["core:frequency"])
                if m:
                    out.append(Tag(s - lo, m))
        for ann in self._meta.get("annotations", []):
            s = int(ann.get("core:sample_start", 0))
            if lo <= s < hi and "core:label" in ann:
                out.append(Tag(s - lo, {"annotation":
                                        str(ann["core:label"])}))
        return out

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}
