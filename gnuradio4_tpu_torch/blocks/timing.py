"""GPS/PPS timing blocks over NMEA-0183 (≈ reference blocks/timing/: GpsSource,
PpsSource over NMEADevice.hpp).

NMEA sentence parsing (RMC/GGA, checksum-verified) + a device abstraction whose
test double replays canned sentences; sources emit timing tags (trigger_time /
local_time) on a 1 Hz cadence like a GPS PPS. Parsing and tags live on the
host; the sources' uint8 sample stream is made on the graph's device.
"""

from __future__ import annotations

import datetime as _dt
import time
from typing import Any, Iterable

import numpy as np
import torch

from ..core.block import Port, SourceBlock
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.tags import Keys, Tag


def nmea_checksum_ok(sentence: str) -> bool:
    s = sentence.strip()
    if not s.startswith("$") or "*" not in s:
        return False
    body, _, chk = s[1:].partition("*")
    calc = 0
    for ch in body:
        calc ^= ord(ch)
    try:
        return calc == int(chk[:2], 16)
    except ValueError:
        return False


def _parse_latlon(value: str, hemi: str) -> float | None:
    if not value:
        return None
    head, minutes = divmod(float(value), 100.0)
    deg = head + minutes / 60.0
    if hemi in ("S", "W"):
        deg = -deg
    return deg


def parse_nmea(sentence: str) -> dict[str, Any] | None:
    """Parse RMC/GGA sentences → {type, time, date?, lat, lon, fix/valid, ...}."""
    if not nmea_checksum_ok(sentence):
        return None
    body = sentence.strip()[1:].partition("*")[0]
    parts = body.split(",")
    talker = parts[0]
    out: dict[str, Any] = {"type": talker[-3:]}
    try:
        if talker.endswith("RMC"):
            out["valid"] = parts[2] == "A"
            if parts[1]:
                out["time"] = parts[1]
            out["lat"] = _parse_latlon(parts[3], parts[4])
            out["lon"] = _parse_latlon(parts[5], parts[6])
            out["speed_kn"] = float(parts[7]) if parts[7] else None
            if parts[9]:
                out["date"] = parts[9]
        elif talker.endswith("GGA"):
            if parts[1]:
                out["time"] = parts[1]
            out["lat"] = _parse_latlon(parts[2], parts[3])
            out["lon"] = _parse_latlon(parts[4], parts[5])
            out["fix_quality"] = int(parts[6]) if parts[6] else 0
            out["n_satellites"] = int(parts[7]) if parts[7] else 0
            out["altitude_m"] = float(parts[9]) if parts[9] else None
        else:
            return None
    except (ValueError, IndexError):
        return None
    if "time" in out and "date" in out:
        try:
            t = out["time"]; d = out["date"]
            yy = int(d[4:6])
            year = 1900 + yy if yy >= 80 else 2000 + yy  # NMEA 2-digit pivot
            dt = _dt.datetime(year, int(d[2:4]), int(d[0:2]),
                              int(t[0:2]), int(t[2:4]), int(float(t[4:])),
                              tzinfo=_dt.timezone.utc)
            out["utc"] = dt.timestamp()
        except ValueError:
            pass
    return out


class NmeaDevice:
    """Serial-ish NMEA sentence stream interface."""

    def readline(self) -> str | None:
        raise NotImplementedError

    def close(self): ...


class ReplayNmeaDevice(NmeaDevice):
    """Test double replaying canned sentences (optionally wall-clock paced)."""

    def __init__(self, sentences: Iterable[str], paced: bool = False,
                 interval_s: float = 1.0):
        self._it = iter(sentences)
        self.paced = paced
        self.interval = interval_s

    def readline(self):
        if self.paced:
            time.sleep(self.interval)
        return next(self._it, None)


@register_block("GpsSource")
class GpsSource(SourceBlock):
    """GPS timing source: uint8 placeholder stream + per-fix timing tags
    (trigger_name='gps_pps', trigger_time=UTC, lat/lon in the tag map)."""

    OUT = (Port("out", dtype="uint8"),)
    FEED = True
    sample_rate = Setting(default=1000.0, kind="static", unit="Hz")
    n_samples = Setting(default=0, kind="static")

    def __init__(self, name=None, device: NmeaDevice | None = None, **settings):
        super().__init__(name=name, **settings)
        self._dev = device
        self._fixes: list[dict] = []
        self.last_fix: dict | None = None
        self._eof = False

    def host_feed(self, n, abs_index):
        total = int(self.settings.get("n_samples"))
        if (total and abs_index >= total) or (self._eof and self._dev is None):
            return None
        # drain one sentence per step (1 fix/second nominal cadence)
        if self._dev is not None:
            line = self._dev.readline()
            if line is None:
                self._eof = True
                if total == 0:
                    return None
            else:
                fix = parse_nmea(line)
                if fix and (fix.get("valid", True)):
                    fix["_abs_index"] = abs_index
                    self._fixes.append(fix)
                    self.last_fix = fix
        nv = n if not total else min(n, total - abs_index)
        return {"out": np.zeros(n, np.uint8)}, nv

    def emit_tags(self, ctx):
        out = []
        for fix in self._fixes:
            m = {Keys.TRIGGER_NAME: "gps_pps"}
            if "utc" in fix:
                m[Keys.TRIGGER_TIME] = fix["utc"]
                m[Keys.LOCAL_TIME] = fix["utc"]
            for k in ("lat", "lon", "altitude_m", "n_satellites"):
                if fix.get(k) is not None:
                    m[k] = fix[k]
            out.append(Tag(max(0, fix["_abs_index"] - ctx.abs_index), m))
        self._fixes.clear()
        return out

    def apply(self, state, ins, ctx):
        # the feed only paces the step; the samples are zeros on the device
        n = ctx.out_len["out"]
        return state, {"out": torch.zeros(n, dtype=torch.uint8, device=ctx.device)}


@register_block("PpsSource")
class PpsSource(SourceBlock):
    """1-pulse-per-second source: emits a trigger tag every ``sample_rate``
    samples (deterministic sample-clock PPS; ≈ PpsSource)."""

    OUT = (Port("out", dtype="uint8"),)
    sample_rate = Setting(default=1000.0, kind="static", unit="Hz")
    n_samples = Setting(default=0, kind="static")

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def emit_tags(self, ctx):
        fs = int(float(self.settings.get("sample_rate")))
        n = next(iter(ctx.out_len.values()), 0)
        lo, hi = ctx.abs_index, ctx.abs_index + n
        total = int(self.settings.get("n_samples"))
        if total:
            hi = min(hi, total)
        first = ((lo + fs - 1) // fs) * fs
        out = []
        for idx in range(first, hi, fs):
            out.append(Tag(idx - lo, {Keys.TRIGGER_NAME: "pps",
                                      Keys.TRIGGER_TIME: idx / fs}))
        return out

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        return state, {"out": torch.zeros(n, dtype=torch.uint8, device=ctx.device)}
