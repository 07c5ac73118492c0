"""DataSet — multi-signal container (≈ reference core DataSet.hpp:89).

Same information model as the reference: n-D extents, axis descriptions (names /
units / values), per-signal metadata (name, unit, quantity, range), the sample
matrix, and timing events (index→property-map pairs). Used by spectrum blocks,
StreamToDataSet windows, and DataSink snapshot delivery.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .tags import Tag


@dataclasses.dataclass
class Axis:
    name: str = ""
    unit: str = ""
    values: np.ndarray | None = None  # e.g. frequency bins, time stamps


@dataclasses.dataclass
class SignalMeta:
    name: str = ""
    unit: str = ""
    quantity: str = ""
    range_min: float = float("nan")
    range_max: float = float("nan")


@dataclasses.dataclass
class DataSet:
    """Multi-signal sample container.

    ``values``: [n_signals, *extents] array; ``axes``: one per extent dimension;
    ``timing_events``: per-signal lists of (index, map) tags.
    """

    values: np.ndarray
    axes: list[Axis] = dataclasses.field(default_factory=list)
    signals: list[SignalMeta] = dataclasses.field(default_factory=list)
    timing_events: list[list[Tag]] = dataclasses.field(default_factory=list)
    timestamp_ns: int = 0
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.values = np.asarray(self.values)
        if self.values.ndim == 1:
            self.values = self.values[None, :]
        n_sig = self.values.shape[0]
        while len(self.signals) < n_sig:
            self.signals.append(SignalMeta(name=f"signal{len(self.signals)}"))
        while len(self.timing_events) < n_sig:
            self.timing_events.append([])
        if not self.axes:
            self.axes = [Axis(name="index",
                              values=np.arange(self.values.shape[-1]))]

    @property
    def extents(self) -> tuple[int, ...]:
        return self.values.shape[1:]

    @property
    def n_signals(self) -> int:
        return self.values.shape[0]

    def signal(self, key: int | str) -> np.ndarray:
        return self.values[self._index(key)]

    def signal_meta(self, key: int | str) -> SignalMeta:
        return self.signals[self._index(key)]

    def _index(self, key: int | str) -> int:
        if isinstance(key, int):
            return key
        for i, s in enumerate(self.signals):
            if s.name == key:
                return i
        raise KeyError(f"no signal named {key!r}; "
                       f"have {[s.name for s in self.signals]}")

    def updated_range(self, key: int | str = 0) -> "DataSet":
        i = self._index(key)
        v = self.values[i]
        self.signals[i].range_min = float(np.min(v.real))
        self.signals[i].range_max = float(np.max(v.real))
        return self

    def check_consistency(self, name: str = "unnamed") -> None:
        """Structural validation (≈ dataset::checkConsistency,
        DataSetHelper.hpp:183): positive extents, one axis (with matching
        value count) per extent dimension, and per-signal metadata/timing
        arrays sized to the signal count. Raises ``GrError`` on mismatch."""
        from .errors import GrError

        def fail(msg: str):
            raise GrError(f"Mismatch in DataSet-{name!r}: {msg}")

        ext = self.extents
        if any(e <= 0 for e in ext):
            fail(f"found 0 or negative extent values {list(ext)}")
        if len(self.axes) != len(ext):
            fail(f"nDimensions()={len(ext)} != axisCount()={len(self.axes)}")
        for i, (ax, e) in enumerate(zip(self.axes, ext)):
            if ax.values is not None and len(ax.values) != e:
                fail(f"axisValues({i}) size={len(ax.values)} != "
                     f"extents[{i}]={e}")
        n_sig = self.n_signals
        if len(self.signals) != n_sig:
            fail(f"signal metadata size={len(self.signals)} != "
                 f"number_of_signals={n_sig}")
        if len(self.timing_events) != n_sig:
            fail(f"timing_events.size()={len(self.timing_events)} != "
                 f"number_of_signals={n_sig}")
        expected = int(np.prod(ext)) * n_sig
        if self.values.size != expected:
            fail(f"signal_values.size()={self.values.size} != "
                 f"product_of_extents*n_signals={expected}")

    @classmethod
    def from_stream(cls, samples: np.ndarray, *, sample_rate: float = 1.0,
                    signal_name: str = "signal", unit: str = "",
                    start_index: int = 0, tags: list[Tag] | None = None
                    ) -> "DataSet":
        n = samples.shape[-1]
        t_axis = Axis(name="time", unit="s",
                      values=(start_index + np.arange(n)) / sample_rate)
        ds = cls(values=np.atleast_2d(samples), axes=[t_axis],
                 signals=[SignalMeta(name=signal_name, unit=unit)],
                 timing_events=[list(tags or [])])
        return ds.updated_range(0)

    @classmethod
    def spectrum(cls, mag: np.ndarray, *, sample_rate: float, signal_name: str
                 = "spectrum", unit: str = "dB", shifted: bool = False) -> "DataSet":
        n = mag.shape[-1]
        f = np.fft.fftfreq(n, 1.0 / sample_rate)
        if shifted:
            f = np.fft.fftshift(f)
        return cls(values=np.atleast_2d(mag),
                   axes=[Axis(name="frequency", unit="Hz", values=f)],
                   signals=[SignalMeta(name=signal_name, unit=unit)]
                   ).updated_range(0)
