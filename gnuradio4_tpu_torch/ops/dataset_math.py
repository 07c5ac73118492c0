"""DataSet-domain math, windowed filters, utilities and test generators.

Host-side transforms over :class:`~gnuradio4_tpu_torch.core.dataset.DataSet`
(captured windows live on the host once a StreamToDataSet/DataSink delivers
them — the device data path ends at the capture boundary, as in the reference
where DataSet math runs outside the streaming hot loop).

Mirrors:
- ``algorithm/dataset/DataSetMath.hpp:16-120`` — MathOp, sameHorizontalBase,
  mathFunction (DataSet⊗DataSet with interpolation onto ds1's base, and
  DataSet⊗scalar), convenience add/subtract/multiply/divide.
- ``DataSetMath.hpp:131-175`` — computeDerivative, addNoise.
- ``DataSetMath.hpp:177-383`` (namespace filter) — applyMovingAverage,
  applyMedian, applyRms, applyPeakToPeak, applyFilter (forward / symmetric
  zero-phase IIR over signals).
- ``algorithm/dataset/DataSetUtils.hpp:266-377`` — updateMinMax, merge,
  generate::waveform (Sine/Cosine with zero-crossing timing events).
- ``algorithm/dataset/DataSetTestFunctions.hpp`` — from / triangular / ramp /
  gaussFunction / stepFunction / randomStepFunction generators.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np

from ..core.dataset import Axis, DataSet, SignalMeta
from ..core.errors import GrError
from ..core.tags import Tag

__all__ = [
    "MathOp", "same_horizontal_base", "math_function",
    "add_function", "subtract_function", "multiply_function",
    "divide_function", "compute_derivative", "add_noise",
    "apply_moving_average", "apply_median", "apply_rms",
    "apply_peak_to_peak", "apply_filter", "apply_savgol",
    "update_min_max", "merge", "waveform",
    "dataset_from", "triangular", "ramp", "gauss_function",
    "step_function", "random_step_function",
]


class MathOp(enum.Enum):
    """≈ gr::dataset::MathOp (DataSetMath.hpp:16)."""

    ADD = 0
    SUBTRACT = 1
    MULTIPLY = 2
    DIVIDE = 3
    SQR = 4
    SQRT = 5
    LOG10 = 6
    DB = 7
    INV_DB = 8
    IDENTITY = 9


def _axis0_values(ds: DataSet) -> np.ndarray:
    if not ds.axes or ds.axes[0].values is None:
        return np.arange(ds.values.shape[-1], dtype=np.float64)
    return np.asarray(ds.axes[0].values)


def same_horizontal_base(ds1: DataSet, ds2: DataSet) -> bool:
    """Exact axis-0 equality (DataSetMath.hpp:19 sameHorizontalBase)."""
    x1, x2 = _axis0_values(ds1), _axis0_values(ds2)
    return x1.shape == x2.shape and bool(np.all(x1 == x2))


def _apply_op(op: MathOp, y1: np.ndarray, y2) -> np.ndarray:
    """Elementwise semantics of DataSetMath.hpp:37 applyMathOperation —
    NaN-guarded divide/sqrt, the dB pair being 20·log10 / 10^(x/20)."""
    y2 = np.asarray(y2, dtype=np.result_type(y1, np.float32))
    with np.errstate(divide="ignore", invalid="ignore"):
        if op is MathOp.ADD:
            return y1 + y2
        if op is MathOp.SUBTRACT:
            return y1 - y2
        if op is MathOp.MULTIPLY:
            return y1 * y2
        if op is MathOp.DIVIDE:
            return np.where(y2 == 0, np.nan, y1 / np.where(y2 == 0, 1, y2))
        s = y1 + y2
        if op is MathOp.SQR:
            return s * s
        if op is MathOp.SQRT:
            return np.where(s > 0, np.sqrt(np.abs(s)), np.nan)
        if op is MathOp.LOG10:
            return np.where(s > 0, 10.0 * np.log10(np.abs(np.where(s <= 0, 1, s))),
                            np.nan)
        if op is MathOp.DB:
            return np.where(s > 0, 20.0 * np.log10(np.abs(np.where(s <= 0, 1, s))),
                            np.nan)
        if op is MathOp.INV_DB:
            return np.power(10.0, y1 / 20.0)
        return s if op is MathOp.IDENTITY else s


def math_function(ds1: DataSet, other, op: MathOp = MathOp.ADD,
                  signal_index: int = 0) -> DataSet:
    """``mathFunction(DataSet, DataSet|scalar, MathOp)``.

    DataSet⊗DataSet (DataSetMath.hpp:59): when the horizontal bases differ,
    ds2's signal is linearly interpolated onto ds1's axis before the op.
    DataSet⊗scalar (DataSetMath.hpp:97): the scalar joins via ``y1 op v``
    for the binary ops and via ``y1 + v`` feeding the unary tail, exactly
    as the reference's switch does.
    """
    y1 = np.asarray(ds1.values[signal_index], dtype=np.float64)
    if isinstance(other, DataSet):
        if same_horizontal_base(ds1, other):
            y2 = np.asarray(other.values[signal_index], dtype=np.float64)
        else:
            x1 = _axis0_values(ds1).astype(np.float64)
            x2 = _axis0_values(other).astype(np.float64)
            y2 = np.interp(x1, x2, np.asarray(other.values[signal_index],
                                              dtype=np.float64))
        name = "mathOp"
    else:
        y2 = float(other)
        name = ds1.signals[signal_index].name
    out = _apply_op(op, y1, y2)
    meta0 = ds1.signals[signal_index]
    return DataSet(
        values=out[None, :],
        axes=[dataclasses.replace(a) for a in ds1.axes],
        signals=[SignalMeta(name=name, unit=meta0.unit,
                            quantity=meta0.quantity or "quantity")],
        timing_events=[list(ds1.timing_events[signal_index])],
        timestamp_ns=ds1.timestamp_ns,
        meta=dict(ds1.meta))


def add_function(ds: DataSet, other) -> DataSet:
    return math_function(ds, other, MathOp.ADD)


def subtract_function(ds: DataSet, other) -> DataSet:
    return math_function(ds, other, MathOp.SUBTRACT)


def multiply_function(ds: DataSet, other) -> DataSet:
    return math_function(ds, other, MathOp.MULTIPLY)


def divide_function(ds: DataSet, other) -> DataSet:
    return math_function(ds, other, MathOp.DIVIDE)


def compute_derivative(ds: DataSet, signal_index: int = 0) -> np.ndarray:
    """First difference, length N−1 (DataSetMath.hpp:134 computeDerivative)."""
    sig = np.asarray(ds.values[signal_index])
    if sig.shape[-1] < 2:
        raise GrError("signal must contain at least two samples to compute "
                      "derivative")
    return np.diff(sig)


def add_noise(ds: DataSet, noise_level: float, signal_index: int = 0,
              seed: int = 0) -> DataSet:
    """Uniform ±noise_level additive noise (DataSetMath.hpp:149 addNoise)."""
    if noise_level < 0:
        raise GrError(f"noiseLevel {noise_level} must be a positive number")
    rng = np.random.default_rng(None if seed == 0 else seed)
    out = _copy(ds)
    sig = np.asarray(out.values[signal_index], dtype=np.float64)
    out.values = out.values.astype(np.float64, copy=True)
    out.values[signal_index] = sig + rng.uniform(
        -noise_level, noise_level, size=sig.shape)
    return out


def _copy(ds: DataSet) -> DataSet:
    return DataSet(values=np.array(ds.values, copy=True),
                   axes=[dataclasses.replace(a) for a in ds.axes],
                   signals=[dataclasses.replace(s) for s in ds.signals],
                   timing_events=[list(t) for t in ds.timing_events],
                   timestamp_ns=ds.timestamp_ns, meta=dict(ds.meta))


# -- namespace filter (DataSetMath.hpp:177) ----------------------------------

def _check_window(window_size: int, *, odd: bool = False) -> None:
    if window_size <= 0:
        raise GrError(f"windowSize: {window_size} must be a positive number")
    if odd and window_size % 2 == 0:
        raise GrError("windowSize must be a positive odd number")


def _windowed(signal: np.ndarray, window_size: int, reduce_fn) -> np.ndarray:
    """Centered ragged-edge sliding window, same edge semantics as the
    reference loops (start = max(i−w/2, 0), end = min(i+w/2+1, N))."""
    n = signal.shape[-1]
    half = window_size // 2
    out = np.empty_like(signal, dtype=np.float64)
    for i in range(n):
        s = max(i - half, 0)
        e = min(i + half + 1, n)
        out[i] = reduce_fn(signal[s:e])
    return out


def apply_moving_average(ds: DataSet, window_size: int,
                         signal_index: int = 0) -> DataSet:
    """Centered boxcar mean (DataSetMath.hpp:179 applyMovingAverage)."""
    _check_window(window_size, odd=True)
    out = _copy(ds)
    out.values = out.values.astype(np.float64, copy=True)
    out.values[signal_index] = _windowed(
        np.asarray(ds.values[signal_index], np.float64), window_size, np.mean)
    return out


def apply_median(ds: DataSet, window_size: int, signal_index: int = 0
                 ) -> DataSet:
    """Centered running median; even windows average the two mid order
    statistics (DataSetMath.hpp:199 applyMedian)."""
    _check_window(window_size)

    def med(w):
        k = w.shape[-1]
        sw = np.sort(w)
        if k % 2:
            return sw[k // 2]
        return 0.5 * (sw[k // 2 - 1] + sw[k // 2])

    out = _copy(ds)
    out.values = out.values.astype(np.float64, copy=True)
    out.values[signal_index] = _windowed(
        np.asarray(ds.values[signal_index], np.float64), window_size, med)
    return out


def apply_rms(ds: DataSet, window_size: int, signal_index: int = 0) -> DataSet:
    """Windowed standard deviation — sqrt(|E[x²]−E[x]²|), 0 for singleton
    windows (DataSetMath.hpp:241 applyRms)."""
    _check_window(window_size)

    def rms(w):
        if w.shape[-1] <= 1:
            return 0.0
        m = np.mean(w)
        return float(np.sqrt(np.abs(np.mean(w * w) - m * m)))

    out = _copy(ds)
    out.values = out.values.astype(np.float64, copy=True)
    out.values[signal_index] = _windowed(
        np.asarray(ds.values[signal_index], np.float64), window_size, rms)
    return out


def apply_peak_to_peak(ds: DataSet, window_size: int, signal_index: int = 0
                       ) -> DataSet:
    """Windowed max−min (DataSetMath.hpp:280 applyPeakToPeak)."""
    _check_window(window_size)
    out = _copy(ds)
    out.values = out.values.astype(np.float64, copy=True)
    out.values[signal_index] = _windowed(
        np.asarray(ds.values[signal_index], np.float64), window_size,
        lambda w: np.max(w) - np.min(w))
    return out


def _lfilter(b: np.ndarray, a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Direct-form-II-transposed IIR, the host twin of ops.iir (scipy-free)."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    if a[0] != 1.0:
        b, a = b / a[0], a / a[0]
    y = np.empty_like(x, dtype=np.float64)
    z = np.zeros(max(len(a), len(b)) - 1, dtype=np.float64)
    bb = np.concatenate([b, np.zeros(len(z) + 1 - len(b))])
    aa = np.concatenate([a, np.zeros(len(z) + 1 - len(a))])
    for i, xi in enumerate(np.asarray(x, np.float64)):
        yi = bb[0] * xi + z[0]
        for k in range(len(z) - 1):
            z[k] = bb[k + 1] * xi + z[k + 1] - aa[k + 1] * yi
        z[-1] = bb[len(z)] * xi - aa[len(z)] * yi
        y[i] = yi
    return y


def apply_filter(ds: DataSet, coeffs, signal_index: int | None = None,
                 symmetric: bool = False) -> DataSet:
    """Run (b, a) filter coefficients over signals (DataSetMath.hpp:319
    applyFilter). ``symmetric=True`` averages a forward and a time-reversed
    pass (zero-phase, ≈ applySymmetricFilter)."""
    b, a = (np.asarray(coeffs[0], np.float64),
            np.asarray(coeffs[1], np.float64)) if isinstance(coeffs, tuple) \
        else (np.asarray(coeffs, np.float64), np.ones(1))
    out = _copy(ds)
    out.values = out.values.astype(np.float64, copy=True)
    idxs = range(out.n_signals) if signal_index is None else [signal_index]
    for i in idxs:
        x = np.asarray(ds.values[i], np.float64)
        fwd = _lfilter(b, a, x)
        if symmetric:
            bwd = _lfilter(b, a, x[::-1])[::-1]
            fwd = 0.5 * (fwd + bwd)
        out.values[i] = fwd
    return out


def apply_savgol(ds: DataSet, window: int, poly_order: int, deriv: int = 0,
                 boundary: str = "reflect",
                 signal_index: int | None = None) -> DataSet:
    """Zero-phase Savitzky-Golay over DataSet signals (the DataSet-domain
    twin of blocks/filter SavitzkyGolayDataSetFilter.hpp:90): a forward and
    a time-reversed pass of the centred S-G FIR — overall response |H|², no
    phase distortion, peak positions preserved. ``boundary``: 'reflect'
    (mirror) or 'replicate' (edge-extend), ≈ the reference BoundaryPolicy."""
    from .savgol import design_savgol
    if boundary not in ("reflect", "replicate"):
        raise GrError(f"apply_savgol: unknown boundary policy {boundary!r}")
    taps = np.asarray(design_savgol(int(window), int(poly_order),
                                    deriv=int(deriv)), np.float64)
    half = (len(taps) - 1) // 2
    mode = "reflect" if boundary == "reflect" else "edge"

    def one_pass(x, h):
        xp = np.pad(x, (half, len(taps) - 1 - half), mode=mode)
        return np.convolve(xp, h[::-1], mode="valid")

    out = _copy(ds)
    out.values = out.values.astype(np.float64, copy=True)
    idxs = range(out.n_signals) if signal_index is None else [signal_index]
    for i in idxs:
        x = np.asarray(ds.values[i], np.float64)
        out.values[i] = one_pass(one_pass(x, taps)[::-1], taps)[::-1]
    return out


# -- DataSetUtils.hpp ---------------------------------------------------------

def update_min_max(ds: DataSet) -> DataSet:
    """Refresh every SignalMeta range from the data (DataSetUtils.hpp:266)."""
    for i, s in enumerate(ds.signals):
        sig = np.asarray(ds.values[i])
        s.range_min = float(np.min(sig.real))
        s.range_max = float(np.max(sig.real))
    return ds


def merge(first: DataSet, *others: DataSet) -> DataSet:
    """Stack same-base DataSets into one multi-signal DataSet
    (DataSetUtils.hpp:283 merge)."""
    for o in others:
        if not same_horizontal_base(first, o):
            raise GrError("merge: DataSets must share the same horizontal base")
        if o.values.shape[-1] != first.values.shape[-1]:
            raise GrError("merge: signal lengths differ")
    all_ds = (first, *others)
    values = np.concatenate([d.values for d in all_ds], axis=0)
    signals = [dataclasses.replace(s) for d in all_ds for s in d.signals]
    timing = [list(t) for d in all_ds for t in d.timing_events]
    return DataSet(values=values,
                   axes=[dataclasses.replace(a) for a in first.axes],
                   signals=signals, timing_events=timing,
                   timestamp_ns=first.timestamp_ns, meta=dict(first.meta))


def waveform(wave_type: str, length: int, sampling_rate: float,
             frequency: float, amplitude: float = 1.0, offset: float = 0.0
             ) -> DataSet:
    """Sine/Cosine generator with zero-crossing timing events
    (DataSetUtils.hpp:334 generate::waveform)."""
    kind = str(wave_type).lower()
    if kind not in ("sine", "cosine"):
        raise GrError(f"waveform: unknown wave type {wave_type!r}")
    t = np.arange(length, dtype=np.float64) / float(sampling_rate)
    phase = 2.0 * np.pi * frequency * t
    y = offset + amplitude * (np.sin(phase) if kind == "sine"
                              else np.cos(phase))
    events: list[Tag] = []
    prev = offset * amplitude * (0.0 if kind == "sine" else 1.0)
    for i, cur in enumerate(y):
        if (prev < 0 <= cur) or (prev > 0 >= cur):
            events.append(Tag(i, {"type": "Zero Crossing"}))
        prev = cur
    ds = DataSet(values=y[None, :], axes=[Axis(name="Time", unit="s", values=t)],
                 signals=[SignalMeta(name=("Sine Wave" if kind == "sine"
                                           else "Cosine Wave"),
                                     unit="V", quantity="Voltage")],
                 timing_events=[events])
    return update_min_max(ds)


# -- DataSetTestFunctions.hpp -------------------------------------------------

def _test_ds(name: str, y: np.ndarray) -> DataSet:
    ds = DataSet(values=np.asarray(y, np.float64)[None, :],
                 axes=[Axis(name="time", unit="s",
                            values=np.arange(len(y), dtype=np.float64))],
                 signals=[SignalMeta(name=name, unit="a.u.")])
    return update_min_max(ds)


def dataset_from(name: str, values: Sequence[float],
                 uncertainties: Sequence[float] | None = None) -> DataSet:
    """≈ DataSetTestFunctions.hpp:34 from(); uncertainties land in meta."""
    ds = _test_ds(name, np.asarray(values, np.float64))
    if uncertainties is not None:
        ds.meta["uncertainties"] = np.asarray(uncertainties, np.float64)
    return ds


def triangular(name: str, count: int, offset: float = 0.0,
               amplitude: float = 1.0) -> DataSet:
    """Symmetric triangle, exact reference construction
    (DataSetTestFunctions.hpp:75-102): rise over ``count//2`` points with the
    even case peaking twice, odd case peaking once at the centre."""
    if count <= 2:
        raise GrError("triangular: count must be > 2")
    y = np.empty(count, dtype=np.float64)
    mid = count // 2
    denom = mid - (0 if count % 2 else 1)
    for i in range(mid):
        v = offset + amplitude * (i / denom)
        y[i] = v
        y[count - i - 1] = v
    if count % 2:
        y[mid] = offset + amplitude
    return _test_ds(name, y)


def ramp(name: str, count: int, offset: float = 0.0, amplitude: float = 1.0
         ) -> DataSet:
    """Linear ramp ``offset + amplitude·i/count``
    (DataSetTestFunctions.hpp:109-128 — note /count, not /(count−1))."""
    i = np.arange(count, dtype=np.float64)
    y = offset + amplitude * (i / count)
    return _test_ds(name, y)


def gauss_function(name: str, count: int, mean: float = 0.0,
                   sigma: float = 3.0, offset: float = 0.0,
                   amplitude: float = 1.0) -> DataSet:
    """Gaussian bump (DataSetTestFunctions.hpp:134 gaussFunction)."""
    i = np.arange(count, dtype=np.float64)
    y = offset + amplitude * np.exp(-0.5 * ((i - mean) / sigma) ** 2)
    return _test_ds(name, y)


def step_function(name: str, count: int, step_at: int = 0) -> DataSet:
    """0 before ``step_at``, 1 from it; ``step_at=0`` means the midpoint
    (DataSetTestFunctions.hpp:171-184)."""
    if count <= 0:
        raise GrError("step_function: count must be greater than 0")
    if step_at == 0:
        step_at = count // 2
    y = (np.arange(count) >= step_at).astype(np.float64)
    return _test_ds(name, y)


def random_step_function(name: str, count: int, seed: int = 0) -> DataSet:
    """Step at a uniformly random index (DataSetTestFunctions.hpp:203)."""
    rng = np.random.default_rng(None if seed == 0 else seed)
    return step_function(name, count, int(rng.integers(0, max(count, 1))))
