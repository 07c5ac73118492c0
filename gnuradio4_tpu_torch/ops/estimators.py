"""DataSet / signal estimators (≈ reference algorithm/dataset/DataSetEstimators.hpp:
min/max/mean/rms/peak/FWHM, step/edge detection) + SchmittTrigger
(algorithm/SchmittTrigger.hpp) + SampleRateEstimator + BurstTaper.

Estimators are host-side NumPy (they consume egressed DataSets); the Schmitt
trigger also has a vectorized device form for in-graph edge detection
(torch), and ``burst_taper`` applies a ramp to a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


# -- basic scalar estimators ---------------------------------------------------

def minimum(x) -> float: return float(np.min(x))
def maximum(x) -> float: return float(np.max(x))
def mean(x) -> float: return float(np.mean(x))
def rms(x) -> float: return float(np.sqrt(np.mean(np.square(np.abs(x)))))
def std(x) -> float: return float(np.std(x))
def peak_to_peak(x) -> float: return float(np.max(x) - np.min(x))


def peak_index(x) -> int:
    return int(np.argmax(x))


def interpolated_peak(x) -> tuple[float, float]:
    """Sub-sample peak location via 3-point parabolic interpolation → (pos, value)."""
    x = np.asarray(x, dtype=np.float64)
    i = int(np.argmax(x))
    if i == 0 or i == len(x) - 1:
        return float(i), float(x[i])
    a, b, c = x[i - 1], x[i], x[i + 1]
    denom = a - 2 * b + c
    if abs(denom) < 1e-30:
        return float(i), float(b)
    d = 0.5 * (a - c) / denom
    return i + d, b - 0.25 * (a - c) * d


def median(x) -> float:
    """Median (even length → mean of the two middle elements; ≈ getMedian,
    DataSetEstimators.hpp:170)."""
    return float(np.median(np.asarray(x)))


def integral(x, x_values=None) -> float:
    """Trapezoidal integral over the (x-axis, signal) pairs (≈ getIntegral,
    DataSetEstimators.hpp:232); non-finite segment areas contribute zero."""
    y = np.asarray(x, np.float64)
    xs = np.arange(len(y), dtype=np.float64) if x_values is None \
        else np.asarray(x_values, np.float64)
    areas = 0.5 * np.diff(xs) * (y[:-1] + y[1:])
    return float(np.sum(np.where(np.isfinite(areas), areas, 0.0)))


def centre_of_mass(x, x_values=None) -> float:
    """Σ x·y / Σ y over finite samples (≈ computeCentreOfMass,
    DataSetEstimators.hpp:37); NaN when the total mass is zero."""
    y = np.asarray(x, np.float64)
    xs = np.arange(len(y), dtype=np.float64) if x_values is None \
        else np.asarray(x_values, np.float64)
    ok = np.isfinite(xs) & np.isfinite(y)
    mass = float(np.sum(y[ok]))
    if mass == 0.0:
        return float("nan")
    return float(np.sum(xs[ok] * y[ok]) / mass)


def _hysteresis_thresholds(y: np.ndarray) -> tuple[float, float]:
    lo_v, hi_v = float(np.nanmin(y)), float(np.nanmax(y))
    rng = hi_v - lo_v
    return lo_v + 0.45 * rng, lo_v + 0.55 * rng


def duty_cycle(x) -> float:
    """High-time fraction with a 45%/55%-of-range hysteresis band
    (≈ getDutyCycle, DataSetEstimators.hpp:289): samples inside the band count
    for neither state; NaN for flat/non-finite signals."""
    y = np.asarray(x, np.float64)
    if not np.isfinite(y).any() or np.nanmax(y) == np.nanmin(y):
        return float("nan")
    t_lo, t_hi = _hysteresis_thresholds(y)
    n_low = int(np.sum(y < t_lo))
    n_high = int(np.sum(y > t_hi))
    if n_low + n_high == 0:
        return float("nan")
    return n_high / (n_low + n_high)


def frequency_estimate(x, sample_rate: float = 1.0) -> float:
    """Naive edge-counting frequency estimate (≈ getFrequencyEstimate,
    DataSetEstimators.hpp:319): hysteresis state machine over the 45/55%
    thresholds; the mean period between successive rising and successive
    falling edges gives 1/f."""
    y = np.asarray(x, np.float64)
    if not np.isfinite(y).any() or np.nanmax(y) == np.nanmin(y):
        return float("nan")
    t_lo, t_hi = _hysteresis_thresholds(y)
    state = y[0] > t_hi
    last_rise = last_fall = None
    periods: list[float] = []
    for i, v in enumerate(y):
        if not np.isfinite(v):
            continue
        if not state and v > t_hi:
            state = True
            if last_rise is not None:
                periods.append(i - last_rise)
            last_rise = i
        elif state and v < t_lo:
            state = False
            if last_fall is not None:
                periods.append(i - last_fall)
            last_fall = i
    if not periods:
        return float("nan")
    return float(sample_rate / np.mean(periods))


def gauss_interpolated_peak(x, x_values=None) -> float:
    """Sub-bin peak location via Gaussian (log-parabolic) interpolation
    (≈ interpolateGaussian + getLocationMaximumGaussInterpolated,
    DataSetEstimators.hpp:381,407) — exact for Gaussian-shaped peaks, the
    right interpolator for windowed spectra. Falls back to the integer bin
    when a neighbor is non-positive/non-finite."""
    y = np.asarray(x, np.float64)
    i = int(np.argmax(y))
    pos = float(i)
    if 0 < i < len(y) - 1:
        left, centre, right = y[i - 1], y[i], y[i + 1]
        if (np.isfinite([left, centre, right]).all()
                and min(left, centre, right) > 0.0):
            den = np.log(centre * centre / (left * right))
            if den != 0.0:
                pos = i + 0.5 * np.log(right / left) / den
    if x_values is None:
        return pos
    xs = np.asarray(x_values, np.float64)
    if i + 1 >= len(xs):
        return float("nan")
    return float(xs[i] + (pos - i) * (xs[i + 1] - xs[i]))


def zero_crossing(x, threshold: float, x_values=None) -> float:
    """First threshold crossing, linear-interpolated on the x-axis
    (≈ getZeroCrossing, DataSetEstimators.hpp:431): rising when the signal
    starts below the threshold, falling otherwise; NaN when none found."""
    y = np.asarray(x, np.float64)
    xs = np.arange(len(y), dtype=np.float64) if x_values is None \
        else np.asarray(x_values, np.float64)
    rising = y[0] < threshold
    for i in range(1, len(y)):
        y0, y1 = y[i - 1], y[i]
        if not (np.isfinite(y0) and np.isfinite(y1)):
            continue
        if (rising and y1 >= threshold) or (not rising and y1 <= threshold):
            if y1 == y0:
                return float(xs[i])
            frac = (threshold - y0) / (y1 - y0)
            return float(xs[i - 1] + frac * (xs[i] - xs[i - 1]))
    return float("nan")


def settling_time(x, *, step_value: float = 1.0, threshold: float = 1e-3,
                  offset: int = 0) -> int:
    """Index (relative to ``offset``) from which the response stays inside
    step_value ± threshold — the index of the last excursion, or of the first
    in-bounds sample (≈ estimate_settling_time, qa_filter.cpp:15-44)."""
    y = np.asarray(x, np.float64)[offset:]
    inb = (y >= step_value - threshold) & (y <= step_value + threshold)
    if not inb.any():
        raise ValueError("no settling within the threshold")
    first = int(np.argmax(inb))
    bad = np.nonzero(~inb[first:])[0]
    return first + int(bad[-1]) if bad.size else first


def fwhm(x, *, baseline: float | None = None) -> float:
    """Full width at half maximum (linear-interpolated crossings), in samples."""
    x = np.asarray(x, dtype=np.float64)
    base = np.min(x) if baseline is None else baseline
    i = int(np.argmax(x))
    half = base + (x[i] - base) / 2.0
    lo = i
    while lo > 0 and x[lo] > half:
        lo -= 1
    hi = i
    while hi < len(x) - 1 and x[hi] > half:
        hi += 1
    if x[lo] == x[lo + 1] or x[hi] == x[hi - 1]:
        return float(hi - lo)
    frac_lo = (half - x[lo]) / (x[lo + 1] - x[lo])
    frac_hi = (x[hi - 1] - half) / (x[hi - 1] - x[hi])
    return float((hi - 1 + frac_hi) - (lo + frac_lo))


def edge_detect(x, *, threshold: float = 0.5, rising: bool = True) -> list[float]:
    """Linear-interpolated threshold crossings (sub-sample), in samples."""
    x = np.asarray(x, dtype=np.float64)
    if rising:
        hits = np.nonzero((x[:-1] < threshold) & (x[1:] >= threshold))[0]
    else:
        hits = np.nonzero((x[:-1] > threshold) & (x[1:] <= threshold))[0]
    out = []
    for i in hits:
        d = x[i + 1] - x[i]
        out.append(i + ((threshold - x[i]) / d if d else 0.0))
    return out


def step_start(x, *, fraction: float = 0.5) -> float:
    """Locate a step edge: first crossing of min + fraction·(max−min)."""
    x = np.asarray(x, dtype=np.float64)
    thr = np.min(x) + fraction * (np.max(x) - np.min(x))
    e = edge_detect(x, threshold=thr, rising=x[-1] > x[0])
    return e[0] if e else float("nan")


# -- Schmitt trigger -----------------------------------------------------------

@dataclasses.dataclass
class SchmittState:
    above: bool = False
    zone: Any = ()            # samples accumulated inside the hysteresis band
                              # (a float64 array once the array form ran)
    zone_start: int = 0       # position of zone[0] relative to chunk start
                              # (negative ⇒ carried over from a previous chunk)
    last: float | None = None  # previous chunk's final sample — the bracketing
                               # pre-band point when the band is entered at a
                               # chunk seam (keeps streaming == one-shot)


def _regression_crossing(ys: np.ndarray, offset: float) -> float | None:
    """Least-squares line fit over ``ys`` (x = 0..n−1); returns x where the fit
    crosses ``offset`` (≈ SchmittTrigger.hpp:294 findCrossingIndexLinearRegression)."""
    n = len(ys)
    if n < 2:
        return None
    xs = np.arange(n, dtype=np.float64)
    mean_x, mean_y = xs.mean(), ys.mean()
    den = np.sum((xs - mean_x) ** 2)
    num = np.sum((xs - mean_x) * (ys - mean_y))
    if den == 0.0 or num == 0.0:
        return None
    slope = num / den
    intercept = mean_y - slope * mean_x
    return float((offset - intercept) / slope)


def _quadratic_crossing(ys: np.ndarray, offset: float) -> float | None:
    """Order-2 LSQ fit over ``ys`` (x = 0..n−1); smallest in-range root of
    fit(x) = offset, or None when degenerate (POLYNOMIAL_INTERPOLATION)."""
    n = len(ys)
    xs = np.arange(n, dtype=np.float64)
    try:
        a, b, c = np.polyfit(xs, ys, 2)
    except np.linalg.LinAlgError:
        return None
    roots = np.roots([a, b, c - offset]) if abs(a) > 1e-12 else \
        (np.asarray([(offset - c) / b]) if abs(b) > 1e-12 else np.asarray([]))
    real = [float(r.real) for r in roots
            if abs(r.imag) < 1e-9 and -0.5 <= r.real <= n - 0.5]
    return min(real) if real else None


def schmitt_edges(x: np.ndarray, *, low: float, high: float,
                  state: SchmittState | None = None,
                  method: str = "basic_linear"
                  ) -> tuple[list[tuple[float, int]], SchmittState]:
    """Hysteresis edge detector with sub-sample interpolation
    (≈ algorithm/SchmittTrigger.hpp).

    Returns ([(position, +1|-1), …], state). +1 = rising (crossed high),
    −1 = falling (crossed low). ``method``:

    - ``'none'`` — integer crossing index (NO_INTERPOLATION);
    - ``'basic_linear'`` — linear interpolation between the two samples
      bracketing the threshold (BASIC_LINEAR_INTERPOLATION);
    - ``'regression'`` — least-squares line over the samples accumulated while
      traversing the hysteresis band, crossing solved at the band midpoint
      (LINEAR_INTERPOLATION, SchmittTrigger.hpp:168-222 — noise-robust);
    - ``'polynomial'`` — quadratic least-squares fit over the band samples,
      crossing solved on the fitted parabola (POLYNOMIAL_INTERPOLATION — the
      reference's Savitzky–Golay-smoothed variant; a quadratic LSQ fit *is*
      the order-2 SG smoother evaluated continuously). Falls back to the
      linear regression when the band holds fewer than three samples.

    Streaming: pass the returned state back in for the next chunk; the
    regression band accumulation carries across chunk boundaries (positions of
    carried edges may come out negative relative to the current chunk).

    The JAX package walks the samples one by one in Python; here the samples
    at or beyond each threshold are found as runs with array operations, an
    edge is the first run of one side after a run of the other, and its band
    samples are the slice from the run before it: the same edges, positions
    and state, with Python work per run rather than per sample.
    """
    if method not in ("none", "basic_linear", "regression", "polynomial"):
        raise ValueError(f"unknown schmitt method {method!r}")
    st = state or SchmittState()
    x = np.asarray(x)
    if x.dtype.kind != "f":
        x = x.astype(np.float64)
    if not low < high:
        return _schmitt_edges_loop(np.asarray(x, np.float64), low=low,
                                   high=high, state=st, method=method)
    n = len(x)
    mid = (low + high) / 2.0
    # float64 comparisons, as on the JAX package's float64 copy of x
    hi_hit, lo_hit = x >= np.float64(high), x <= np.float64(low)
    # the runs of samples at or beyond a threshold, in order: an edge is the
    # first run of one side after a run of the other (the band between
    # decides nothing); its index is the run's first sample
    runs = sorted([(a, b, True) for a, b in _runs(hi_hit)]
                  + [(a, b, False) for a, b in _runs(lo_hit)])
    zone_in = np.asarray(st.zone, dtype=np.float64)

    def band(r: int, e: int):
        """The band samples up to sample e, when run r (or the chunk's end,
        r = len(runs)) closes a phase: from the last sample of the run
        before it (the resting side), else the carried zone, else from the
        chunk's first sample with the seam's bracketing sample. Returns
        (samples, start), or None when empty."""
        if r > 0:
            k = runs[r - 1][1]
            return (np.asarray(x[k:e + 1], np.float64), k) if k < e else None
        xs = np.asarray(x[:e + 1], np.float64)
        if zone_in.size:
            return np.concatenate([zone_in, xs]), st.zone_start
        if e < 0:
            return None
        if st.last is not None:
            return np.concatenate([[st.last], xs]), -1
        return xs, 0

    edges: list[tuple[float, int]] = []
    above = st.above
    for r, (e, _, rising) in enumerate(runs):
        if rising == above:
            continue
        above = rising
        pos = float(e)
        if method == "basic_linear":
            j = e - 1
            if j >= 0 and x[e] != x[j]:
                pos = j + (mid - float(x[j])) / (float(x[e]) - float(x[j]))
        elif method != "none":
            zone, z0 = band(r, e)
            c = None
            if method == "polynomial" and len(zone) >= 3:
                c = _quadratic_crossing(zone, mid)
            if c is None:
                c = _regression_crossing(zone, mid)
            if c is not None:
                pos = z0 + c
        edges.append((float(pos), +1 if rising else -1))
    if method in ("regression", "polynomial"):
        zb = band(len(runs), n - 1)
        zone, zone_start = (np.array(zb[0]), zb[1]) if zb else ((), 0)
    elif edges:
        zone, zone_start = (), 0
    else:
        zone, zone_start = tuple(st.zone), st.zone_start
    return edges, SchmittState(above=above, zone=zone,
                               zone_start=zone_start - n,
                               last=float(x[-1]) if n else st.last)


def _runs(mask: np.ndarray) -> list[tuple[int, int]]:
    """The (first, last) indices of each run of True in ``mask``."""
    d = np.diff(mask.view(np.int8), prepend=np.int8(0), append=np.int8(0))
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1) - 1
    return list(zip(starts.tolist(), ends.tolist()))


def _schmitt_edges_loop(x: np.ndarray, *, low: float, high: float,
                        state: SchmittState | None = None,
                        method: str = "basic_linear"
                        ) -> tuple[list[tuple[float, int]], SchmittState]:
    """The JAX package's sample-by-sample form of :func:`schmitt_edges`,
    kept for a band with ``low >= high``, where an edge can switch back on
    the next sample."""
    if method not in ("none", "basic_linear", "regression", "polynomial"):
        raise ValueError(f"unknown schmitt method {method!r}")
    poly = method == "polynomial"
    if poly:
        method = "regression"   # same band accumulation; crossing solve differs
    st = state or SchmittState()
    x = np.asarray(x, dtype=np.float64)
    mid = (low + high) / 2.0
    edges: list[tuple[float, int]] = []
    above = st.above
    zone = list(st.zone)
    zone_start = st.zone_start
    for i in range(len(x)):
        in_band_entry = (not above and x[i] > low) or (above and x[i] < high)
        if method == "regression":
            if zone:
                zone.append(x[i])
            elif in_band_entry:
                if i > 0:
                    zone = [x[i - 1], x[i]]
                    zone_start = i - 1
                elif st.last is not None:
                    zone = [st.last, x[0]]     # bracket across the chunk seam
                    zone_start = -1
                else:
                    zone = [x[0]]
                    zone_start = 0
        if (not above and x[i] >= high) or (above and x[i] <= low):
            rising = not above
            pos = float(i)
            if method == "basic_linear":
                # interpolate the *band-midpoint* crossing between the last two
                # samples (≈ SchmittTrigger.hpp:133-142 computeEdgePosition
                # solving for _offset)
                j = i - 1
                if j >= 0 and x[i] != x[j]:
                    pos = j + (mid - x[j]) / (x[i] - x[j])
            elif method == "regression" and zone:
                c = None
                if poly and len(zone) >= 3:
                    c = _quadratic_crossing(np.asarray(zone), mid)
                if c is None:
                    c = _regression_crossing(np.asarray(zone), mid)
                if c is not None:
                    pos = zone_start + c
            edges.append((pos, +1 if rising else -1))
            above = not above
            zone, zone_start = [], 0
        elif method == "regression" and zone:
            # left the band back toward the resting side without switching
            if (not above and x[i] <= low) or (above and x[i] >= high):
                zone, zone_start = [], 0
    n = len(x)
    return edges, SchmittState(above=above, zone=tuple(zone),
                               zone_start=zone_start - n,
                               last=float(x[-1]) if n else st.last)


def _running_max(v: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Inclusive running maximum of an integer tensor along its last axis.
    ``torch.cummax`` scans a row serially (12.2 ms for one row of 2^22 int64
    on an H100), so a long row is cut into rows of ``block`` scanned side by
    side, and each row then takes the maximum of the rows before it: the
    same values as one ``cummax`` (a maximum is exact)."""
    t = v.shape[-1]
    if t <= block:
        return v.cummax(dim=-1).values
    rows = -(-t // block)
    w = torch.nn.functional.pad(v, (0, rows * block - t), value=-1)
    w = w.reshape(*v.shape[:-1], rows, block).cummax(dim=-1).values
    before = w[..., -1].cummax(dim=-1).values
    before = torch.cat([torch.full_like(before[..., :1], -1), before[..., :-1]], -1)
    w = torch.maximum(w, before[..., None])
    return w.reshape(*v.shape[:-1], rows * block)[..., :t]


def schmitt_device(x: torch.Tensor, last_above: torch.Tensor, *, low: float,
                   high: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized device Schmitt: returns (state per sample ∈{0,1}, carry).

    Hysteresis is a 1-bit recurrence: s[n] = x≥high ? 1 : (x≤low ? 0 : s[n−1]).
    The JAX package evaluates it as an associative 'override' scan; here each
    sample reads the last decisive sample at or before it (a running maximum
    of the decisive indices, :func:`_running_max`, then a gather), and takes
    the carried state where no sample has decided yet — the same bits, with
    no loop over samples. ``x >= high`` wins where both thresholds hold, as in the scan.
    """
    set_hi = x >= high
    decided = set_hi | (x <= low)
    idx = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    last = _running_max(torch.where(decided, idx, -1))
    hit = torch.gather(set_hi, -1, last.clamp_min(0))
    init = last_above.to(device=x.device, dtype=torch.bool)[..., None]
    state = torch.where(last >= 0, hit, init)
    return state, state[..., -1]


# -- misc stream helpers -------------------------------------------------------

TAPER_SHAPES = ("none", "linear", "raised_cosine", "tukey", "gaussian",
                "mushroom", "mushroom_sine")


def taper_edge(kind: str, n: int, *, rising: bool = True,
               param: float = 0.0) -> np.ndarray:
    """Taper edge coefficients (≈ reference BurstTaper.hpp:174-283
    generateEdge/computeRise — same shape family and formulas).

    Host-side numpy: edges are constants of the block, computed once, as the
    reference precomputes them in buildCoefficients().
    ``rising`` edges go 0→1 over ``n`` samples; falling edges are the exact
    reverse (fall[i] = rise[n-1-i], the reference's symmetry property).
    Shapes: none (all-ones gate), linear, raised_cosine (optional power
    ``param``), tukey (``param``=alpha, default 0.5), gaussian (``param``=sigma,
    default 0.4, renormalised to hit 0 and 1 exactly), mushroom (quartic with
    negative undershoot), mushroom_sine.
    """
    if kind not in TAPER_SHAPES:
        raise ValueError(f"unknown taper shape {kind!r}; one of {TAPER_SHAPES}")
    if n <= 0:
        return np.zeros(0, np.float64)
    u = np.arange(n, dtype=np.float64) / (n - 1) if n > 1 \
        else np.zeros(1, np.float64)
    if not rising:
        u = 1.0 - u
    if kind == "none":
        e = np.ones_like(u)
    elif kind == "linear":
        e = u
    elif kind == "raised_cosine":
        e = (1.0 - np.cos(np.pi * u)) / 2.0
        if param > 0.0 and param != 1.0:
            e = e ** param
    elif kind == "tukey":
        alpha = param if param > 0.0 else 0.5
        e = np.where(u < alpha / 2.0,
                     (1.0 - np.cos(2.0 * np.pi * u / alpha)) / 2.0, 1.0)
    elif kind == "gaussian":
        sigma = param if param > 0.0 else 0.4
        raw = np.exp(-0.5 * ((u - 1.0) / sigma) ** 2)
        raw0 = np.exp(-0.5 / (sigma * sigma))
        e = (raw - raw0) / (1.0 - raw0)
    elif kind == "mushroom":
        e = u * u * (-12.0 + u * (28.0 - 15.0 * u))
    else:                                   # mushroom_sine
        sin_pu = np.sin(np.pi * u)
        e = (1.0 - np.cos(np.pi * u)) / 2.0 \
            - (3.0 * np.pi / 8.0) * sin_pu ** 3
    return e


def taper(kind: str, n_rise: int, n_flat: int, n_fall: int,
          *, param: float = 0.0) -> np.ndarray:
    """Full rise/flat/fall burst envelope (≈ BurstTaper.hpp:194 generateTaper)."""
    return np.concatenate([taper_edge(kind, n_rise, rising=True, param=param),
                           np.ones(n_flat, np.float64),
                           taper_edge(kind, n_fall, rising=False, param=param)])


def burst_taper(x: torch.Tensor, *, ramp: np.ndarray, up: bool) -> torch.Tensor:
    """Apply a ramp envelope at the start (up) or end (down) of a burst
    (≈ algorithm/BurstTaper.hpp)."""
    n = len(ramp)
    env = torch.ones(x.shape[-1], dtype=torch.float32, device=x.device)
    r = torch.from_numpy(np.asarray(ramp, np.float32)).to(x.device)
    if up:
        env[:n] = r
    else:
        env[-n:] = r.flip(0)
    return x * env


class SampleRateEstimator:
    """IIR-smoothed wall-clock sample-rate estimate
    (≈ algorithm/SampleRateEstimator.hpp:14-20). Host-side."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.estimate = 0.0
        self._last_t: float | None = None
        self._last_n = 0

    def update(self, n_samples: int, t: float) -> float:
        if self._last_t is not None and t > self._last_t:
            inst = (n_samples - self._last_n) / (t - self._last_t)
            self.estimate = (inst if self.estimate == 0.0
                             else (1 - self.alpha) * self.estimate
                             + self.alpha * inst)
        self._last_t, self._last_n = t, n_samples
        return self.estimate


class SampleRateDll:
    """Timestamped-chunk sample-rate estimator, DLL-style
    (≈ algorithm/SampleRateEstimator.hpp: Adriaensen "Using a DLL to filter
    time" — per-update measured period ``dt/n_samples`` smoothed by a designed
    Butterworth low-pass, queried as rate or ppm-vs-nominal).

    The smoothing filter comes from our own ``ops.filter_design.design_iir``
    (2nd-order Butterworth by default) applied per update on the host
    (direct-form II transposed over the SOS cascade). The filter state is
    pre-charged with the nominal period so the estimate starts unbiased
    (matching the reference's reset semantics, incl. ``ppm_initial``).
    """

    def __init__(self, *, filter_cutoff_hz: float = 0.1, filter_order: int = 2,
                 ppm_initial: float = 0.0):
        self.filter_cutoff_hz = float(filter_cutoff_hz)
        self.filter_order = int(filter_order)
        self.ppm_initial = float(ppm_initial)
        self._nominal_rate = 0.0
        self._period_est = 0.0
        self._t_prev = 0.0
        self._has_prev = False
        self._initialised = False
        self._sos = None
        self._zi = None

    def reset(self, nominal_rate: float,
              expected_update_rate_hz: float = 250.0) -> None:
        self._nominal_rate = float(nominal_rate)
        self._period_est = 1.0 / nominal_rate if nominal_rate > 0 else 0.0
        if self.ppm_initial:
            self._period_est *= 1.0 + self.ppm_initial * 1e-6
        self._t_prev = 0.0
        self._has_prev = False
        self._initialised = False
        from .filter_design import design_iir
        fs = max(float(expected_update_rate_hz), 4.0 * self.filter_cutoff_hz)
        res = design_iir("butterworth", "lowpass", self.filter_order,
                         sample_rate=fs, f_low=self.filter_cutoff_hz)
        self._sos = np.asarray(res.sos, np.float64)
        # pre-charge each section's DF2T state for a constant input equal to
        # the (ppm-adjusted) nominal period → zero start-up transient
        self._zi = []
        v = self._period_est
        for b0, b1, b2, a0, a1, a2 in self._sos:
            b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
            y = v * (b0 + b1 + b2) / (1.0 + a1 + a2)
            # DF2T steady state: s1 = b1·x − a1·y + s2 ; s2 = b2·x − a2·y
            s2 = b2 * v - a2 * y
            s1 = b1 * v - a1 * y + s2
            self._zi.append([s1, s2])
            v = y
        self._zi = np.asarray(self._zi, np.float64)

    def reset_phase(self) -> None:
        """Forget the previous timestamp (after retune) but keep filter state."""
        self._t_prev = 0.0
        self._has_prev = False

    def _filter_one(self, x: float) -> float:
        v = x
        for k in range(self._sos.shape[0]):
            b0, b1, b2, a0, a1, a2 = self._sos[k]
            b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
            y = b0 * v + self._zi[k, 0]
            self._zi[k, 0] = b1 * v - a1 * y + self._zi[k, 1]
            self._zi[k, 1] = b2 * v - a2 * y
            v = y
        return v

    def update(self, t_obs: float, n_samples: int) -> None:
        if self._nominal_rate <= 0.0 or n_samples <= 0 or self._sos is None:
            return
        if not self._has_prev:
            self._t_prev = t_obs
            self._has_prev = True
            return
        dt = t_obs - self._t_prev
        self._t_prev = t_obs
        if dt <= 0.0:
            return
        self._period_est = self._filter_one(dt / float(n_samples))
        self._initialised = True

    def estimated_rate(self) -> float:
        if not self._initialised or self._period_est <= 0.0:
            return self._nominal_rate
        return 1.0 / self._period_est

    def estimated_ppm(self) -> float:
        if self._nominal_rate <= 0.0:
            return 0.0
        return (self.estimated_rate() / self._nominal_rate - 1.0) * 1e6
