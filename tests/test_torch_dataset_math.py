"""The port's ``ops/dataset_math.py`` against the JAX package's, on the CPU:
every case of ``tests/test_dataset_math.py`` run through both packages on
the same inputs. The module is host numpy in both, so results must be exactly
equal: values (NaN where NaN), axes, signal metadata, timing events and meta,
and the same errors (the same message, raised from the same line of the
copied module)."""

from importlib import import_module

import numpy as np
import pytest

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt

PKGS = (gt, gr)


def _dsm(pkg):
    return import_module(pkg.__name__ + ".ops.dataset_math")


def _ds(pkg, values, x=None):
    ds = import_module(pkg.__name__ + ".core.dataset").DataSet(
        values=np.asarray(values, np.float64))
    if x is not None:
        ds.axes[0].values = np.asarray(x, np.float64)
    return ds


def _equal(a, b):
    """Exact equality of two results: DataSets field by field, arrays with
    NaN at the same places, anything else by ==."""
    if hasattr(a, "values") and hasattr(a, "axes"):
        np.testing.assert_array_equal(a.values, b.values)
        assert len(a.axes) == len(b.axes)
        for x, y in zip(a.axes, b.axes):
            np.testing.assert_array_equal(x.values, y.values)
            assert (x.name, x.unit) == (y.name, y.unit)
        np.testing.assert_equal(   # NaN ranges compare equal
            [(s.name, s.unit, s.quantity, s.range_min, s.range_max)
             for s in a.signals],
            [(s.name, s.unit, s.quantity, s.range_min, s.range_max)
             for s in b.signals])
        assert [[(t.index, t.map) for t in e] for e in a.timing_events] == \
            [[(t.index, t.map) for t in e] for e in b.timing_events]
        assert set(a.meta) == set(b.meta)
        for k in a.meta:
            np.testing.assert_array_equal(np.asarray(a.meta[k]),
                                          np.asarray(b.meta[k]))
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _op(pkg, name):
    return getattr(_dsm(pkg).MathOp, name)


SIG = np.sin(np.linspace(0, 9, 64)) + 0.1 * np.cos(np.arange(64) * 1.7)

CASES = {
    # math_function: scalars, every operator, the unary tail, NaN cases
    **{f"scalar_{op}": (lambda pkg, op=op: _dsm(pkg).math_function(
        _ds(pkg, [1.0, 2.0, 3.0, -4.0]), 2.0, _op(pkg, op)))
       for op in ("ADD", "SUBTRACT", "MULTIPLY", "DIVIDE", "SQR", "SQRT",
                  "LOG10", "DB", "INV_DB", "IDENTITY")},
    "divide_by_zero": lambda pkg: _dsm(pkg).math_function(
        _ds(pkg, [1.0, 2.0]), 0.0, _op(pkg, "DIVIDE")),
    "sqrt_negative": lambda pkg: _dsm(pkg).math_function(
        _ds(pkg, [-5.0]), 1.0, _op(pkg, "SQRT")),
    "inv_db": lambda pkg: _dsm(pkg).math_function(
        _ds(pkg, [20.0, -3.0]), 123.0, _op(pkg, "INV_DB")),
    **{f"dataset_{fn}": (lambda pkg, fn=fn: getattr(_dsm(pkg), fn)(
        _ds(pkg, [1.0, 2.0, 3.0, 4.0]), _ds(pkg, [2.0, 4.0, 6.0, 8.0])))
       for fn in ("add_function", "subtract_function", "multiply_function",
                  "divide_function")},
    "interpolated_base": lambda pkg: _dsm(pkg).add_function(
        _ds(pkg, [0.0, 10.0, 20.0], [0.0, 1.0, 2.0]),
        _ds(pkg, [0.0, 5.0], [0.0, 2.0])),
    "same_base": lambda pkg: (
        _dsm(pkg).same_horizontal_base(_ds(pkg, [1, 2, 3]), _ds(pkg, [4, 5, 6])),
        _dsm(pkg).same_horizontal_base(_ds(pkg, [1, 2, 3]),
                                       _ds(pkg, [1, 2, 3], [0, 1, 5]))),
    # derivative and noise
    "derivative": lambda pkg: _dsm(pkg).compute_derivative(
        _ds(pkg, [1.0, 4.0, 9.0, 16.0])),
    "noise": lambda pkg: _dsm(pkg).add_noise(_ds(pkg, SIG), 0.5, seed=42),
    # windowed filters
    **{f"{fn}_{w}": (lambda pkg, fn=fn, w=w: getattr(_dsm(pkg), fn)(
        _ds(pkg, SIG), w))
       for fn, ws in (("apply_moving_average", (3, 7)), ("apply_median", (2, 3, 5)),
                      ("apply_rms", (3, 6)), ("apply_peak_to_peak", (3, 4)))
       for w in ws},
    "filter_forward": lambda pkg: _dsm(pkg).apply_filter(
        _ds(pkg, SIG), ([0.2, 0.3], [1.0, -0.5])),
    "filter_symmetric": lambda pkg: _dsm(pkg).apply_filter(
        _ds(pkg, SIG), ([0.2, 0.3], [1.0, -0.5]), symmetric=True),
    **{f"savgol_{b}_{d}": (lambda pkg, b=b, d=d: _dsm(pkg).apply_savgol(
        _ds(pkg, SIG), 11, 3, deriv=d, boundary=b))
       for b in ("reflect", "replicate") for d in (0, 1)},
    # utilities
    "update_min_max": lambda pkg: _dsm(pkg).update_min_max(_ds(pkg, SIG)),
    "merge": lambda pkg: _dsm(pkg).merge(_dsm(pkg).ramp("a", 8),
                                         _dsm(pkg).ramp("b", 8, offset=1.0)),
    "waveform_sine": lambda pkg: _dsm(pkg).waveform("sine", 200, 100.0, 1.0),
    "waveform_cosine": lambda pkg: _dsm(pkg).waveform("cosine", 64, 32.0, 3.0),
    # generators
    "triangular_odd": lambda pkg: _dsm(pkg).triangular("odd", 11),
    "triangular_even": lambda pkg: _dsm(pkg).triangular("even", 10, offset=1.0,
                                                        amplitude=2.0),
    "ramp": lambda pkg: _dsm(pkg).ramp("r", 4),
    "gauss": lambda pkg: _dsm(pkg).gauss_function("g", 21, mean=10, sigma=2),
    "step": lambda pkg: _dsm(pkg).step_function("s", 10, step_at=3),
    "step_default": lambda pkg: _dsm(pkg).step_function("s", 10),
    "random_step": lambda pkg: _dsm(pkg).random_step_function("r", 64, seed=7),
    "from": lambda pkg: _dsm(pkg).dataset_from("fib", [0, 1, 1, 2, 3, 5, 8, 13],
                                               uncertainties=[0.1] * 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_math_equal(case):
    got, want = (CASES[case](pkg) for pkg in PKGS)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    else:
        _equal(got, want)


ERRORS = {
    "derivative_one_sample": lambda pkg: _dsm(pkg).compute_derivative(
        _ds(pkg, [1.0])),
    "noise_negative": lambda pkg: _dsm(pkg).add_noise(_ds(pkg, [1.0, 2.0]), -1.0),
    "moving_average_even": lambda pkg: _dsm(pkg).apply_moving_average(
        _ds(pkg, [1.0, 2.0]), 4),
    "savgol_wrap": lambda pkg: _dsm(pkg).apply_savgol(_ds(pkg, SIG), 7, 2,
                                                      boundary="wrap"),
    "merge_mismatched": lambda pkg: _dsm(pkg).merge(_dsm(pkg).ramp("a", 8),
                                                    _dsm(pkg).ramp("b", 9)),
    "waveform_unknown": lambda pkg: _dsm(pkg).waveform("sawtooth", 10, 1.0, 1.0),
    "triangular_tiny": lambda pkg: _dsm(pkg).triangular("tiny", 2),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_dataset_math_errors_equal(case):
    msgs = []
    for pkg in PKGS:
        with pytest.raises(Exception) as ei:
            ERRORS[case](pkg)
        # GrError names its source line: the same line of the copied module
        msgs.append((type(ei.value).__name__,
                     str(ei.value).replace("gnuradio4_tpu_torch/", "gnuradio4_tpu/")))
    assert msgs[0] == msgs[1]


def test_input_dataset_untouched():
    """Every transform copies: the input DataSet keeps its values."""
    for pkg in PKGS:
        ds = _ds(pkg, SIG)
        before = ds.values.copy()
        _dsm(pkg).apply_savgol(ds, 11, 3)
        _dsm(pkg).apply_median(ds, 3)
        np.testing.assert_array_equal(ds.values, before)
