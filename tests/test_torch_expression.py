"""The ExprTk-subset expression compiler and the Expression blocks of the port
against the JAX package, on the CPU: every case of ``tests/test_expression.py``
runs through both packages on the same inputs (made with a NumPy seed or
written out), and the results agree within ``RTOL``/``ATOL`` (float32 ops in
both; the JAX side runs under ``jax.jit`` where its test does). Error cases
raise ``GrError`` in both with the same message.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core.errors import GrError as JGrError
from gnuradio4_tpu.ops import expression as jexpr
from gnuradio4_tpu_torch.core.errors import GrError as TGrError
from gnuradio4_tpu_torch.ops import expression as texpr

torch.set_num_threads(2)

RTOL = 1e-6
ATOL = 1e-6


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _inputs(kw: dict) -> tuple[dict, dict]:
    """The same inputs for both packages: arrays as jnp / torch, host values
    as they are."""
    j, t = {}, {}
    for k, v in kw.items():
        if isinstance(v, np.ndarray):
            j[k], t[k] = jnp.asarray(v), torch.from_numpy(v.copy())
        else:
            j[k] = t[k] = v
    return j, t


def _both(src, args, kw, out_var="y", jfuncs=None, tfuncs=None):
    jin, tin = _inputs(kw)
    yj = jexpr.compile_expression(src, args, out_var=out_var,
                                  functions=jfuncs)(**jin)
    yt = texpr.compile_expression(src, args, out_var=out_var,
                                  functions=tfuncs)(**tin)
    return _np(yj), _np(yt)


# where the port's message words a backend detail its own way
_REWORDED = (("has no static-shape XLA lowering", "is not part of the "
              "unrolled subset"),
             ("the scan carries only y", "the loop carries only y"))


def _errors(fn_j, fn_t, cut=None):
    """Both raise ``GrError`` with the same message (the JAX one with the
    port's rewordings); ``cut`` compares only the text before it, where the
    message goes on to print the operands (array reprs differ)."""
    with pytest.raises(JGrError) as ej:
        fn_j()
    with pytest.raises(TGrError) as et:
        fn_t()
    mj, mt = ej.value.args[0], et.value.args[0]
    for a, b in _REWORDED:
        mj = mj.replace(a, b)
    if cut is not None:
        assert cut in mj and cut in mt
        mj, mt = mj.split(cut)[0], mt.split(cut)[0]
    assert mt == mj
    return mt


V8 = np.arange(8.0, dtype=np.float32)

# (expression, args, inputs, out_var): scalar and vector programs of
# test_expression.py's TestLanguage / TestWidenedSubset / TestStrings
VALUE_CASES = [
    ("2 + 3 * 4", (), {}, "y"),
    ("2 ^ 3 ^ 2", (), {}, "y"),
    ("-2 ^ 2", (), {}, "y"),
    ("(2 + 3) * 4", (), {}, "y"),
    ("7 % 4", (), {}, "y"),
    ("-7 % 4", (), {}, "y"),
    ("x % 3", ("x",), {"x": np.linspace(-5, 5, 11, dtype=np.float32)}, "y"),
    ("x ^ 2 ^ 0.5", ("x",), {"x": np.linspace(0, 5, 11, dtype=np.float32)},
     "y"),
    ("1 < 2 ? 10 : 20", (), {}, "y"),
    ("1 > 2 ? 10 : 20", (), {}, "y"),
    ("(1 < 2) and (3 > 4) ? 1 : 0", (), {}, "y"),
    ("(1 < 2) or (3 > 4) ? 1 : 0", (), {}, "y"),
    ("not (1 == 2) ? 5 : 6", (), {}, "y"),
    ("1 <> 2 ? 1 : 0", (), {}, "y"),
    ("if(2 >= 2, 7, 8)", (), {}, "y"),
    ("x > 0 ? x : -x", ("x",), {"x": np.linspace(-2, 2, 9, dtype=np.float32)},
     "y"),
    ("if(x, 1, 2)", ("x",), {"x": np.array([0, 1, -2, 0], np.float32)}, "y"),
    ("(x > 0) and (x < 1) ? 1 : 0", ("x",),
     {"x": np.linspace(-1, 2, 7, dtype=np.float32)}, "y"),
    ("(x > 0) or 0 ? 1 : 0", ("x",),
     {"x": np.linspace(-1, 2, 7, dtype=np.float32)}, "y"),
    ("not x ? 1 : 0", ("x",), {"x": np.array([0, 1, 0.5], np.float32)}, "y"),
    ("var t := 3; t * t", (), {}, "y"),
    ("var t := 2; t += 3; t *= 2; t", (), {}, "y"),
    ("y := 2*x; 999", ("x",), {"x": 5.0}, "y"),
    ("sin(pi/2)", (), {}, "y"),
    ("clamp(-1, 5, 1)", (), {}, "y"),
    ("clip(5, -1, 1)", (), {}, "y"),
    ("hypot(3, 4)", (), {}, "y"),
    ("avg(1, 2, 3, 4)", (), {}, "y"),
    ("root(27, 3)", (), {}, "y"),
    ("frac(2.75)", (), {}, "y"),
    ("vecOut := 2 * vecIn", ("vecIn", "vecOut"),
     {"vecIn": V8, "vecOut": np.zeros(8, np.float32)}, "vecOut"),
    ("for (var i := 0; i < 8; i += 1) { vecOut[i] := vecIn[i] + i; }",
     ("vecIn", "vecOut"), {"vecIn": V8, "vecOut": np.zeros(8, np.float32)},
     "vecOut"),
    ("var s := 0; var i := 0; while (i < 5) { s += i; i += 1 }; y := s + x",
     ("x",), {"x": np.array([1.0, 2.0], np.float32)}, "y"),
    ("var n := 0; repeat n += 1 until (n >= 3); y := n * x", ("x",),
     {"x": np.array([2.0], np.float32)}, "y"),
    ("var n := 0; repeat n += 1 until (true); y := n + 0*x", ("x",),
     {"x": np.array([0.0], np.float32)}, "y"),
    ("sum(x)", ("x",), {"x": np.array([1, 2, 3, 4], np.float32)}, "y"),
    ("avg(x)", ("x",), {"x": np.array([1, 2, 3, 4], np.float32)}, "y"),
    ("min(x)", ("x",), {"x": np.array([1, 2, 3, 4], np.float32)}, "y"),
    ("max(x)", ("x",), {"x": np.array([1, 2, 3, 4], np.float32)}, "y"),
    ("mul(x)", ("x",), {"x": np.array([1, 2, 3, 4], np.float32)}, "y"),
    ("min(x, y)", ("x", "y"), {"x": np.array([1, 5], np.float32),
                               "y": np.array([3, 2], np.float32)}, "z"),
    ("max(x, 2.5)", ("x",), {"x": np.array([1, 5], np.float32)}, "y"),
    ("y := x / avg(x)", ("x",), {"x": np.array([1.0, 3.0], np.float32)}, "y"),
    ("var a := 0; var b := 0; a := b := 2 + x[0]; y := a * b", ("x",),
     {"x": np.array([1.0], np.float32)}, "y"),
    ("y := size('hello')", ("x",), {"x": 1.0}, "y"),
    ("var s := 'ab' + 'cd'; size(s) + x", ("x",),
     {"x": np.zeros(3, np.float32)}, "y"),
    ("mode == 'fm' ? a*x : b*x", ("x", "a", "b", "mode"),
     {"x": np.arange(4.0, dtype=np.float32), "a": 2.0, "b": 3.0,
      "mode": "fm"}, "y"),
    ("mode == 'fm' ? a*x : b*x", ("x", "a", "b", "mode"),
     {"x": np.arange(4.0, dtype=np.float32), "a": 2.0, "b": 3.0,
      "mode": "am"}, "y"),
    ("('a' < 'b') ? 1 : 0", (), {}, "y"),
    ("('b' <= 'a') ? 1 : 0", (), {}, "y"),
    ("('b' > 'a') ? 1 : 0", (), {}, "y"),
    ("('a' >= 'b') ? 1 : 0", (), {}, "y"),
    ("('x' == 'x') ? 1 : 0", (), {}, "y"),
    ("('x' != 'x') ? 1 : 0", (), {}, "y"),
    ("('x' <> 'y') ? 1 : 0", (), {}, "y"),
    ("size('hello')", (), {}, "y"),
    ("upper('ab') == 'AB' ? 1 : 0", (), {}, "y"),
    ("lower('AB') == 'ab' ? 1 : 0", (), {}, "y"),
    ("trim('  x ') == 'x' ? 1 : 0", (), {}, "y"),
    ("like('chan7', 'chan*') ? 1 : 0", (), {}, "y"),
    ("like('aux', 'chan*') ? 1 : 0", (), {}, "y"),
    ("ilike('CHAN7', 'chan*') ? 1 : 0", (), {}, "y"),
    ("contains('wideband', 'band') ? 1 : 0", (), {}, "y"),
    ("s[1] == 'b' ? 1 : 0", ("s",), {"s": "abc"}, "y"),
    ("var s := 'lo'; s := s + 'ng'; s == 'long' ? x : -x", ("x",),
     {"x": np.ones(2, np.float32)}, "y"),
    ("size(v)", ("v",), {"v": np.arange(5.0, dtype=np.float32)}, "y"),
]

_rng = np.random.default_rng(11)
_X = _rng.uniform(0.1, 2.0, 64).astype(np.float32)
# every built-in function over a seeded vector (and its host-number form)
FUNCTION_CASES = [
    f"{name}(x)" for name in
    ("sin", "cos", "tan", "asin", "acos", "atan", "arcsin", "arccos",
     "arctan", "sinh", "cosh", "tanh", "sec", "csc", "cot", "deg2rad",
     "rad2deg", "exp", "expm1", "log", "log10", "log2", "log1p", "sqrt",
     "abs", "floor", "ceil", "round", "trunc", "sign", "frac", "real",
     "imag", "conj", "angle")
] + ["atan2(x, 0.5)", "arctan2(0.5, x)", "min(x, 1)", "max(1, x)",
     "minimum(x, x*x)", "maximum(x, 1)", "clamp(0.5, x, 1.5)",
     "clip(x, 0.5, 1.5)", "inrange(0.5, x, 1.5) ? 1 : 0", "pow(x, 1.5)",
     "power(2, x)", "hypot(x, 2)", "mod(x * 7, 3)", "root(x, 3)",
     "avg(x, 1, x)", "if(x > 1, x, 0)", "where(x > 1, 0, x)", "sum(x, x, 1)",
     "mul(x, x, 2)", "x ^ 2.5", "2 ^ x", "epsilon + x", "x * e - inf * 0"]


@pytest.mark.parametrize("src,args,kw,out_var", VALUE_CASES)
def test_values_agree(src, args, kw, out_var):
    yj, yt = _both(src, args, kw, out_var=out_var)
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)
    assert yt.shape == yj.shape


@pytest.mark.parametrize("src", FUNCTION_CASES)
@pytest.mark.parametrize("host", [False, True])
def test_functions_agree(src, host):
    x = float(_X[3]) if host else _X
    yj, yt = _both(src, ("x",), {"x": x})
    np.testing.assert_allclose(yt.astype(np.float64), yj.astype(np.float64),
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("src", ["x % 0.75", "x / 0.3", "x ^ 3",
                                 "x - 1.0 == 0 ? 1 : 0"])
def test_stream_operators_on_channels(src):
    x = _rng.standard_normal((3, 16)).astype(np.float32)
    yj, yt = _both(src, ("x",), {"x": x})
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)


def test_recursion_detection():
    for pkg in (jexpr, texpr):
        assert pkg.compile_expression("y := y + 0.1*x", ("x",)).reads_output
        assert not pkg.compile_expression("y := 2*x", ("x",)).reads_output
        assert not pkg.compile_expression("a*x", ("x", "a")).reads_output


# (expression, args, out_var, inputs or None for a compile-time error)
ERROR_CASES = [
    ("vecOut[7] := 1.0", ("vecIn", "vecOut"), "vecOut",
     {"vecIn": np.arange(4.0, dtype=np.float32),
      "vecOut": np.zeros(4, np.float32)}),
    ("__import__('os')", ("x",), "y", None),
    ("open(x)", ("x",), "y", None),
    ("x + qzw", ("x",), "y", None),
    ("x $ 2", ("x",), "y", None),
    ("(x + 1", ("x",), "y", None),
    ("", ("x",), "y", None),
    ("var i := 0; while (i < x) { i += 1 }; y := i", ("x",), "y",
     {"x": np.array([3.0], np.float32)}),
    ("var n := 0; repeat n += 1 until (n > x); y := n", ("x",), "y",
     {"x": np.array([3.0], np.float32)}),
    ("x[y] + 1", ("x", "y"), "z", {"x": np.arange(3.0, dtype=np.float32),
                                    "y": np.array([1.0], np.float32)}),
    ("x == \"abc\"", ("x",), "y", {"x": np.ones(2, np.float32)}),
    ("x + 'abc'", ("x",), "y", {"x": np.ones(2, np.float32)}),
    ("lower(x)", ("x",), "y", {"x": np.ones(2, np.float32)}),
    ("like(x, 'a*')", ("x",), "y", {"x": np.ones(2, np.float32)}),
    ("sin('abc')", (), "y", {}),
    ("'a' * 'b'", (), "y", {}),
    ("s[9] == 'x' ? 1 : 0", ("s",), "y", {"s": "abc"}),
    ("s[x] == 'x' ? 1 : 0", ("s", "x"), "y",
     {"s": "abc", "x": np.ones(1, np.float32)}),
    ("size(x)", ("x",), "y", {"x": 2.0}),
    ("like('a')", (), "y", None),
    ("for (var i := 0; i < 70000; i += 1) { y := i }", (), "y", {}),
]


# error cases whose message prints the operands' reprs: compared up to them
_REPR_CUT = {"x == \"abc\"": " (", "x + 'abc'": " (", "lower(x)": " got",
             "like(x, 'a*')": " ["}


@pytest.mark.parametrize("src,args,out_var,kw", ERROR_CASES)
def test_errors_agree(src, args, out_var, kw):
    if kw is None:
        _errors(lambda: jexpr.compile_expression(src, args, out_var=out_var),
                lambda: texpr.compile_expression(src, args, out_var=out_var))
        return
    jin, tin = _inputs(kw)
    fj = jexpr.compile_expression(src, args, out_var=out_var)
    ft = texpr.compile_expression(src, args, out_var=out_var)
    _errors(lambda: fj(**jin), lambda: ft(**tin), cut=_REPR_CUT.get(src))


def test_static_loop_bound_enforced_under_jit():
    """The JAX package raises inside ``jax.jit``; the port raises eagerly,
    although it could run the loop: a data-dependent bound is not part of
    the subset."""
    src = "for (var i := 0; i < vecIn[0]; i += 1) { vecOut[0] := i; }"
    args = ("vecIn", "vecOut")
    fj = jexpr.compile_expression(src, args, out_var="vecOut")
    ft = texpr.compile_expression(src, args, out_var="vecOut")
    v = np.arange(4.0, dtype=np.float32)
    msg = _errors(
        lambda: jax.jit(lambda a: fj(vecIn=a, vecOut=jnp.zeros_like(a)))(
            jnp.asarray(v)),
        lambda: ft(vecIn=torch.from_numpy(v), vecOut=torch.zeros(4)))
    assert "static" in msg


def test_index_write_leaves_inputs_alone():
    src = ("var w := vecIn; w[0] := 5; vecOut[1] := w[0] + vecIn[0]; "
           "vecOut[2] := 1")
    v = np.arange(4.0, dtype=np.float32)
    vt, ot = torch.from_numpy(v.copy()), torch.zeros(4)
    yj, yt = _both(src, ("vecIn", "vecOut"),
                   {"vecIn": v, "vecOut": np.zeros(4, np.float32)},
                   out_var="vecOut")
    np.testing.assert_array_equal(yt, yj)
    texpr.compile_expression(src, ("vecIn", "vecOut"), out_var="vecOut")(
        vecIn=vt, vecOut=ot)
    np.testing.assert_array_equal(vt.numpy(), v)
    np.testing.assert_array_equal(ot.numpy(), 0)


# -- user functions -----------------------------------------------------------

def test_global_registration_and_snapshot():
    for pkg in (jexpr, texpr):
        pkg.register_function("mysq", lambda v: v * v)
        try:
            fn = pkg.compile_expression("mysq(x) + 1", ("x",))
            assert fn(x=3.0) == 10.0
            pkg.unregister_function("mysq")
            assert fn(x=4.0) == 17.0
        finally:
            pkg.unregister_function("mysq")
    _errors(lambda: jexpr.compile_expression("mysq(x)", ("x",)),
            lambda: texpr.compile_expression("mysq(x)", ("x",)))


def test_per_expression_table():
    yj, yt = _both("dbfs(x)", ("x",), {"x": 10.0},
                   jfuncs={"dbfs": lambda v: 20.0 * jnp.log10(v)},
                   tfuncs={"dbfs": lambda v: 20.0 * math.log10(v)})
    np.testing.assert_allclose(yt, yj, rtol=RTOL)
    _errors(lambda: jexpr.compile_expression("dbfs(x)", ("x",)),
            lambda: texpr.compile_expression("dbfs(x)", ("x",)))


@pytest.mark.parametrize("src,funcs", [
    ("mix(x)", {"mix": lambda a, b: a * b}),
    ("mix(x, x, x)", {"mix": lambda a, b: a * b}),
    ("f(x, x)", {"f": (lambda *a: a[0], 1)}),
    ("for (var i := 0; i < 2; i += 1) { y := tri(x, i) }",
     {"tri": lambda v: v}),
    ("x", {"max": lambda v: v}),
    ("x", {"k": 3.0}),
    ("x", {"bad name": lambda v: v}),
])
def test_function_table_errors_agree(src, funcs):
    _errors(lambda: jexpr.compile_expression(src, ("x",), functions=funcs),
            lambda: texpr.compile_expression(src, ("x",), functions=funcs))


@pytest.mark.parametrize("bad", ["sin", "pi", "for", "sum"])
def test_builtin_shadowing_rejected(bad):
    _errors(lambda: jexpr.register_function(bad, lambda v: v),
            lambda: texpr.register_function(bad, lambda v: v))


def test_variadic_and_loop_functions():
    fj = jexpr.compile_expression("acc(x, x, x)", ("x",),
                                  functions={"acc": lambda *a: sum(a)})
    ft = texpr.compile_expression("acc(x, x, x)", ("x",),
                                  functions={"acc": lambda *a: sum(a)})
    assert fj(x=2.0) == ft(x=2.0) == 6.0
    src = ("var acc := 0; for (var i := 0; i < 4; i += 1) "
           "{ acc := acc + tri(x + i) }; y := acc")
    tri = {"tri": lambda v: v * (v + 1.0) / 2.0}
    x = _rng.standard_normal(16).astype(np.float32)
    yj, yt = _both(src, ("x",), {"x": x}, jfuncs=tri, tfuncs=tri)
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)


def test_user_function_receives_tensors():
    seen = []

    def relu6(v):
        seen.append(type(v))
        return torch.clamp(v, 0.0, 6.0)
    x = np.linspace(-5, 5, 11, dtype=np.float32)
    yj, yt = _both("relu6(a*x + b)", ("x", "a", "b"),
                   {"x": x, "a": 2.0, "b": 1.0},
                   jfuncs={"relu6": lambda v: jnp.clip(v, 0.0, 6.0)},
                   tfuncs={"relu6": relu6})
    np.testing.assert_allclose(yt, yj)
    assert seen == [torch.Tensor]


# -- the blocks through both schedulers ---------------------------------------

def _run(pkg, blocks, data, block_len=256, device=True):
    g = pkg.Graph()
    src = pkg.global_registry.create("VectorSource",
                                     data=np.asarray(data, np.float32))
    snk = pkg.global_registry.create("VectorSink")
    g.connect_chain(src, *blocks, snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    pkg.Scheduler(g, block_len=block_len, **kw).run_and_wait()
    return snk.data()


@pytest.mark.parametrize("settings,data,block_len", [
    ({"expr_string": "a*x", "param_a": 2.0},
     np.linspace(-1, 1, 300), 256),
    ({"expr_string": "y := y + 0.1*x"}, np.ones(500), 100),
    ({"expr_string":
      "clamp(-1.0, sin(2 * pi * x) + cos(x / 2 * pi), 1.0)"},
     np.linspace(-2, 2, 400), 256),
    ({"expr_string": "a*x", "param_a": 5.0}, np.ones(100), 256),
    ({"expression": "x > 0 ? x : b", "param_b": -0.5},
     np.linspace(-1, 1, 64), 32),
    ({"expression": "mode == 'double' ? 2*x : x/2", "strings": "mode=double"},
     np.arange(1024), 512),
    ({"expression": "mode == 'double' ? 2*x : x/2",
      "string_vars": {"mode": "half"}}, np.arange(1024), 512),
])
def test_siso_block_agrees(settings, data, block_len):
    yj = _run(gr, [gr.global_registry.create("ExpressionSISO", **settings)],
              data, block_len)
    yt = _run(gt, [gt.global_registry.create("ExpressionSISO", **settings)],
              data, block_len)
    assert yt.shape == yj.shape
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("settings,data,block_len", [
    ({"expr_string": "vecOut := a * vecIn", "param_a": 2.0},
     np.linspace(0, 1, 200), 256),
    ({"expr_string": "for (var i := 0; i < 64; i += 1) "
                     "{ vecOut[i] := 2 * vecIn[i]; }"}, np.arange(64), 64),
    ({"expr_string": "vecOut := vecIn / max(vecIn)"},
     np.arange(1.0, 129.0), 32),
])
def test_bulk_block_agrees(settings, data, block_len):
    yj = _run(gr, [gr.global_registry.create("ExpressionBulk", **settings)],
              data, block_len)
    yt = _run(gt, [gt.global_registry.create("ExpressionBulk", **settings)],
              data, block_len)
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("expr,param_a", [("z := a * (x + y + 2)", 3.0),
                                          ("x + y", 1.0),
                                          ("hypot(x, y) * a", 0.5)])
def test_diso_block_agrees(expr, param_a):
    x = np.arange(128, dtype=np.float32)
    y = np.arange(128, dtype=np.float32)[::-1].copy()
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        reg = pkg.global_registry
        s1 = reg.create("VectorSource", data=x)
        s2 = reg.create("VectorSource", data=y)
        ex = reg.create("ExpressionDISO", expr_string=expr, param_a=param_a)
        snk = reg.create("VectorSink")
        g.connect(s1, ex, dst_port="x")
        g.connect(s2, ex, dst_port="y")
        g.connect(ex, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=64, **kw).run_and_wait()
        outs.append(snk.data())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6)


def test_multi_output_block_agrees():
    outs = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("ConstantSource", value=3.0, n_samples=256)
        e = g.emplace("ExpressionSISO",
                      expression="mag := x * 2; ph := x - 1; y := x",
                      extra_outputs="mag,ph")
        sinks = [g.emplace("VectorSink") for _ in range(3)]
        for port, s in zip(("out", "mag", "ph"), sinks):
            g.connect(e, s, src_port=port)
        g.connect(src, e)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=128, **kw).run_and_wait()
        outs.append([s.data() for s in sinks])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(outs[1][1], 6.0)


@pytest.mark.parametrize("kw", [
    {"expression": "y := x", "extra_outputs": "nope"},
    {"expression": "y := y + x; m := x", "extra_outputs": "m"},
    {"expression": "x", "strings": "oops"},
    {"expression": "x +", "strings": ""},
])
def test_block_construction_errors_agree(kw):
    # one explicit block name: the default names count the blocks made in the
    # process, which differ between the packages with the test order
    kw = dict(kw, name="expr")
    _errors(lambda: gr.global_registry.create("ExpressionSISO", **kw),
            lambda: gt.global_registry.create("ExpressionSISO", **kw))


def test_expression_setting_alias():
    a = gt.global_registry.create("ExpressionSISO", expression="2*x")
    b = gt.global_registry.create("ExpressionSISO", expr_string="2*x")
    assert a.settings.get("expression") == b.settings.get("expression")


def test_block_user_function_and_recompile():
    data = np.linspace(-2.0, 2.0, 64).astype(np.float32)
    yj = _run(gr, [gr.global_registry.create(
        "ExpressionSISO", expr_string="y := gauss(x) * a", param_a=2.0,
        functions={"gauss": lambda v: jnp.exp(-v * v / 2.0)})], data)
    yt = _run(gt, [gt.global_registry.create(
        "ExpressionSISO", expr_string="y := gauss(x) * a", param_a=2.0,
        functions={"gauss": lambda v: torch.exp(-v * v / 2.0)})], data)
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-7)
    blk = gt.global_registry.create("ExpressionSISO",
                                    expr_string="y := dbl(x)",
                                    functions={"dbl": lambda v: 2.0 * v})
    np.testing.assert_allclose(_run(gt, [blk], data), 2.0 * data)
    blk.settings.set({"expression": "y := dbl(x) + 1"})
    blk.on_settings_applied(blk.settings.apply_staged())  # scheduler path
    assert blk._fn(x=3.0, a=1.0, b=0.0, c=0.0) == 7.0


def test_param_is_dynamic_without_recompile():
    """A Set of param_a between steps reaches the program without a new
    compile (the port hands a/b/c to it as host numbers each step)."""
    blk = gt.global_registry.create("ExpressionSISO", expression="a*x",
                                    param_a=1.0)
    g = gt.Graph()
    src = gt.global_registry.create("VectorSource",
                                    data=np.ones(256, np.float32))
    snk = gt.global_registry.create("VectorSink")
    g.connect_chain(src, blk, snk)
    s = gt.Scheduler(g, block_len=128, device="cpu")
    s.init()
    fn = blk._fn
    s.step_once()
    blk.settings.set({"param_a": 4.0})
    s.step_once()
    out = snk.data()
    assert blk._fn is fn
    np.testing.assert_allclose(out[:128], 1.0)
    np.testing.assert_allclose(out[128:], 4.0)
