"""ExprTk-subset expression compiler over torch tensors (≈ reference blocks/math
ExpressionBlocks.hpp:68, which embeds the ExprTk C++ JIT).

The expression is parsed once into an AST, and the AST is compiled once into
a tree of Python closures; each call runs the closures eagerly on the inputs'
tensors (one torch op per operator, on the inputs' device). The language is
the JAX package's subset, with its semantics:

- arithmetic ``+ - * / % ^`` (``%`` is a floor mod as ``torch.remainder``;
  ``^`` is power, right-associative), unary ±
- comparisons ``< <= > >= == != <>`` and logical ``and or not & |``
- ternary ``cond ? a : b`` and functional ``if(cond, a, b)``
- statements separated by ``;``; ``var name := expr`` declarations;
  assignments ``name := expr`` (also ``+= -= *= /=``), chained
  ``a := b := expr`` (right-associative)
- vector indexing ``vec[i]`` (read and write, static indices)
- ``for (var i := 0; i < N; i += 1) { … }``, ``while (cond) { … }`` and
  ``repeat … until (cond)`` loops with *static* bounds, unrolled: a loop
  whose condition depends on stream data raises ``GrError``, as it does in
  the JAX package, although eager torch could run it
- in-expression aggregators ``sum/avg/min/max/mul`` — one vector argument
  reduces over it (the Bulk-mode chunk axis), 2+ arguments stay elementwise
- math functions (both ExprTk and NumPy spellings) and constants pi/e/inf
- **user-defined functions** (≈ ExprTk ``symbol_table.add_function``):
  ``register_function(name, fn)`` makes a Python callable visible inside
  every expression; per-expression tables go through
  ``compile_expression(..., functions={...})``. Arity is checked at parse
  time. The callable receives torch tensors (or Python numbers where the
  program passes constants).
- **strings**: literals ``'…'``/``"…"``, string variables (inputs or
  ``var s := '…'``), concatenation ``+``, all six comparisons, single-char
  indexing ``s[i]``, and ``size/lower/upper/trim/like/ilike/contains``.
  Strings are host values that fold when the program runs: a string
  comparison yields a host bool, so ``mode == 'fm' ? a*x : b*x`` runs one
  branch only. Mixing a string into arithmetic raises ``GrError``.

Host values and data: Python numbers and bools are host values (loop bounds,
indices, foldable conditions); every tensor is stream data. Constant-only
calls (``sin(pi/2)``) compute in float32, as JAX computes them, and return a
Python number.

Recursive self-reference (ExprTk's ``y := y + 0.1*x`` IIR idiom) is detected
statically (``reads_output``); the SISO block then runs the program sample by
sample with the output carried.
"""

from __future__ import annotations

import fnmatch
import inspect
import math
import re
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..core.errors import GrError

# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | (?P<str>'[^']*'|"[^"]*")
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op>:=|\+=|-=|\*=|/=|<=|>=|==|!=|<>|\|\||&&|[-+*/%^(){}\[\],;?:<>=|&])
  | (?P<ws>\s+)
  | (?P<bad>.)
""", re.VERBOSE)


def _tokenize(src: str) -> list[tuple[str, str]]:
    toks: list[tuple[str, str]] = []
    for m in _TOKEN_RE.finditer(src):
        kind = m.lastgroup
        if kind == "ws":
            continue
        if kind == "str":
            toks.append(("str", m.group()[1:-1]))
            continue
        if kind == "bad":
            raise GrError(f"expression: unexpected character {m.group()!r} "
                          f"at position {m.start()} in {src!r}")
        toks.append((kind, m.group()))
    toks.append(("end", ""))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class Num:
    value: float


@dataclass
class Str:
    value: str


@dataclass
class Var:
    name: str


@dataclass
class BinOp:
    op: str
    lhs: Any
    rhs: Any


@dataclass
class UnOp:
    op: str
    operand: Any


@dataclass
class Ternary:
    cond: Any
    then: Any
    other: Any


@dataclass
class Call:
    name: str
    args: list


@dataclass
class Index:
    base: str
    index: Any


@dataclass
class Assign:
    target: Any      # Var or Index
    expr: Any
    declare: bool = False


@dataclass
class For:
    init: Any
    cond: Any
    step: Any
    body: list


@dataclass
class While:
    cond: Any
    body: list


@dataclass
class Repeat:          # repeat <body> until (cond)
    body: list
    cond: Any


# ---------------------------------------------------------------------------
# Parser (recursive descent, ExprTk precedence)
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: list[tuple[str, str]], src: str):
        self.toks = toks
        self.i = 0
        self.src = src

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> None:
        kind, val = self.next()
        if val != text:
            raise GrError(f"expression: expected {text!r}, got {val!r} "
                          f"in {self.src!r}")

    # -- statements --------------------------------------------------------

    def parse_program(self, *, stop: str = "") -> list:
        stmts: list = []
        while True:
            kind, val = self.peek()
            if kind == "end" or (stop and val == stop):
                break
            if val == ";":
                self.next()
                continue
            stmts.append(self.parse_statement())
        return stmts

    def parse_statement(self):
        kind, val = self.peek()
        if val == "var":
            self.next()
            _, name = self.next()
            self.expect(":=")
            return Assign(Var(name), self.parse_expr(), declare=True)
        if val == "for":
            return self.parse_for()
        if val == "while":
            return self.parse_while()
        if val == "repeat":
            return self.parse_repeat()
        # lookahead for assignment: NAME [índex] (:=|+=|...)
        save = self.i
        if kind == "name":
            self.next()
            target: Any = Var(val)
            if self.peek()[1] == "[":
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                target = Index(val, idx)
            op = self.peek()[1]
            if op in (":=", "+=", "-=", "*=", "/="):
                self.next()
                # chained assignment a := b := expr (ExprTk := is
                # right-associative): the rhs may itself be an assignment
                rhs = self.parse_statement() if op == ":=" \
                    else self.parse_expr()
                if op != ":=":
                    read = Var(val) if isinstance(target, Var) \
                        else Index(val, target.index)
                    rhs = BinOp(op[0], read, rhs)
                return Assign(target, rhs)
            self.i = save
        return self.parse_expr()

    def parse_for(self) -> For:
        self.expect("for")
        self.expect("(")
        init = self.parse_statement()
        self.expect(";")
        cond = self.parse_expr()
        self.expect(";")
        step = self.parse_statement()
        self.expect(")")
        self.expect("{")
        body = self.parse_program(stop="}")
        self.expect("}")
        return For(init, cond, step, body)

    def parse_while(self) -> While:
        """``while (cond) { … }`` — static bounds, unrolled
        (ExprTk while-loop, ExpressionBlocks.hpp:68 embedded grammar)."""
        self.expect("while")
        self.expect("(")
        cond = self.parse_expr()
        self.expect(")")
        self.expect("{")
        body = self.parse_program(stop="}")
        self.expect("}")
        return While(cond, body)

    def parse_repeat(self) -> Repeat:
        """``repeat … until (cond)`` — body runs at least once; static
        bounds, unrolled (ExprTk repeat-until grammar)."""
        self.expect("repeat")
        body = self.parse_program(stop="until")
        self.expect("until")
        self.expect("(")
        cond = self.parse_expr()
        self.expect(")")
        return Repeat(body, cond)

    # -- expressions --------------------------------------------------------

    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        cond = self.parse_or()
        if self.peek()[1] == "?":
            self.next()
            then = self.parse_expr()
            self.expect(":")
            other = self.parse_expr()
            return Ternary(cond, then, other)
        return cond

    def parse_or(self):
        node = self.parse_and()
        while self.peek()[1] in ("or", "|", "||"):
            self.next()
            node = BinOp("or", node, self.parse_and())
        return node

    def parse_and(self):
        node = self.parse_not()
        while self.peek()[1] in ("and", "&", "&&"):
            self.next()
            node = BinOp("and", node, self.parse_not())
        return node

    def parse_not(self):
        if self.peek()[1] == "not":
            self.next()
            return UnOp("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self):
        node = self.parse_add()
        op = self.peek()[1]
        if op in ("<", "<=", ">", ">=", "==", "=", "!=", "<>"):
            self.next()
            node = BinOp("==" if op == "=" else op, node, self.parse_add())
        return node

    def parse_add(self):
        node = self.parse_mul()
        while self.peek()[1] in ("+", "-"):
            _, op = self.next()
            node = BinOp(op, node, self.parse_mul())
        return node

    def parse_mul(self):
        node = self.parse_unary()
        while self.peek()[1] in ("*", "/", "%"):
            _, op = self.next()
            node = BinOp(op, node, self.parse_unary())
        return node

    def parse_unary(self):
        kind, val = self.peek()
        if val in ("+", "-"):
            self.next()
            operand = self.parse_unary()
            return operand if val == "+" else UnOp("-", operand)
        return self.parse_power()

    def parse_power(self):
        base = self.parse_postfix()
        if self.peek()[1] == "^":
            self.next()
            return BinOp("^", base, self.parse_unary())  # right-assoc
        return base

    def parse_postfix(self):
        node = self.parse_atom()
        while self.peek()[1] == "[":
            if not isinstance(node, Var):
                raise GrError("expression: indexing is only supported on "
                              "named vectors")
            self.next()
            idx = self.parse_expr()
            self.expect("]")
            node = Index(node.name, idx)
        return node

    def parse_atom(self):
        kind, val = self.next()
        if kind == "num":
            return Num(float(val))
        if kind == "str":
            return Str(val)
        if val == "(":
            node = self.parse_expr()
            self.expect(")")
            return node
        if kind == "name":
            if self.peek()[1] == "(":
                self.next()
                args = []
                if self.peek()[1] != ")":
                    args.append(self.parse_expr())
                    while self.peek()[1] == ",":
                        self.next()
                        args.append(self.parse_expr())
                self.expect(")")
                return Call(val, args)
            return Var(val)
        raise GrError(f"expression: unexpected token {val!r} in {self.src!r}")



# ---------------------------------------------------------------------------
# Function / constant tables (ExprTk names + NumPy aliases for back-compat)
# ---------------------------------------------------------------------------

_STRING_FUNCTIONS: dict[str, int] = {
    "size": 1, "lower": 1, "upper": 1, "trim": 1,
    "like": 2, "ilike": 2, "contains": 2,
}


def _is_concrete(v) -> bool:
    """A host value: a Python/NumPy number or bool. Tensors are stream data."""
    return isinstance(v, (int, float, bool, np.number, np.bool_))


def _scalar_tensor(v) -> torch.Tensor:
    """A host number as a 0-d CPU tensor: float32 as JAX types a Python float,
    bool for a bool. Torch takes a 0-d CPU tensor beside a CUDA tensor as a
    scalar argument, so this uploads nothing."""
    if isinstance(v, (bool, np.bool_)):
        return torch.tensor(bool(v))
    return torch.tensor(float(v), dtype=torch.float32)


def _host(fn: Callable) -> Callable:
    """Wrap a tensor function: with no tensor among its arguments it runs on
    0-d float32 CPU tensors and returns a Python number (a constant call
    folds on the host, in JAX's float32)."""
    def call(*args):
        if any(isinstance(a, torch.Tensor) for a in args):
            return fn(*args)
        return fn(*(_scalar_tensor(a) for a in args)).item()
    return call


def _tensors(*args) -> list:
    return [a if isinstance(a, torch.Tensor) else _scalar_tensor(a)
            for a in args]


def _binary(fn: Callable) -> Callable:
    """A two-tensor torch function that takes host numbers on either side."""
    return _host(lambda a, b: fn(*_tensors(a, b)))


def _clip(v, lo, hi):
    if not isinstance(v, torch.Tensor):
        v = _scalar_tensor(v)
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        lo, hi = _tensors(lo, hi)
    return torch.clamp(v, lo, hi)


def _if(cond, a, b):
    """``jnp.where``: a nonzero condition is true; a host condition beside
    tensor branches becomes a 0-d bool on their device."""
    if not isinstance(cond, torch.Tensor):
        dev = next(v.device for v in (a, b) if isinstance(v, torch.Tensor))
        cond = torch.full((), bool(cond), dtype=torch.bool, device=dev)
    elif cond.dtype != torch.bool:
        cond = cond != 0
    return torch.where(cond, a, b)


def _imag(x):
    return x.imag if x.is_complex() else torch.zeros_like(x)


def _sum_elem(args):
    out = args[0]
    for x in args[1:]:
        out = out + x
    return out


def _prod_elem(args):
    out = args[0]
    for x in args[1:]:
        out = out * x
    return out


_FUNCTIONS: dict[str, Any] = {
    # trigonometry (ExprTk + numpy spellings)
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "atan2": torch.atan2, "arcsin": torch.asin, "arccos": torch.acos,
    "arctan": torch.atan, "arctan2": torch.atan2,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "sec": lambda x: 1.0 / torch.cos(x), "csc": lambda x: 1.0 / torch.sin(x),
    "cot": lambda x: 1.0 / torch.tan(x),
    "deg2rad": torch.deg2rad, "rad2deg": torch.rad2deg,
    # exponential / rounding
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log10": torch.log10, "log2": torch.log2, "log1p": torch.log1p,
    "sqrt": torch.sqrt, "abs": torch.abs, "floor": torch.floor,
    "ceil": torch.ceil, "round": torch.round, "trunc": torch.trunc,
    "sign": torch.sign, "frac": lambda x: x - torch.trunc(x),
    # min/max/clamping
    "min": torch.minimum, "max": torch.maximum, "minimum": torch.minimum,
    "maximum": torch.maximum,
    "inrange": lambda lo, v, hi: torch.logical_and(lo <= v, v <= hi),
    # misc
    "pow": torch.pow, "power": torch.pow, "hypot": torch.hypot,
    "mod": torch.remainder, "root": lambda x, n: torch.pow(x, 1.0 / n),
    # complex helpers (numpy back-compat)
    "real": torch.real, "imag": _imag, "conj": torch.conj_physical,
    "angle": torch.angle,
}
_BINARY = ("atan2", "arctan2", "min", "max", "minimum", "maximum", "pow",
           "power", "hypot", "mod")
_FUNCTIONS = {k: _binary(f) if k in _BINARY else _host(f)
              for k, f in _FUNCTIONS.items()}
_FUNCTIONS.update({
    # these take host numbers and tensors as they come
    "clamp": _host(lambda lo, v, hi: _clip(v, lo, hi)),
    "clip": _host(_clip),
    "if": _host(_if), "where": _host(_if),
    "avg": lambda *a: sum(a) / len(a),
    # elementwise multi-arg forms of the aggregator names (the one-vector
    # reducing forms are special-cased via _AGGREGATORS in Call evaluation)
    "sum": lambda *a: _sum_elem(a),
    "mul": lambda *a: math.prod(a) if all(_is_concrete(x) for x in a)
    else _prod_elem(a),
})

_CONSTANTS = {"pi": math.pi, "e": math.e, "inf": math.inf,
              "epsilon": 2.220446049250313e-16, "true": 1.0, "false": 0.0}


def _mean(v: torch.Tensor) -> torch.Tensor:
    if not (v.is_floating_point() or v.is_complex()):
        v = v.to(torch.float32)
    return torch.mean(v, dim=-1)


# single-vector-argument reductions over the last axis (ExprTk aggregator
# forms sum(v)/avg(v)/min(v)/max(v)/mul(v); multi-arg calls stay elementwise)
_AGGREGATORS = {
    "sum": lambda v: torch.sum(v, dim=-1),
    "avg": _mean,
    "min": lambda v: torch.amin(v, dim=-1),
    "max": lambda v: torch.amax(v, dim=-1),
    "mul": lambda v: torch.prod(v, dim=-1),
}

_MAX_UNROLL = 65536

# ---------------------------------------------------------------------------
# User-defined functions (≈ ExprTk symbol_table.add_function — the reference
# registers C++ functors into its embedded interpreter, ExpressionBlocks.hpp:68;
# here the registered Python callable runs on the program's tensors)
# ---------------------------------------------------------------------------

_KEYWORDS = {"var", "for", "while", "repeat", "until", "and", "or", "not"}

# global registry: name -> (callable, arity | None for variadic)
_USER_FUNCTIONS: dict[str, tuple[Any, int | None]] = {}


def _infer_arity(fn) -> int | None:
    """Positional-parameter count of ``fn``; None when variadic/opaque."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    n = 0
    for p in sig.parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            return None
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            if p.default is not p.empty:
                return None          # optional args: skip the strict check
            n += 1
        elif p.default is p.empty:   # required keyword-only: not callable here
            return None
    return n


def _validated_entry(name: str, fn, arity: int | None) -> tuple[Any, int | None]:
    if not (isinstance(name, str) and name.isidentifier()):
        raise GrError(f"expression: invalid function name {name!r}")
    if name in _FUNCTIONS or name in _CONSTANTS or name in _KEYWORDS \
            or name in _AGGREGATORS:
        raise GrError(f"expression: cannot register {name!r} — it shadows a "
                      f"built-in function/constant/keyword")
    if not callable(fn):
        raise GrError(f"expression: function {name!r} is not callable")
    return (fn, _infer_arity(fn) if arity is None else int(arity))


def register_function(name: str, fn, arity: int | None = None) -> None:
    """Register a user-defined function visible inside ALL expressions
    (≈ ExprTk ``symbol_table.add_function``, ExpressionBlocks.hpp:68).

    ``fn`` receives torch tensors (or Python numbers) positionally and
    returns one value. ``arity`` defaults to the callable's
    positional-parameter count and is enforced at parse time; variadic
    callables get no arity check."""
    _USER_FUNCTIONS[name] = _validated_entry(name, fn, arity)


def unregister_function(name: str) -> None:
    _USER_FUNCTIONS.pop(name, None)


# ---------------------------------------------------------------------------
# Evaluator: the AST compiled once into closures over a run's environment
# ---------------------------------------------------------------------------

class _Run:
    """One call's environment. ``owned`` holds the ids of tensors this run
    copied for an index write, which later index writes may change in
    place."""

    __slots__ = ("env", "owned")

    def __init__(self, env: dict):
        self.env = env
        self.owned: set[int] = set()


def _str_binop(op: str, a, b):
    if not (isinstance(a, str) and isinstance(b, str)):
        raise GrError(
            f"expression: operator {op!r} cannot mix a string with a "
            f"number ({a!r} {op} {b!r}); strings combine only with "
            f"strings")
    if op == "+":
        return a + b
    cmps = {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b,
            "==": a == b, "!=": a != b, "<>": a != b}
    if op in cmps:
        return bool(cmps[op])
    raise GrError(f"expression: operator {op!r} is not defined for "
                  f"strings (supported: + and comparisons)")


def _logic(op: str, a, b):
    """``and``/``or``: host bools when both sides are host values, else a
    bool tensor (nonzero is true, as ``jnp.logical_and`` casts)."""
    if _is_concrete(a) and _is_concrete(b):
        return (bool(a) and bool(b)) if op == "and" else (bool(a) or bool(b))
    if _is_concrete(a):
        a, b = b, a
    if _is_concrete(b):
        if bool(b) == (op == "and"):
            return a.bool()
        return torch.full_like(a, op == "or", dtype=torch.bool)
    return torch.logical_and(a, b) if op == "and" else torch.logical_or(a, b)


_ARITH: dict[str, Callable] = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "%": lambda a, b: a % b, "^": lambda a, b: a ** b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<>": lambda a, b: a != b,
}


class _Evaluator:
    """Compiles statements into closures ``f(run) -> value``; the closures
    raise the JAX evaluator's ``GrError`` for the same programs."""

    def __init__(self, src: str,
                 funcs: dict[str, tuple[Any, int | None]] | None = None):
        self.src = src
        self.funcs = funcs if funcs is not None else _USER_FUNCTIONS

    def program(self, stmts: list) -> Callable:
        fs = [self.stmt(s) for s in stmts]

        def run(r):
            last = None
            for f in fs:
                last = f(r)
            return last
        return run

    # -- statements --------------------------------------------------------
    def stmt(self, node) -> Callable:
        if isinstance(node, Assign):
            return self.assign(node)
        if isinstance(node, For):
            init = self.stmt(node.init)
            loop = self.loop("for", node.cond, node.body, node.step)

            def run_for(r):
                init(r)
                loop(r)
            return run_for
        if isinstance(node, While):
            return self.loop("while", node.cond, node.body, None)
        if isinstance(node, Repeat):
            return self.repeat(node)
        return self.expr(node)

    def assign(self, node: Assign) -> Callable:
        value = self.expr(node.expr)
        if isinstance(node.target, Var):
            name = node.target.name

            def set_var(r):
                val = value(r)
                # a tensor this run owns is now shared by two names: the
                # next index write to either copies it again
                r.owned.discard(id(val))
                r.env[name] = val
                return val
            return set_var
        base_name = node.target.base
        index = self.expr(node.target.index)
        lookup = self.var(base_name)

        def set_item(r):   # index write on the last axis
            val = value(r)
            base = lookup(r)
            i = _static_index(index(r), base)
            if not isinstance(base, torch.Tensor):
                base = torch.as_tensor(base)
            if id(base) not in r.owned:
                base = base.clone()
                r.owned.add(id(base))
                r.env[base_name] = base
            base[..., i] = val
            return val
        return set_item

    def loop(self, kind: str, cond_node, body: list, step) -> Callable:
        cond = self.expr(cond_node)
        run_body = self.program(body)
        run_step = self.stmt(step) if step is not None else None

        def run_loop(r):
            iters = 0
            while True:
                c = cond(r)
                if not _is_concrete(c):
                    raise GrError(f"expression: {kind}-loop bounds must be "
                                  f"static (loop variables and limits must "
                                  f"be plain numbers, not stream data)")
                if not bool(c):
                    break
                run_body(r)
                if run_step is not None:
                    run_step(r)
                iters += 1
                if iters > _MAX_UNROLL:
                    raise GrError(f"expression: {kind}-loop exceeds "
                                  f"{_MAX_UNROLL} iterations")
        return run_loop

    def repeat(self, node: Repeat) -> Callable:
        run_body = self.program(node.body)
        cond = self.expr(node.cond)

        def run_repeat(r):
            # body runs at least once, repeats UNTIL cond becomes true
            iters = 0
            while True:
                run_body(r)
                c = cond(r)
                if not _is_concrete(c):
                    raise GrError(
                        "expression: repeat-until condition must be static "
                        "(loop variables and limits must be plain numbers, "
                        "not stream data — data-dependent iteration is not "
                        "part of the unrolled subset)")
                if bool(c):
                    break
                iters += 1
                if iters > _MAX_UNROLL:
                    raise GrError(f"expression: repeat-until exceeds "
                                  f"{_MAX_UNROLL} iterations")
        return run_repeat

    # -- expressions -------------------------------------------------------
    def var(self, name: str) -> Callable:
        def lookup(r):
            env = r.env
            if name in env:
                return env[name]
            if name in _CONSTANTS:
                return _CONSTANTS[name]
            raise GrError(f"expression uses unknown name {name!r}; allowed: "
                          f"{sorted(set(env) | set(_CONSTANTS))} "
                          f"+ functions {sorted(_FUNCTIONS)}")
        return lookup

    def expr(self, node) -> Callable:
        if isinstance(node, Assign):    # chained a := b := expr
            return self.assign(node)
        if isinstance(node, (Num, Str)):
            value = node.value
            return lambda r: value
        if isinstance(node, Var):
            return self.var(node.name)
        if isinstance(node, Index):
            return self.index(node)
        if isinstance(node, UnOp):
            operand = self.expr(node.operand)
            if node.op == "-":
                return lambda r: -operand(r)

            def run_not(r):
                v = operand(r)
                return (not bool(v)) if _is_concrete(v) \
                    else torch.logical_not(v)
            return run_not
        if isinstance(node, BinOp):
            return self.binop(node)
        if isinstance(node, Ternary):
            cond, then, other = (self.expr(n) for n in
                                 (node.cond, node.then, node.other))

            def run_ternary(r):
                c = cond(r)
                if _is_concrete(c):
                    # host-decidable condition (e.g. a string comparison):
                    # short-circuit like ExprTk — the branches may then be
                    # strings, which have no tensor select
                    return then(r) if bool(c) else other(r)
                return _if(c, then(r), other(r))
            return run_ternary
        if isinstance(node, Call):
            return self.call(node)
        raise GrError(f"expression: cannot evaluate {node!r}")

    def index(self, node: Index) -> Callable:
        lookup = self.var(node.base)
        index = self.expr(node.index)

        def run_index(r):
            base = lookup(r)
            if isinstance(base, str):
                # ExprTk string indexing: s[i] → one-character string
                idx = index(r)
                if not _is_concrete(idx):
                    raise GrError("expression: string indices must be static")
                i = int(idx)
                if not 0 <= i < len(base):
                    raise GrError(f"expression: string access [{i}] outside "
                                  f"of [0, {len(base)})")
                return base[i]
            i = _static_index(index(r), base)
            return torch.as_tensor(base)[..., i]
        return run_index

    def binop(self, node: BinOp) -> Callable:
        lhs, rhs = self.expr(node.lhs), self.expr(node.rhs)
        op = node.op
        if op in ("and", "or"):
            return lambda r: _logic(op, lhs(r), rhs(r))
        fn = _ARITH.get(op)
        if fn is None:
            def unknown(r):
                raise GrError(f"expression: unknown operator {op!r}")
            return unknown

        def run_binop(r):
            a, b = lhs(r), rhs(r)
            if isinstance(a, str) or isinstance(b, str):
                return _str_binop(op, a, b)
            return fn(a, b)
        return run_binop

    def call(self, node: Call) -> Callable:
        name = node.name
        args_fs = [self.expr(a) for a in node.args]
        funcs = self.funcs

        def run_call(r):
            args = [f(r) for f in args_fs]
            if any(isinstance(a, str) for a in args):
                return self._str_call(name, args)
            # ExprTk in-expression aggregators: with ONE vector argument,
            # sum/avg/min/max/mul REDUCE over the vector (the chunk axis in
            # Bulk mode); with 2+ args they stay elementwise
            if name in _AGGREGATORS and len(args) == 1:
                v = args[0]
                if isinstance(v, torch.Tensor) and v.ndim >= 1:
                    return _AGGREGATORS[name](v)
                return v
            fn = _FUNCTIONS.get(name)
            if fn is None and name in funcs:
                fn = funcs[name][0]
            if fn is None and name in _STRING_FUNCTIONS:
                if name == "size":
                    # size() also works on vectors (ExprTk vector size); a
                    # scalar has no size
                    shape = tuple(args[0].shape) \
                        if isinstance(args[0], torch.Tensor) \
                        else np.shape(args[0])
                    if not shape:
                        raise GrError("expression: size() needs a string "
                                      "or a vector, got a scalar")
                    return float(shape[-1])
                raise GrError(f"expression: {name}() needs string "
                              f"arguments, got {args!r}")
            if fn is None:
                raise GrError(f"expression uses unknown function "
                              f"{name!r}; allowed: "
                              f"{sorted(set(_FUNCTIONS) | set(funcs))}")
            return fn(*args)
        return run_call

    # -- string subset (≈ ExprTk string type, ExpressionBlocks.hpp:68) -----
    def _str_call(self, name: str, args: list):
        fns = {
            "size": lambda s: float(len(s)),
            "lower": lambda s: s.lower(),
            "upper": lambda s: s.upper(),
            "trim": lambda s: s.strip(),
            # ExprTk exposes like/ilike as wildcard string matchers
            "like": lambda s, p: bool(fnmatch.fnmatchcase(s, p)),
            "ilike": lambda s, p: bool(
                fnmatch.fnmatchcase(s.lower(), p.lower())),
            "contains": lambda s, p: bool(p in s),
        }
        fn = fns.get(name)
        if fn is None:
            if name in self.funcs:      # user functions may take strings
                return self.funcs[name][0](*args)
            raise GrError(
                f"expression: function {name!r} does not accept string "
                f"arguments; string functions: {sorted(fns)}")
        try:
            return fn(*args)
        except TypeError:
            raise GrError(f"expression: {name}() called with wrong "
                          f"arguments {args!r}") from None


def _static_index(idx, base) -> int:
    if not _is_concrete(idx):
        raise GrError("expression: vector indices must be static")
    i = int(idx)
    size = (tuple(base.shape) if isinstance(base, torch.Tensor)
            else np.shape(base))[-1]
    if not 0 <= i < size:
        # ≈ the reference's vector_access_runtime_check
        # (ExpressionBlocks.hpp:48 handle_runtime_violation)
        raise GrError(f"expression: vector access [{i}] outside of "
                      f"[0, {size})")
    return i

# ---------------------------------------------------------------------------
# Static analysis + public API
# ---------------------------------------------------------------------------

def _collect_reads(node, reads: set, writes: set,
                   funcs: dict[str, tuple[Any, int | None]] | None = None
                   ) -> None:
    if funcs is None:
        funcs = _USER_FUNCTIONS
    if isinstance(node, list):
        for n in node:
            _collect_reads(n, reads, writes, funcs)
    elif isinstance(node, Assign):
        _collect_reads(node.expr, reads, writes, funcs)
        if isinstance(node.target, Index):
            _collect_reads(node.target.index, reads, writes, funcs)
            reads.add(node.target.base)  # read-modify-write of the vector
            writes.add(node.target.base)
        else:
            writes.add(node.target.name)
    elif isinstance(node, Var):
        reads.add(node.name)
    elif isinstance(node, Index):
        reads.add(node.base)
        _collect_reads(node.index, reads, writes, funcs)
    elif isinstance(node, BinOp):
        _collect_reads(node.lhs, reads, writes, funcs)
        _collect_reads(node.rhs, reads, writes, funcs)
    elif isinstance(node, UnOp):
        _collect_reads(node.operand, reads, writes, funcs)
    elif isinstance(node, Ternary):
        for n in (node.cond, node.then, node.other):
            _collect_reads(n, reads, writes, funcs)
    elif isinstance(node, Call):
        if node.name not in _FUNCTIONS and node.name not in funcs \
                and node.name not in _STRING_FUNCTIONS:
            allowed = sorted(set(_FUNCTIONS) | set(funcs)
                             | set(_STRING_FUNCTIONS))
            raise GrError(f"expression uses unknown function {node.name!r}; "
                          f"allowed: {allowed}")
        if node.name in _STRING_FUNCTIONS \
                and node.name not in _FUNCTIONS and node.name not in funcs \
                and len(node.args) != _STRING_FUNCTIONS[node.name]:
            raise GrError(
                f"expression: {node.name}() takes "
                f"{_STRING_FUNCTIONS[node.name]} argument(s), called with "
                f"{len(node.args)}")
        if node.name in funcs:
            # parse-time arity check (≈ ExprTk's compile error on a
            # wrong-arity call into a registered function)
            arity = funcs[node.name][1]
            if arity is not None and len(node.args) != arity:
                raise GrError(
                    f"expression: user function {node.name!r} takes "
                    f"{arity} argument{'s' if arity != 1 else ''}, "
                    f"called with {len(node.args)}")
        for n in node.args:
            _collect_reads(n, reads, writes, funcs)
    elif isinstance(node, For):
        for n in (node.init, node.cond, node.step):
            _collect_reads(n, reads, writes, funcs)
        _collect_reads(node.body, reads, writes, funcs)
    elif isinstance(node, While):
        _collect_reads(node.cond, reads, writes, funcs)
        _collect_reads(node.body, reads, writes, funcs)
    elif isinstance(node, Repeat):
        _collect_reads(node.body, reads, writes, funcs)
        _collect_reads(node.cond, reads, writes, funcs)



class CompiledExpression:
    """A parsed ExprTk-subset program, callable with named inputs.

    ``out_var``: value returned is the last assignment to this variable if
    the program assigns it, else the value of the last statement (the
    ExprTk convention: ``y := a*x`` and bare ``a*x`` are equivalent).
    ``reads_output`` is True when the program reads ``out_var`` — the
    recursive-IIR idiom, run sample by sample.
    """

    def __init__(self, src: str, arg_names: tuple[str, ...],
                 out_var: str = "y",
                 functions: dict[str, Any] | None = None):
        self.src = src
        self.arg_names = arg_names
        self.out_var = out_var
        # effective function table = global registry overlaid with the
        # per-expression table (≈ ExprTk: one symbol_table per expression,
        # ExpressionBlocks.hpp:68). Snapshotted at compile time so later
        # registry mutation can't silently change a compiled program.
        self.functions: dict[str, tuple[Any, int | None]] = \
            dict(_USER_FUNCTIONS)
        for fname, fv in (functions or {}).items():
            fn, arity = fv if isinstance(fv, tuple) else (fv, None)
            self.functions[fname] = _validated_entry(fname, fn, arity)
        self.stmts = _Parser(_tokenize(src), src).parse_program()
        if not self.stmts:
            raise GrError(f"expression: empty program in {src!r}")
        reads: set = set()
        self.writes: set = set()
        _collect_reads(self.stmts, reads, self.writes, self.functions)
        known = set(arg_names) | set(_CONSTANTS) | self.writes | {out_var}
        unknown = reads - known
        if unknown:
            raise GrError(f"expression uses unknown name "
                          f"{sorted(unknown)[0]!r}; allowed: "
                          f"{sorted(set(arg_names) | set(_CONSTANTS))} "
                          f"+ functions {sorted(_FUNCTIONS)}")
        self.reads_output = (out_var in reads) and (out_var not in arg_names)
        self._run = _Evaluator(src, self.functions).program(self.stmts)

    def _execute(self, inputs: dict) -> tuple[Any, dict]:
        env = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in inputs.items()}
        last = self._run(_Run(env))
        return (env[self.out_var] if self.out_var in self.writes else last), env

    def __call__(self, **inputs):
        return self._execute(inputs)[0]

    def eval_all(self, **inputs) -> tuple[Any, dict]:
        """Run the program and return ``(result, {written_var: value})`` —
        the multi-output form (ExprTk programs may assign several result
        variables; each written name can feed its own output port)."""
        result, env = self._execute(inputs)
        return result, {k: env[k] for k in self.writes if k in env}


def compile_expression(src: str, arg_names: tuple[str, ...],
                       out_var: str = "y",
                       functions: dict[str, Any] | None = None
                       ) -> CompiledExpression:
    """Parse + statically check an ExprTk-subset expression.

    ``functions`` maps extra names to Python callables (or ``(callable,
    arity)`` tuples) visible inside this expression only, layered over the
    global ``register_function`` registry."""
    return CompiledExpression(src, arg_names, out_var=out_var,
                              functions=functions)
