"""Expression blocks (≈ reference blocks/math ExpressionBlocks.hpp:68).

Of the JAX package's ``blocks/misc.py`` this file holds the ExprTk-subset
blocks ``ExpressionSISO``, ``ExpressionDISO`` and ``ExpressionBulk``; the
other blocks of that file are not ported yet.
"""

from __future__ import annotations

import torch

from ..core.block import Block, Port
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.expression import compile_expression


def _like(v, x: torch.Tensor) -> torch.Tensor:
    """A program's result as a tensor of ``x``'s dtype and shape (a constant
    result fills it)."""
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v.to(x.dtype), x.shape)
    return torch.full_like(x, v)


class _ExpressionBase(Block):
    """Shared plumbing for the ExprTk-subset expression blocks
    (≈ ExpressionBlocks.hpp:68): the expression string is parsed and compiled
    once by ``ops.expression`` and runs as torch ops on the block's tensors.
    Free parameters a/b/c mirror the reference's ``param_a/b/c`` Annotated
    settings and are *dynamic* (retunable without a recompile); they reach
    the program as host numbers."""

    expression = Setting(default="x", kind="static")
    param_a = Setting(default=1.0, description="free parameter 'a'")
    param_b = Setting(default=0.0, description="free parameter 'b'")
    param_c = Setting(default=0.0, description="free parameter 'c'")

    _ARGS: tuple[str, ...] = ("x",)
    _OUT_VAR = "y"

    # string variables (≈ ExprTk symbol_table.add_stringvar): "k=v,k2=v2";
    # host values, so a change recompiles the program like any static setting
    strings = Setting(default="", kind="static",
                      description="expression string variables as "
                                  "'name=value[,name2=value2…]' — host "
                                  "constants of the program (ExprTk "
                                  "stringvar)")

    def __init__(self, name=None, expr_string=None, functions=None,
                 string_vars=None, **settings):
        if expr_string is not None:      # reference setting-name alias
            settings.setdefault("expression", expr_string)
        if string_vars:                  # dict convenience constructor form
            settings.setdefault("strings", ",".join(
                f"{k}={v}" for k, v in string_vars.items()))
        # per-block user functions (≈ ExprTk symbol_table.add_function,
        # ExpressionBlocks.hpp:68): name -> callable (or (fn, arity)) on the
        # program's tensors; layered over the global
        # ops.expression.register_function registry
        self._user_functions = dict(functions or {})
        super().__init__(name=name, **settings)
        self._compile_expr()

    def _string_vars(self) -> dict[str, str]:
        raw = str(self.settings.get("strings")).strip()
        out: dict[str, str] = {}
        for part in (p for p in raw.split(",") if p.strip()):
            if "=" not in part:
                raise GrError(f"{self.name}: strings entry {part!r} is not "
                              f"'name=value'")
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
        return out

    def _compile_expr(self):
        self._strs = self._string_vars()
        self._fn = compile_expression(
            str(self.settings.get("expression")),
            self._ARGS + ("a", "b", "c") + tuple(self._strs),
            out_var=self._OUT_VAR, functions=self._user_functions)

    def on_settings_applied(self, result):
        if "expression" in result.applied or "strings" in result.applied:
            self._compile_expr()

    def _abc(self, ctx) -> dict:
        return {"a": float(ctx.p("param_a", 1.0)),
                "b": float(ctx.p("param_b", 0.0)),
                "c": float(ctx.p("param_c", 0.0)),
                **self._strs}


@register_block("ExpressionSISO")
class ExpressionSISO(_ExpressionBase):
    """y = f(x) per sample (≈ ExpressionSISO, ExpressionBlocks.hpp:68).

    The reference's recursive idiom ``y := y + 0.1*x`` (its doc example of
    an IIR-like update where ``y`` is the previous output) is detected
    statically and run sample by sample with ``y`` carried across scheduler
    steps; pure expressions run once over the whole block."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    extra_outputs = Setting(default="", kind="static",
                            description="comma-separated expression variables "
                                        "exposed as additional output ports "
                                        "(multi-output assignment)")

    def __init__(self, name=None, expr_string=None, functions=None,
                 **settings):
        super().__init__(name=name, expr_string=expr_string,
                         functions=functions, **settings)
        extra = [s.strip() for s in
                 str(self.settings.get("extra_outputs")).split(",")
                 if s.strip()]
        if extra:
            missing = [v for v in extra if v not in self._fn.writes]
            if missing:
                raise GrError(f"extra_outputs {missing} are never assigned "
                              f"by the expression (writes: "
                              f"{sorted(self._fn.writes)})")
            if self._fn.reads_output:
                raise GrError("extra_outputs cannot combine with the "
                              "recursive y-feedback idiom (the loop carries "
                              "only y)")
            self.out_ports = (Port("out"),
                              *(Port(v) for v in extra))
        self._extra = extra

    def init_state(self, ctx):
        if not self._fn.reads_output:
            return ()
        ch = ctx.channels.get("in", 0)
        return torch.zeros((ch,) if ch else (), dtype=torch.float32,
                           device=ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        abc = self._abc(ctx)
        if not self._fn.reads_output:
            if self._extra:
                y, env = self._fn.eval_all(x=x, **abc)
                outs = {"out": _like(y, x)}
                for v in self._extra:
                    outs[v] = _like(env[v], x)
                return state, outs
            y = self._fn(x=x, **abc)
            return state, {"out": y if isinstance(y, torch.Tensor)
                           else torch.full_like(x, y)}
        # the recursive idiom: one program run per sample, y carried
        ys = []
        y = state
        for n in range(x.shape[-1]):
            y = _like(self._fn(x=x[..., n], y=y, **abc), state)
            ys.append(y)
        return y, {"out": torch.stack(ys, dim=-1) if ys
                   else x.new_zeros(x.shape, dtype=state.dtype)}


@register_block("ExpressionDISO")
class ExpressionDISO(_ExpressionBase):
    """z = f(x, y) over two input streams (≈ ExpressionDISO; the reference
    binds in0→x, in1→y and returns z, ExpressionBlocks.hpp)."""

    IN = (Port("x"), Port("y"))
    OUT = (Port("out"),)
    expression = Setting(default="x + y", kind="static")

    _ARGS = ("x", "y")
    _OUT_VAR = "z"

    def apply(self, state, ins, ctx):
        x = ins["x"]
        z = self._fn(x=x, y=ins["y"], **self._abc(ctx))
        return state, {"out": z if isinstance(z, torch.Tensor)
                       else torch.full_like(x, z)}


@register_block("ExpressionBulk")
class ExpressionBulk(_ExpressionBase):
    """Whole-span expression over vectors vecIn → vecOut (≈ ExpressionBulk,
    ExpressionBlocks.hpp; reference example ``vecOut := a * vecIn``).

    Vector indexing and ``for (var i := 0; i < N; i += 1) { … }`` loops with
    static bounds are unrolled; out-of-range accesses raise (≈ the
    reference's vector_access_runtime_check, ExpressionBlocks.hpp:48)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    expression = Setting(default="vecOut := vecIn", kind="static")

    _ARGS = ("vecIn", "vecOut", "x")
    _OUT_VAR = "vecOut"

    def apply(self, state, ins, ctx):
        x = ins["in"]
        out = self._fn(vecIn=x, vecOut=torch.zeros_like(x), x=x,
                       **self._abc(ctx))
        return state, {"out": _like(out, x)}
