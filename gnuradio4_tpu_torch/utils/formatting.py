"""Systematic value/type formatting (≈ the reference's std::formatter
specializations for ports, graphs, tags, values — core formatter/*.hpp,
meta/formatter.hpp): one vocabulary for rendering framework objects in logs,
CLI output, and diagnostics.

Everything returns plain strings; SI-prefixed engineering notation is the
default for rates/frequencies/sizes so a 48000.0 prints as "48 kHz" and a
6873.67e6 samples/s as "6.87 Gsps".
"""

from __future__ import annotations

from typing import Any

_SI_PREFIXES = [(1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k"),
                (1.0, ""), (1e-3, "m"), (1e-6, "µ"), (1e-9, "n"),
                (1e-12, "p")]


def si(value: float, unit: str = "", *, digits: int = 3) -> str:
    """Engineering/SI-prefixed notation: si(48000, 'Hz') → '48 kHz'."""
    v = float(value)
    if v == 0.0 or not (abs(v) < float("inf")):
        return f"{v:g} {unit}".rstrip()
    sign = "-" if v < 0 else ""
    a = abs(v)
    for scale, prefix in _SI_PREFIXES:
        if a >= scale:
            scaled = a / scale
            s = f"{scaled:.{digits}g}"
            return f"{sign}{s} {prefix}{unit}".rstrip()
    return f"{v:.{digits}g} {unit}".rstrip()


def samples(n: int) -> str:
    """Sample counts: 65536 → '64 ki' (binary prefixes, the block-length
    vocabulary)."""
    n = int(n)
    for scale, prefix in ((1 << 30, "Gi"), (1 << 20, "Mi"), (1 << 10, "ki")):
        if n >= scale and n % (scale >> 4 or 1) == 0:
            v = n / scale
            return f"{v:g} {prefix}" if v != int(v) else f"{int(v)} {prefix}"
    return str(n)


def duration(seconds: float) -> str:
    """Human duration: 0.0000031 → '3.1 µs'."""
    return si(seconds, "s")


def value(v: Any) -> str:
    """Generic value: floats in shortest round-trip form, arrays and tensors
    abbreviated (a tensor prints as its host array would), dicts rendered as
    compact key=value lists."""
    import numpy as np
    import torch
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    if isinstance(v, float):
        return f"{v:g}"
    if isinstance(v, np.ndarray):
        if v.size <= 6:
            return np.array2string(v, separator=", ")
        return (f"array({v.dtype.name}[{'×'.join(map(str, v.shape))}], "
                f"[{v.flat[0]:g} … {v.flat[-1]:g}])")
    if isinstance(v, dict):
        inner = ", ".join(f"{k}={value(x)}" for k, x in v.items())
        return "{" + inner + "}"
    if isinstance(v, (list, tuple)) and len(v) > 6:
        return f"[{value(v[0])} … {value(v[-1])}] ({len(v)})"
    return repr(v) if isinstance(v, str) else str(v)


def tag(t: Any) -> str:
    """Tag: '@1024 {sample_rate=48 kHz, trigger_name='T0'}'."""
    from ..core.tags import Keys
    parts = []
    for k, v in t.map.items():
        if k in (Keys.SAMPLE_RATE, Keys.FREQUENCY):
            parts.append(f"{k}={si(float(v), 'Hz')}")
        else:
            parts.append(f"{k}={value(v)}")
    return f"@{t.index} {{{', '.join(parts)}}}"


def edge(e: Any) -> str:
    """Edge: 'src.out ─▶ dst.in [64 ki samp/step @ 48 kHz]'."""
    core = f"{e.src.name}.{e.src_port} ─▶ {e.dst.name}.{e.dst_port}"
    meta = []
    if e.samples_per_step:
        meta.append(f"{samples(e.samples_per_step)} samp/step")
    if e.sample_rate:
        meta.append(f"@ {si(e.sample_rate, 'Hz')}")
    if getattr(e, "feedback", False):
        meta.append(f"feedback Δ{e.delay}")
    return core + (f" [{' '.join(meta)}]" if meta else "")


def block(b: Any) -> str:
    """Block: 'fir <BasicFilter> in→out (ratio 1/4)'."""
    from fractions import Fraction
    io = (",".join(p.name for p in b.in_ports) or "∅") + "→" + \
         (",".join(p.name for p in b.out_ports) or "∅")
    r = b.ratio
    ratio = "" if r == Fraction(1) else f" (ratio {r})"
    return f"{b.name} <{type(b).__name__}> {io}{ratio}"


def graph_summary(g: Any) -> str:
    """One-line graph summary: '5 blocks, 4 edges (1 feedback), 2 sources'."""
    fb = sum(1 for e in g.edges if getattr(e, "feedback", False))
    srcs = len(g.source_blocks())
    parts = [f"{len(g.blocks)} blocks",
             f"{len(g.edges)} edges" + (f" ({fb} feedback)" if fb else ""),
             f"{srcs} source{'s' if srcs != 1 else ''}"]
    return f"{g.name}: " + ", ".join(parts)
