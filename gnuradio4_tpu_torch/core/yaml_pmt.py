"""Reference-compatible typed YAML for property maps (≈ core YamlPmt.hpp,
exercised by qa_YamlPmt.cpp), on this package's own reader (``yaml_lite``).

The reference serializes ``property_map``/pmt values with YAML type tags —
``!!int8 … !!uint64``, ``!!float32/64``, ``!!complex32/64 (re, im)``,
``!!bool``, ``!!str``, ``!!null`` — on scalars AND on sequences (tagging the
element type). :func:`load` gives what the JAX package's ``yaml_pmt.load``
gives (there PyYAML's SafeLoader with the same tag constructors):

- typed scalars/vectors land as numpy scalars/arrays of the tagged dtype
  (complex ``(re, im)`` tuples included);
- untagged scalars follow YAML 1.1's inference (int for integers incl.
  0x/0o/0b spellings, float with .inf/.nan forms, true/false/null families;
  ``yes``/``no``/``on``/``off`` are bools that the strict bool rule refuses);
- tagged values are validated with positioned errors (range-checked integers,
  strict bool spellings, well-formed complex pairs) — GrError like the
  reference's parse errors (qa_YamlPmt.cpp:469-580).
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

from .errors import GrError
from .yaml_lite import (Node, read, resolve_plain, scalar_text, yaml_float,
                        yaml_int)

_INT_TAGS = {f"{s}{w}": np.dtype(f"{s}{w}")
             for s in ("int", "uint") for w in (8, 16, 32, 64)}
_FLOAT_TAGS = {"float32": np.dtype("float32"), "float64": np.dtype("float64")}
_COMPLEX_TAGS = {"complex32": np.dtype("complex64"),     # reference naming:
                 "complex64": np.dtype("complex128")}    # bits per COMPONENT
_COMPLEX_RE = re.compile(r"^\(\s*([^,()\s][^,()]*?)\s*,\s*([^,()\s][^,()]*?)"
                         r"\s*\)$")
_ALL_TAGS = (set(_INT_TAGS) | set(_FLOAT_TAGS) | set(_COMPLEX_TAGS)
             | {"bool", "str", "null"})
_NUMERIC_TAGS = _ALL_TAGS - {"str", "bool", "null"}
_CANONICAL_BOOLS = ("true", "false", "True", "False", "TRUE", "FALSE")


def _parse_int(s: str, dtype: np.dtype, node: Node) -> Any:
    t = s.strip().replace("_", "")
    try:
        v = int(t, 0)      # accepts 0x / 0o / 0b / decimal with sign
    except ValueError:
        raise GrError(f"Error in {node.mark}: Invalid integral-type "
                      f"value {t!r}")
    info = np.iinfo(dtype)
    if not info.min <= v <= info.max:
        raise GrError(f"Error in {node.mark}: Invalid integral-type value "
                      f"{t!r} (out of range for {dtype})")
    return dtype.type(v)


_FLOAT_SPECIALS = {".inf": np.inf, ".Inf": np.inf, ".INF": np.inf,
                   "-.inf": -np.inf, "-.Inf": -np.inf, "-.INF": -np.inf,
                   ".nan": np.nan, ".NaN": np.nan, ".NAN": np.nan}


def _parse_float(s: str, dtype: np.dtype, node: Node) -> Any:
    t = s.strip()
    if t in _FLOAT_SPECIALS:
        return dtype.type(_FLOAT_SPECIALS[t])
    try:
        return dtype.type(float(t))
    except ValueError:
        raise GrError(f"Error in {node.mark}: expected floating-point "
                      f"value of {t!r}")


def _parse_complex(s: str, dtype: np.dtype, node: Node) -> Any:
    m = _COMPLEX_RE.match(s.strip())
    if not m:
        raise GrError(f"Error in {node.mark}: Invalid value for "
                      f"complex<>-type")
    try:
        re_, im_ = float(m.group(1)), float(m.group(2))
    except ValueError as e:
        raise GrError(f"Error in {node.mark}: expected floating-point "
                      f"value — {e}")
    return dtype.type(complex(re_, im_))


def _parse_bool(s: str, node: Node) -> bool:
    if s == "true":
        return True
    if s == "false":
        return False
    raise GrError(f"Error in {node.mark}: Invalid value for bool-type")


def _tag_of(node: Node) -> str:
    """The node's explicit tag, else the one YAML 1.1 resolves it to."""
    if node.tag is not None:
        return node.tag
    if node.kind != "scalar":
        return node.kind
    if node.style:
        return "str"
    tag = resolve_plain(node.value)
    if tag in ("timestamp", "merge", "value"):
        raise GrError(f"YAML parse error at {node.mark}: untagged {tag} "
                      f"scalar {node.value!r} is not supported")
    return tag


def _typed(node: Node, tag: str) -> Any:
    """A node under one of the reference's type tags."""
    if node.kind == "seq":
        # a numeric element tag on an item of an already-typed list is the
        # reference's "Cannot have type tag for both list and list item"
        # error (qa_YamlPmt.cpp:698)
        for child in node.value:
            own = _tag_of(child)
            if child.kind == "scalar" and own != tag and own in _NUMERIC_TAGS:
                raise GrError(f"Error in {child.mark}: Cannot have "
                              f"type tag for both list and list item")
        items = [_scalar_value(c, tag) for c in node.value]
        dt = (_INT_TAGS.get(tag) or _FLOAT_TAGS.get(tag)
              or _COMPLEX_TAGS.get(tag))
        if dt is not None:
            return np.asarray(items, dtype=dt)
        if tag == "bool":
            return np.asarray(items, dtype=bool)
        if tag == "null":
            return None      # a null-tagged vector collapses to null
        return items          # !!str sequences → plain string lists
    return _scalar_value(node, tag)


def _scalar_value(node: Node, tag: str) -> Any:
    if node.kind == "seq":
        return [_scalar_value(c, tag) for c in node.value]
    if node.kind == "map":
        return _mapping(node)
    s = node.value
    # inside a typed sequence the sequence's element tag always wins
    if tag in _INT_TAGS:
        return _parse_int(s, _INT_TAGS[tag], node)
    if tag in _FLOAT_TAGS:
        return _parse_float(s, _FLOAT_TAGS[tag], node)
    if tag in _COMPLEX_TAGS:
        return _parse_complex(s, _COMPLEX_TAGS[tag], node)
    if tag == "bool":
        # bools in the canonical spellings pass; an explicit !!bool and
        # YAML 1.1's yes/no/on/off are strict (cpp:468-473)
        if _tag_of(node) == "bool" and s in _CANONICAL_BOOLS:
            return s.lower() == "true"
        return _parse_bool(s, node)
    if tag == "null":
        return None              # "!!null anything" → null (cpp:419)
    return s                     # !!str


def _mapping(node: Node) -> dict:
    out: dict = {}
    for k, v in node.value:
        key, value = _construct(k), _construct(v)
        try:
            out[key] = value
        except TypeError:
            raise GrError(f"YAML parse error at {k.mark}: a mapping key must "
                          f"be a scalar")
    return out


def _construct(node: Node) -> Any:
    tag = _tag_of(node)
    if tag in _ALL_TAGS:
        return _typed(node, tag)
    if tag in ("int", "float") and node.kind == "scalar":
        try:
            return (yaml_int if tag == "int" else yaml_float)(node.value)
        except (ValueError, IndexError):
            raise GrError(f"YAML parse error at {node.mark}: invalid {tag} "
                          f"{node.value!r}")
    if tag == "seq" and node.kind == "seq":
        return [_construct(c) for c in node.value]
    if tag == "map" and node.kind == "map":
        return _mapping(node)
    raise GrError(f"YAML parse error at {node.mark}: unsupported tag "
                  f"!!{tag} on a {node.kind}")


def _post(v: Any) -> Any:
    """Normalize container keys to strings."""
    if isinstance(v, dict):
        return {str(k): _post(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_post(x) for x in v]
    return v


def load(text: str) -> dict[str, Any]:
    """Parse reference-dialect YAML into a property map."""
    root = read(text)
    data = None if root is None else _construct(root)
    return _post(data) if isinstance(data, dict) else (_post(data) or {})


# -- serialization ----------------------------------------------------------------

_NP_TAG = {np.dtype(f"{s}{w}"): f"!!{s}{w}"
           for s in ("int", "uint") for w in (8, 16, 32, 64)}
_NP_TAG[np.dtype("float32")] = "!!float32"
_NP_TAG[np.dtype("complex64")] = "!!complex32"
_NP_TAG[np.dtype("complex128")] = "!!complex64"


def _fmt_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (complex, np.complexfloating)):
        return f"({np.real(v)}, {np.imag(v)})"
    if isinstance(v, (float, np.floating)):
        f = float(v)
        if np.isnan(f):
            return ".nan"
        if np.isinf(f):
            return ".inf" if f > 0 else "-.inf"
        return repr(f)
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    s = str(v)
    if s == "" or s != s.strip() or any(c in s for c in ":#{}[]\n'\"") \
            or s.lower() in ("null", "true", "false", "~") \
            or re.match(r"^[-+.\d]", s):
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n") + '"'
    return s


def _np_tag(v: Any) -> str:
    if isinstance(v, np.ndarray):
        return _NP_TAG.get(v.dtype, "")
    if isinstance(v, np.generic) and not isinstance(v, np.bool_):
        return _NP_TAG.get(np.dtype(type(v)), "")
    if isinstance(v, complex):
        return "!!complex64"
    return ""


def _emit(v: Any, indent: int, out: list[str], key: str | None = None) -> None:
    pad = "  " * indent
    # a key that YAML 1.1 would read as another type (no, on, null, 1) is
    # quoted; the reference writes it plain and then cannot load it back
    head = f"{pad}{scalar_text(key)[0]}:" if key is not None else f"{pad}-"
    tag = _np_tag(v)
    if isinstance(v, dict):
        if not v:
            out.append(f"{head} {{}}")
            return
        out.append(head)
        for k, x in v.items():
            _emit(x, indent + 1, out, key=str(k))
    elif isinstance(v, np.ndarray) and v.ndim == 1 or isinstance(v, (list,
                                                                     tuple)):
        items = list(v)
        if not items:
            out.append(f"{head} {tag + ' ' if tag else ''}[]")
            return
        out.append(f"{head}{' ' + tag if tag else ''}")
        for x in items:
            if isinstance(x, (dict, list, tuple)) or \
                    (isinstance(x, np.ndarray) and x.ndim == 1):
                _emit(x, indent + 1, out)
            else:
                item_tag = "" if tag else _np_tag(x)
                out.append(f"{pad}  - "
                           f"{item_tag + ' ' if item_tag else ''}"
                           f"{_fmt_scalar(x)}")
    else:
        out.append(f"{head} {tag + ' ' if tag else ''}{_fmt_scalar(v)}")


def dump(pmap: dict[str, Any]) -> str:
    """Serialize a property map in the reference's tagged-YAML dialect."""
    out: list[str] = []
    for k, v in pmap.items():
        _emit(v, 0, out, key=str(k))
    return "\n".join(out) + "\n"
