"""A small YAML reader and writer for the dialect this package reads and writes.

The JAX package parses YAML with PyYAML; this package does not depend on it.
This module reads the subset that flowgraph files, ``save_grc`` and
``yaml_pmt.dump`` use, into a tree of :class:`Node` with positions:

- block mappings and block sequences (also a sequence at its parent key's
  indentation, as PyYAML writes them), compact ``- key: value`` entries;
- flow mappings and flow sequences, which may span lines;
- plain, single-quoted and double-quoted scalars (escapes, line folding);
- comments, a leading ``---`` and a trailing ``...``;
- ``!!name`` tags on any node.

Anything else (anchors and aliases, block scalars ``|``/``>``, complex keys,
directives, local tags, several documents, plain scalars continued onto the
next line) raises a :class:`GrError` naming the line and column; the reader
never guesses. :func:`resolve_plain` is YAML 1.1's implicit typing as PyYAML's
``SafeLoader`` applies it to plain scalars, and :func:`dump_document` writes a
document in the style of PyYAML's ``safe_dump(default_flow_style=None)``.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import re
from typing import Any

from .errors import GrError

# YAML 1.1 implicit resolvers, as PyYAML's Resolver registers them, plus the
# 0o-octal integer form
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT_RE = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_OCT_O_RE = re.compile(r"^[-+]?0o[0-7]+$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")

_WS = " \t"
_FLOW_IND = ",[]{}"
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def resolve_plain(s: str) -> str:
    """The tag PyYAML's SafeLoader gives an untagged plain scalar: 'null',
    'bool', 'int', 'float', 'timestamp', 'merge', 'value' or 'str'."""
    first = s[:1]
    if first in "yYnNtTfFoO" and _BOOL_RE.match(s):
        return "bool"
    if first in "-+0123456789." and _FLOAT_RE.match(s):
        return "float"
    if first in "-+0123456789" and _INT_RE.match(s):
        return "int"
    if s == "<<":
        return "merge"
    if first in "~nN" or s == "":
        if _NULL_RE.match(s):
            return "null"
    if first in "0123456789" and _TIMESTAMP_RE.match(s):
        return "timestamp"
    if s == "=":
        return "value"
    if first in "-+0" and _OCT_O_RE.match(s):
        return "int"
    return "str"


def yaml_int(s: str) -> int:
    """PyYAML's ``construct_yaml_int`` of a scalar that resolved to int."""
    v = s.replace("_", "")
    sign = -1 if v[:1] == "-" else 1
    if v[:1] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        out, base = 0, 1
        for d in reversed([int(p) for p in v.split(":")]):
            out += d * base
            base *= 60
        return sign * out
    return sign * int(v)


def yaml_float(s: str) -> float:
    """PyYAML's ``construct_yaml_float`` of a scalar that resolved to float."""
    v = s.replace("_", "").lower()
    sign = -1 if v[:1] == "-" else 1
    if v[:1] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        out, base = 0.0, 1
        for d in reversed([float(p) for p in v.split(":")]):
            out += d * base
            base *= 60
        return sign * out
    return sign * float(v)


@dataclasses.dataclass
class Node:
    """One node of a document: ``kind`` is 'scalar' (``value`` a str, ``style``
    '' for plain or the quote character), 'seq' (``value`` a list of nodes) or
    'map' (``value`` a list of (key, value) node pairs). ``tag`` is the name
    after ``!!`` of an explicit tag, else None. ``line``/``col`` are 0-based
    and point at the tag where there is one (as PyYAML's start marks do)."""

    kind: str
    line: int
    col: int
    value: Any
    style: str = ""
    tag: str | None = None

    @property
    def mark(self) -> str:
        return f"{self.line + 1}:{self.col + 1}"


class _Reader:
    def __init__(self, text: str):
        s = text.replace("\r\n", "\n").replace("\r", "\n")
        self.s = s[1:] if s.startswith("\ufeff") else s
        self.n = len(self.s)
        self.i = 0
        self.starts = [0] + [m.end() for m in re.finditer("\n", self.s)]

    # -- positions and errors ------------------------------------------------
    def where(self, i: int | None = None) -> tuple[int, int]:
        i = self.i if i is None else i
        line = bisect.bisect_right(self.starts, i) - 1
        return line, i - self.starts[line]

    def col(self) -> int:
        return self.where()[1]

    def fail(self, msg: str, i: int | None = None):
        line, col = self.where(i)
        raise GrError(f"YAML parse error at {line + 1}:{col + 1}: {msg}")

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < self.n else ""

    def _blank(self, ch: str) -> bool:
        return ch in ("", "\n", " ", "\t")

    # -- whitespace ----------------------------------------------------------
    def skip_ws(self) -> None:
        while self.i < self.n and self.s[self.i] in _WS:
            self.i += 1

    def at_eol(self) -> bool:
        return self.peek() in ("", "\n", "#")

    def expect_eol(self) -> None:
        self.skip_ws()
        if self.peek() == "#":
            while self.peek() not in ("", "\n"):
                self.i += 1
        if self.peek() not in ("", "\n"):
            self.fail(f"unexpected {self.peek()!r} after a value")

    def skip_blank_lines(self) -> None:
        """Move to the first content character of the next line that has
        content (or to the end); the indentation may not hold tabs."""
        while self.i < self.n:
            j = self.i
            while j < self.n and self.s[j] == " ":
                j += 1
            tab = j
            while j < self.n and self.s[j] in _WS:
                j += 1
            if j >= self.n:
                self.i = self.n
                return
            if self.s[j] == "#":
                while j < self.n and self.s[j] != "\n":
                    j += 1
            if j >= self.n:
                self.i = self.n
                return
            if self.s[j] == "\n":
                self.i = j + 1
                continue
            line_start = self.starts[self.where(j)[0]]
            if "\t" in self.s[line_start:j]:
                self.fail("tabs are not allowed in indentation", tab)
            self.i = j
            return

    def skip_flow_ws(self) -> None:
        while self.i < self.n:
            ch = self.s[self.i]
            if ch in " \t\n":
                self.i += 1
            elif ch == "#":
                while self.i < self.n and self.s[self.i] != "\n":
                    self.i += 1
            else:
                return

    def at_doc_marker(self) -> bool:
        return (self.col() == 0 and self.s.startswith(("---", "..."), self.i)
                and self._blank(self.peek(3)))

    def seq_entry_here(self) -> bool:
        return self.peek() == "-" and self._blank(self.peek(1))

    # -- document ------------------------------------------------------------
    def document(self) -> Node | None:
        self.skip_blank_lines()
        if self.peek() == "%":
            self.fail("directives are not supported")
        node = None
        if self.at_doc_marker() and self.s.startswith("---", self.i):
            self.i += 3
            self.skip_ws()
            if not self.at_eol():
                node = self.value(-1, in_map=False)
                self.expect_eol()
            self.skip_blank_lines()
        if node is None and self.i < self.n and not self.at_doc_marker():
            node = self.block_node()
        self.skip_blank_lines()
        if self.i < self.n:
            if self.at_doc_marker() and self.s.startswith("...", self.i):
                self.i += 3
                self.expect_eol()
                self.skip_blank_lines()
                if self.i < self.n:
                    self.fail("only one document is supported")
            elif self.at_doc_marker():
                self.fail("only one document is supported")
            else:
                self.fail(f"unexpected {self.peek()!r}")
        return node

    # -- block context -------------------------------------------------------
    def block_node(self) -> Node:
        """The node whose first character is the current one, at the start
        of its line's content."""
        col = self.col()
        if self.seq_entry_here():
            return self.block_seq(col)
        tag, at = self.props(flow=False)
        if tag is not None:
            self.skip_ws()
            if self.at_eol():
                return self._tagged_below(tag, at, col - 1, in_map=False)
        node = self.inline(col - 1, in_map_value=False, col=self.col(),
                           tagged=tag is not None)
        return self._with_tag(node, tag, at)

    def value(self, indent: int, in_map: bool) -> Node:
        """The node after ``key:`` or ``-`` (``indent``: the collection's
        column); on this line, on the lines below, or empty."""
        self.skip_ws()
        start = self.i
        tag, at = self.props(flow=False)
        self.skip_ws()
        if self.at_eol():
            return self._tagged_below(tag, at if tag else start, indent, in_map)
        node = self.inline(indent, in_map_value=in_map, col=self.col(),
                           tagged=tag is not None)
        return self._with_tag(node, tag, at)

    def _tagged_below(self, tag, at, indent: int, in_map: bool) -> Node:
        save = self.i
        self.skip_blank_lines()
        if self.i < self.n and not self.at_doc_marker():
            col = self.col()
            if col > indent or (in_map and col == indent
                                and self.seq_entry_here()):
                node = (self.block_seq(col) if self.seq_entry_here()
                        else self.block_node())
                return self._with_tag(node, tag, at)
        self.i = save
        line, col = self.where(at)
        return Node("scalar", line, col, "", tag=tag)

    def _with_tag(self, node: Node, tag, at) -> Node:
        if tag is not None:
            node.tag = tag
            node.line, node.col = self.where(at)
        return node

    def inline(self, indent: int, in_map_value: bool, col: int,
               tagged: bool) -> Node:
        c = self.peek()
        if c in "[{":
            node = self.flow_collection()
            self.skip_ws()
            if self.peek() == ":":
                self.fail("flow collections as mapping keys are not supported")
            self.expect_eol()
            return node
        if self.seq_entry_here():
            if in_map_value:
                self.fail("block sequence entries are not allowed here")
            if tagged:
                self.fail("a tag before a compact sequence is not supported")
            return self.block_seq(col)
        self.check_node_start(c)
        node = self.scalar(flow=False)
        self.skip_ws()
        if self.peek() == ":" and self._blank(self.peek(1)):
            if in_map_value:
                self.fail("mapping values are not allowed here")
            if tagged:
                self.fail("a tag before a compact mapping key is not supported")
            return self.block_map(col, node)
        self.expect_eol()
        return node

    def check_node_start(self, c: str) -> None:
        if c in "|>":
            self.fail("block scalars (| and >) are not supported")
        if c in "&*":
            self.fail("anchors and aliases are not supported")
        if c == "?" and self._blank(self.peek(1)):
            self.fail("complex mapping keys are not supported")

    def block_map(self, col: int, key: Node) -> Node:
        pairs = []
        while True:
            self.i += 1                      # the ':'
            pairs.append((key, self.value(col, in_map=True)))
            self.skip_blank_lines()
            if self.i >= self.n or self.at_doc_marker():
                break
            c = self.col()
            if c < col:
                break
            if c > col:
                self.fail("unexpected indentation")
            if self.seq_entry_here():
                self.fail("expected a mapping key, found a sequence entry")
            ch = self.peek()
            if ch in "[{!":
                self.fail("flow collections and tags as mapping keys are "
                          "not supported")
            self.check_node_start(ch)
            key = self.scalar(flow=False)
            self.skip_ws()
            if not (self.peek() == ":" and self._blank(self.peek(1))):
                self.fail("expected ':' after a mapping key")
        first = pairs[0][0]
        return Node("map", first.line, first.col, pairs)

    def block_seq(self, col: int) -> Node:
        line, _ = self.where()
        items = []
        while True:
            self.i += 1                      # the '-'
            items.append(self.value(col, in_map=False))
            self.skip_blank_lines()
            if self.i >= self.n or self.at_doc_marker():
                break
            c = self.col()
            if c < col:
                break
            if c > col:
                self.fail("unexpected indentation")
            if not self.seq_entry_here():
                break
        return Node("seq", line, col, items)

    # -- properties ----------------------------------------------------------
    def props(self, flow: bool) -> tuple[str | None, int]:
        at = self.i
        c = self.peek()
        if c and c in "&*":
            self.fail("anchors and aliases are not supported")
        if c != "!":
            return None, at
        stop = " \t\n" + (_FLOW_IND if flow else "")
        j = self.i
        while j < self.n and self.s[j] not in stop:
            j += 1
        text = self.s[self.i:j]
        if not (text.startswith("!!")
                and re.fullmatch(r"[0-9A-Za-z_.-]+", text[2:] or "")):
            self.fail(f"unsupported tag {text!r} (only !!name tags)")
        self.i = j
        if self.peek() == "&":
            self.fail("anchors and aliases are not supported")
        return text[2:], at

    # -- scalars -------------------------------------------------------------
    def scalar(self, flow: bool) -> Node:
        line, col = self.where()
        c = self.peek()
        if c == "'":
            return Node("scalar", line, col, self.single_quoted(), style="'")
        if c == '"':
            return Node("scalar", line, col, self.double_quoted(), style='"')
        return Node("scalar", line, col, self.plain(flow))

    def plain(self, flow: bool) -> str:
        c = self.peek()
        nxt = self.peek(1)
        if c in ",[]{}#&*!|>'\"%@`" or (
                c in "-?:" and (self._blank(nxt) or (flow and nxt in _FLOW_IND))):
            self.fail(f"a plain scalar cannot start with {c!r}")
        start = self.i
        end = self.i
        while self.i < self.n:
            ch = self.s[self.i]
            if ch == "\n":
                break
            if ch in _WS:
                j = self.i
                while j < self.n and self.s[j] in _WS:
                    j += 1
                if j >= self.n or self.s[j] in "#\n":
                    self.i = j
                    break
                self.i = j
                continue
            if ch == ":" and (self._blank(self.peek(1))
                              or (flow and self.peek(1) in _FLOW_IND)):
                break
            if flow and ch in ",?[]{}":
                break
            self.i += 1
            end = self.i
        return self.s[start:end]

    def _fold(self, parts: list[str]) -> None:
        """At a line break inside a quoted scalar: drop the line's trailing
        blanks and the next lines' indentation; one break folds to a space,
        each further one stays a newline."""
        if parts:
            parts[-1] = parts[-1].rstrip(" \t")
        breaks = 0
        while self.peek() == "\n":
            breaks += 1
            self.i += 1
            self.skip_ws()
        if self.i >= self.n:
            self.fail("unterminated quoted scalar")
        parts.append(" " if breaks == 1 else "\n" * (breaks - 1))

    def single_quoted(self) -> str:
        start = self.i
        self.i += 1
        parts: list[str] = []
        while True:
            if self.i >= self.n:
                self.fail("unterminated quoted scalar", start)
            ch = self.s[self.i]
            if ch == "'":
                if self.peek(1) == "'":
                    parts.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(parts)
            if ch == "\n":
                self._fold(parts)
                continue
            parts.append(ch)
            self.i += 1

    def double_quoted(self) -> str:
        start = self.i
        self.i += 1
        parts: list[str] = []
        while True:
            if self.i >= self.n:
                self.fail("unterminated quoted scalar", start)
            ch = self.s[self.i]
            if ch == '"':
                self.i += 1
                return "".join(parts)
            if ch == "\\":
                e = self.peek(1)
                if e in _ESCAPES:
                    parts.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_ESCAPES:
                    k = _HEX_ESCAPES[e]
                    digits = self.s[self.i + 2:self.i + 2 + k]
                    if len(digits) != k or not re.fullmatch(r"[0-9A-Fa-f]+", digits):
                        self.fail(f"invalid escape \\{e}{digits}")
                    parts.append(chr(int(digits, 16)))
                    self.i += 2 + k
                elif e == "\n":              # escaped line break: no space
                    self.i += 1
                    while self.peek() == "\n":
                        self.i += 1
                        self.skip_ws()
                else:
                    self.fail(f"unknown escape \\{e}")
                continue
            if ch == "\n":
                self._fold(parts)
                continue
            parts.append(ch)
            self.i += 1

    # -- flow context --------------------------------------------------------
    def flow_node(self) -> Node:
        self.skip_flow_ws()
        tag, at = self.props(flow=True)
        if tag is not None:
            self.skip_flow_ws()
            if self.peek() in ",]}":
                line, col = self.where(at)
                return Node("scalar", line, col, "", tag=tag)
        c = self.peek()
        if c and c in "[{":
            node = self.flow_collection()
        elif c == "":
            self.fail("unterminated flow collection")
        else:
            self.check_node_start(c)
            node = self.scalar(flow=True)
        return self._with_tag(node, tag, at)

    def flow_collection(self) -> Node:
        line, col = self.where()
        opening = self.peek()
        closing = "]" if opening == "[" else "}"
        self.i += 1
        items: list = []
        while True:
            self.skip_flow_ws()
            if self.peek() == closing:
                self.i += 1
                break
            if self.peek() == "?":
                self.fail("complex mapping keys are not supported")
            key = self.flow_node()
            self.skip_flow_ws()
            if opening == "[":
                if self.peek() == ":":
                    self.fail("single-pair mappings inside flow sequences "
                              "are not supported")
                items.append(key)
            else:
                if self.peek() == ":":
                    self.i += 1
                    self.skip_flow_ws()
                    if self.peek() in (",", "}"):
                        vl, vc = self.where()
                        val = Node("scalar", vl, vc, "")
                    else:
                        val = self.flow_node()
                else:
                    val = Node("scalar", key.line, key.col, "")
                items.append((key, val))
            self.skip_flow_ws()
            if self.peek() == ",":
                self.i += 1
                continue
            if self.peek() == closing:
                self.i += 1
                break
            if self.peek() == "":
                self.fail("unterminated flow collection")
            self.fail(f"expected ',' or '{closing}', found {self.peek()!r}")
        return Node("seq" if opening == "[" else "map", line, col, items)


def read(text: str) -> Node | None:
    """Parse one YAML document into a :class:`Node` tree (None when the text
    holds no node). Raises a positioned :class:`GrError` on what the reader
    does not cover."""
    return _Reader(text).document()


# -- writing ------------------------------------------------------------------

def _float_text(f: float) -> str:
    """PyYAML's ``represent_float``: the repr, with '.0' before a bare
    exponent so that YAML 1.1 reads it back as a float."""
    if f != f:
        return ".nan"
    if f == math.inf:
        return ".inf"
    if f == -math.inf:
        return "-.inf"
    r = repr(f).lower()
    if "." not in r and "e" in r:
        r = r.replace("e", ".0e", 1)
    return r


def _plain_ok(s: str) -> bool:
    """True when ``s`` reads back as this same string from a plain scalar in
    both block and flow context."""
    return (bool(s) and s == s.strip() and s[0] not in "-?:,[]{}#&*!|>'\"%@`"
            and not any(c in s for c in ",[]{}")
            and ": " not in s and " #" not in s and not s.endswith(":")
            and all(" " <= c <= "~" for c in s)
            and resolve_plain(s) == "str")


def _quoted(s: str) -> str:
    out = []
    for c in s:
        if c in '\\"':
            out.append("\\" + c)
        elif c == "\n":
            out.append("\\n")
        elif c == "\t":
            out.append("\\t")
        elif c < " " or c == "\x7f":
            out.append(f"\\x{ord(c):02x}")
        else:
            out.append(c)
    return '"' + "".join(out) + '"'


def scalar_text(v: Any) -> tuple[str, bool]:
    """(text, plain) of a scalar value: None, bool, int, float or str."""
    if v is None:
        return "null", True
    if isinstance(v, bool):
        return ("true" if v else "false"), True
    if isinstance(v, int):
        return str(v), True
    if isinstance(v, float):
        return _float_text(v), True
    if isinstance(v, str):
        return (v, True) if _plain_ok(v) else (_quoted(v), False)
    raise GrError(f"cannot write a value of type {type(v).__name__} to YAML: "
                  f"{v!r}")


def _flowable(v: Any) -> bool:
    """PyYAML's ``default_flow_style=None``: a collection goes in flow style
    when every item (and key) is a plain scalar."""
    if isinstance(v, dict):
        items = list(v.keys()) + list(v.values())
    elif isinstance(v, list):
        items = v
    else:
        return False
    return all(not isinstance(x, (dict, list)) and scalar_text(x)[1]
               for x in items)


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{scalar_text(k)[0]}: {scalar_text(x)[0]}"
                               for k, x in v.items()) + "}"
    if isinstance(v, list):
        return "[" + ", ".join(scalar_text(x)[0] for x in v) + "]"
    return scalar_text(v)[0]


def _block(v: Any, indent: int) -> list[str]:
    pad = " " * indent
    lines: list[str] = []
    if isinstance(v, dict):
        for k, x in v.items():
            if not isinstance(k, str):
                raise GrError(f"YAML mapping keys must be strings: {k!r}")
            key = scalar_text(k)[0]
            if not isinstance(x, (dict, list)) or _flowable(x):
                lines.append(f"{pad}{key}: {_inline(x)}")
            else:
                lines.append(f"{pad}{key}:")
                # sequences at their key's indentation, as PyYAML writes them
                lines += _block(x, indent if isinstance(x, list) else indent + 2)
    else:
        for x in v:
            if not isinstance(x, (dict, list)) or _flowable(x):
                lines.append(f"{pad}- {_inline(x)}")
            else:
                sub = _block(x, indent + 2)
                lines.append(f"{pad}- {sub[0][indent + 2:]}")
                lines += sub[1:]
    return lines


def dump_document(doc: Any) -> str:
    """Write ``doc`` (dicts, lists, None, bool, int, float, str) as block
    YAML; collections of plain scalars go in flow style."""
    if not isinstance(doc, (dict, list)) or _flowable(doc):
        return _inline(doc) + "\n"
    return "\n".join(_block(doc, 0)) + "\n"
