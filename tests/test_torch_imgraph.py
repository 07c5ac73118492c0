"""utils/imgraph.py in the port against the JAX package: the topologies of
tests/test_imgraph_golden.py (and three more: an auto-layout deep chain, a
skip-level edge and a message edge), built in both packages. The drawing
(with and without colour), the DOT text and the detected feedback loops
must be the same text; the DOT node identifiers carry each block's unique
name, whose number counts the blocks each package made before, so they are
compared in order of appearance."""

import re

import pytest

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.utils import imgraph as jim
from gnuradio4_tpu_torch.utils import imgraph as tim

IMGRAPH = {gr: jim, gt: tim}


def base1(pkg):
    g = pkg.Graph()
    s1 = g.emplace("ConstantSource", name="src#1")
    s2 = g.emplace("ConstantSource", name="src#2")
    add = g.emplace("Add", n_inputs=2, name="add")
    snk = g.emplace("NullSink", name="snk#1")
    g.connect(s1, add, dst_port="in0")
    g.connect(s2, add, dst_port="in1")
    g.connect(add, snk)
    return g, {}


def base2(pkg):
    g = pkg.Graph()
    src = g.emplace("ConstantSource", name="src#1")
    split = g.emplace("Copy", name="split")
    s1 = g.emplace("NullSink", name="snk#1")
    s2 = g.emplace("NullSink", name="snk#2")
    g.connect(src, split)
    g.connect(split, s1)
    g.connect(split, s2)
    return g, {}


def cyclic(pkg, vertical=False):
    g = pkg.Graph()
    src = g.emplace("ConstantSource", name="src#1")
    sm = g.emplace("Add", n_inputs=2, name="sum")
    if vertical:
        sm.ui_constraints = {"layout_pref": "vertical"}
    ds = g.emplace("Copy", name="D(s)")
    gs = g.emplace("Copy", name="G(s)")
    ms = g.emplace("Copy", name="M(s)")
    snk = g.emplace("NullSink", name="snk#1")
    g.connect(src, sm, dst_port="in0")
    g.connect(sm, ds)
    g.connect(ds, gs)
    g.connect(gs, snk)
    g.connect(gs, ms)
    g.connect(ms, sm, dst_port="in1", feedback=True)
    return g, {}


def cyclic_vertical(pkg):
    return cyclic(pkg, vertical=True)


def cyclic_forced_horizontal(pkg):
    g, _ = cyclic(pkg, vertical=True)
    return g, {"direction": "horizontal"}


def cyclic_coloured(pkg):
    g, _ = cyclic(pkg)
    colour(pkg, next(b for b in g.blocks if b.name == "sum"), "bright_green")
    for loop in IMGRAPH[pkg].detect_feedback_loops(g):
        colour(pkg, loop[-1], "cyan")
    return g, {}


def colour(pkg, obj, c):
    IMGRAPH[pkg].colour(obj, c)


def base1_styled(pkg):
    g, _ = base1(pkg)
    IMGRAPH[pkg].style(next(b for b in g.blocks if b.name == "add"),
                       "\x1b[1;93m")
    return g, {}


def named_edge(pkg):
    g = pkg.Graph()
    src = g.emplace("ConstantSource", name="src#2")
    snk = g.emplace("NullSink", name="snk#2")
    g.connect(src, snk, name="special edge")
    return g, {}


def deep_chain_auto(pkg):
    g = pkg.Graph()
    blocks = [g.emplace("ConstantSource", name="src")]
    blocks[0].ui_constraints = {"layout_pref": "auto"}
    blocks += [g.emplace("Copy", name=f"stage{i}") for i in range(6)]
    blocks.append(g.emplace("NullSink", name="snk"))
    g.connect_chain(*blocks)
    return g, {}


def skip_level(pkg):
    g = pkg.Graph()
    src = g.emplace("ConstantSource", name="src")
    a = g.emplace("Copy", name="a")
    b = g.emplace("Copy", name="b")
    add = g.emplace("Add", n_inputs=2, name="add")
    snk = g.emplace("NullSink", name="snk")
    g.connect_chain(src, a, b)
    g.connect(b, add, dst_port="in0")
    g.connect(src, add, dst_port="in1")
    g.connect(add, snk)
    return g, {}


def message_edge(pkg):
    g, _ = base2(pkg)
    by = {b.name: b for b in g.blocks}
    g.connect_message(by["snk#1"], by["split"])
    return g, {}


TOPOLOGIES = [base1, base2, cyclic, cyclic_vertical, cyclic_forced_horizontal,
              cyclic_coloured, base1_styled, named_edge, deep_chain_auto,
              skip_level, message_edge]


def _canon_dot(dot: str) -> str:
    """``dot`` with each node identifier (``Type_<count>``) renamed in order
    of appearance."""
    ids: dict[str, str] = {}
    return re.sub(r"\b[A-Za-z]\w*?_\d+\b",
                  lambda m: ids.setdefault(m.group(0), f"n{len(ids)}"), dot)


@pytest.mark.parametrize("build", TOPOLOGIES, ids=lambda f: f.__name__)
def test_same_drawing_as_the_jax_package(build):
    out = {}
    for pkg in (gr, gt):
        g, kw = build(pkg)
        im = IMGRAPH[pkg]
        out[pkg] = (im.render_graph(g, **kw),
                    im.render_graph(g, color=False, **kw),
                    _canon_dot(im.to_dot(g)),
                    [[(e.src.name, e.dst.name, bool(getattr(e, "feedback",
                                                            False)))
                      for e in loop] for loop in im.detect_feedback_loops(g)])
    for got, want in zip(out[gt], out[gr]):
        assert got == want
    assert "edges:" in out[gt][1]
