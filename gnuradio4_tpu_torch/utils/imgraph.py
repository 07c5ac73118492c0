"""Terminal flow-graph renderer (≈ reference algorithm ImGraph.hpp — the
ASCII/ANSI flowgraph layout view).

Layout is layered (Sugiyama-style): blocks go into columns by longest-path
depth, skip-level edges get virtual pass-through nodes, rows are ordered by
predecessor barycenter to reduce crossings, and every edge is routed
orthogonally through a lane gutter between columns — fan-out, fan-in and
multi-column spans all render faithfully (┬/┴/├/┤/┼ junctions).

Reference-parity extras (qa_ImGraph.cpp:79-215):

- **feedback loops** route back through a bottom gutter (one lane per loop)
  instead of being appendix-only; :func:`detect_feedback_loops` returns each
  cycle's edge list (≈ gr::graph::detectFeedbackLoops);
- **ANSI styling**: blocks/edges accept styles via :func:`colour` /
  :func:`style` or a ``ui_constraints``/``ui_style`` attribute
  (≈ gr::graph::colour/style + utf8::Style);
- **layout_pref**: ``render_graph(direction='vertical')`` rotates the whole
  layout; a block's ``ui_constraints={'layout_pref': 'vertical'}`` requests
  it graph-wide ('auto' picks by aspect ratio) — the reference's per-block
  mixed layouts collapse to a whole-graph preference here.
"""

from __future__ import annotations

from typing import Any

from ..core.graph import Graph

# character-combination table for overlapping wires
_MERGE = {
    ("─", "│"): "┼", ("│", "─"): "┼",
    ("─", "─"): "─", ("│", "│"): "│",
    ("─", "╮"): "┬", ("─", "╭"): "┬", ("─", "╯"): "┴", ("─", "╰"): "┴",
    ("╮", "─"): "┬", ("╭", "─"): "┬", ("╯", "─"): "┴", ("╰", "─"): "┴",
    ("│", "╮"): "┤", ("│", "╯"): "┤", ("│", "╭"): "├", ("│", "╰"): "├",
    ("╮", "│"): "┤", ("╯", "│"): "┤", ("╭", "│"): "├", ("╰", "│"): "├",
    ("╮", "╯"): "┤", ("╯", "╮"): "┤", ("╭", "╰"): "├", ("╰", "╭"): "├",
    ("╮", "╰"): "┼", ("╰", "╮"): "┼", ("╭", "╯"): "┼", ("╯", "╭"): "┼",
}

# named ANSI palette (≈ utf8::color::palette::Default)
PALETTE = {
    "black": "30", "red": "31", "green": "32", "yellow": "33", "blue": "34",
    "magenta": "35", "cyan": "36", "white": "37",
    "bright_black": "90", "bright_red": "91", "bright_green": "92",
    "bright_yellow": "93", "bright_blue": "94", "bright_magenta": "95",
    "bright_cyan": "96", "bright_white": "97",
}
_RESET = "\x1b[0m"


def _sgr(color: str | None = None, *, bold: bool = False) -> str:
    parts = []
    if bold:
        parts.append("1")
    if color:
        parts.append(PALETTE.get(color, color))
    return f"\x1b[{';'.join(parts)}m" if parts else ""


def colour(obj: Any, color: str, *, bold: bool = False) -> Any:
    """Attach a display colour to a block or edge
    (≈ gr::graph::colour, qa_ImGraph.cpp:199-203)."""
    obj.ui_style = _sgr(color, bold=bold)
    return obj


def style(obj: Any, sgr: str) -> Any:
    """Attach a raw SGR style string to a block or edge (≈ gr::graph::style)."""
    obj.ui_style = sgr if sgr.startswith("\x1b") else _sgr(sgr)
    return obj


def detect_feedback_loops(graph: Graph) -> list[list[Any]]:
    """Each graph cycle as its edge list, closing feedback edge last
    (≈ gr::graph::detectFeedbackLoops, qa_ImGraph.cpp:202). Cycles are closed
    by explicit ``feedback=True`` edges here, so each loop is the shortest
    forward path dst→src plus that back edge."""
    flat = graph.flatten()
    fwd = [e for e in flat.edges if not getattr(e, "feedback", False)]
    loops = []
    for fb in flat.edges:
        if not getattr(fb, "feedback", False):
            continue
        # BFS from fb.dst to fb.src over forward edges
        frontier = [(fb.dst, [])]
        seen = {fb.dst}
        path = None
        while frontier and path is None:
            nxt = []
            for node, p in frontier:
                for e in fwd:
                    if e.src is node and e.dst not in seen:
                        if e.dst is fb.src:
                            path = p + [e]
                            break
                        seen.add(e.dst)
                        nxt.append((e.dst, p + [e]))
                if path:
                    break
            frontier = nxt
        loops.append((path or []) + [fb])
    return loops


class _Canvas:
    def __init__(self) -> None:
        self.cells: dict[tuple[int, int], str] = {}
        self.styles: dict[tuple[int, int], str] = {}

    def put(self, y: int, x: int, ch: str, *, force: bool = False,
            sgr: str = "") -> None:
        old = self.cells.get((y, x))
        if old is None or old == " " or force:
            self.cells[(y, x)] = ch
        elif ch == " ":
            return
        else:
            self.cells[(y, x)] = _MERGE.get((old, ch), ch)
        if sgr:
            self.styles[(y, x)] = sgr

    def text(self, y: int, x: int, s: str, sgr: str = "") -> None:
        for i, ch in enumerate(s):
            self.put(y, x + i, ch, force=True, sgr=sgr)

    def render(self, max_width: int, *, color: bool = True) -> str:
        if not self.cells:
            return ""
        ys = [y for y, _ in self.cells]
        xs = [x for _, x in self.cells]
        out = []
        for y in range(min(ys), max(ys) + 1):
            chars = []
            cur = ""
            width = 0
            for x in range(0, max(xs) + 1):
                if width >= max_width:
                    break
                ch = self.cells.get((y, x), " ")
                sgr = self.styles.get((y, x), "") if color else ""
                if sgr != cur:
                    if cur:
                        chars.append(_RESET)
                    if sgr:
                        chars.append(sgr)
                    cur = sgr
                chars.append(ch)
                width += 1
            if cur:
                chars.append(_RESET)
            out.append("".join(chars).rstrip())
        return "\n".join(out)


class _VNode:
    """Virtual pass-through node for an edge spanning multiple columns."""

    def __init__(self, edge) -> None:
        self.edge = edge


def _label(b) -> str:
    return b.name if b.name != b.unique_name else type(b).__name__


def _node_style(b) -> str:
    s = getattr(b, "ui_style", "")
    if not s:
        cons = getattr(b, "ui_constraints", None) or {}
        c = cons.get("color")
        s = _sgr(c) if c else ""
    return s


def _layout_direction(flat, direction: str | None) -> str:
    """Resolve the render direction from the explicit arg or any block's
    layout_pref ui-constraint (qa_ImGraph.cpp:107 'layout_pref')."""
    if direction in ("horizontal", "vertical"):
        return direction
    pref = None
    for b in flat.blocks:
        cons = getattr(b, "ui_constraints", None) or {}
        p = cons.get("layout_pref")
        if p in ("vertical", "horizontal"):
            pref = p
        elif p == "auto" and pref is None:
            pref = "auto"
    if pref in ("vertical", "horizontal"):
        return pref
    if pref == "auto" or direction == "auto":
        # deep chains read better top-to-bottom; depth = longest forward path
        order = flat.topological_order()
        fwd = [e for e in flat.edges if not getattr(e, "feedback", False)]
        depth: dict[Any, int] = {}
        for b in order:
            preds = [e.src for e in fwd if e.dst is b]
            depth[b] = 1 + max((depth[p] for p in preds), default=-1)
        return "vertical" if max(depth.values(), default=0) + 1 > 6 \
            else "horizontal"
    return "horizontal"


def render_graph(graph: Graph, *, max_width: int = 120,
                 direction: str | None = None, color: bool = True) -> str:
    """Render the flowgraph as a routed ASCII diagram + an edge appendix."""
    flat = graph.flatten()
    if not flat.blocks:
        return "(empty graph)"
    direction = _layout_direction(flat, direction)
    order = flat.topological_order()
    fwd = [e for e in flat.edges if not getattr(e, "feedback", False)]
    fbs = [e for e in flat.edges if getattr(e, "feedback", False)]
    depth: dict[Any, int] = {}
    for b in order:
        preds = [e.src for e in fwd if e.dst is b]
        depth[b] = 1 + max((depth[p] for p in preds), default=-1)
    n_cols = max(depth.values()) + 1

    # segments: each edge becomes a chain of per-gutter hops through virtual
    # nodes so every hop connects adjacent columns (Sugiyama virtual nodes)
    cols: list[list[Any]] = [[] for _ in range(n_cols)]
    for b in order:
        cols[depth[b]].append(b)
    hops: list[tuple[Any, Any, Any]] = []   # (src_node, dst_node, edge)
    for e in fwd:
        d0, d1 = depth[e.src], depth[e.dst]
        prev: Any = e.src
        for c in range(d0 + 1, d1):
            v = _VNode(e)
            cols[c].append(v)
            hops.append((prev, v, e))
            prev = v
        hops.append((prev, e.dst, e))

    # barycenter row ordering, two sweeps
    row: dict[Any, int] = {}
    for c, col in enumerate(cols):
        for i, nd in enumerate(col):
            row[nd] = i
    preds_of: dict[Any, list[Any]] = {}
    succs_of: dict[Any, list[Any]] = {}
    for s, d, _ in hops:
        preds_of.setdefault(d, []).append(s)
        succs_of.setdefault(s, []).append(d)
    for sweep_cols, nbrs in ((range(1, n_cols), preds_of),
                             (range(n_cols - 2, -1, -1), succs_of)):
        for c in sweep_cols:
            def key(nd):
                ns = nbrs.get(nd, [])
                return (sum(row[x] for x in ns) / len(ns) if ns else row[nd],
                        row[nd])
            cols[c].sort(key=key)
            for i, nd in enumerate(cols[c]):
                row[nd] = i

    if direction == "vertical":
        art = _draw_vertical(cols, row, hops, fbs, depth, max_width, color)
        return _with_edge_appendix(art, flat)

    # geometry
    pitch = 4                      # vertical rows per slot (3-line box + gap)
    box_w: list[int] = []
    for col in cols:
        labels = [_label(b) for b in col if not isinstance(b, _VNode)]
        box_w.append(max((len(s) for s in labels), default=2) + 4)
    gutter_lanes = [max(1, sum(1 for s, d, _ in hops
                               if (s in cols[c]) and (d in cols[c + 1])))
                    for c in range(n_cols - 1)]
    x0: list[int] = []
    x = 0
    for c in range(n_cols):
        x0.append(x)
        x += box_w[c]
        if c < n_cols - 1:
            x += 2 * gutter_lanes[c] + 3

    cv = _Canvas()

    def y_mid(nd) -> int:
        return row[nd] * pitch + 1

    # boxes + virtual pass-throughs
    for c, col in enumerate(cols):
        for nd in col:
            if isinstance(nd, _VNode):
                y = y_mid(nd)
                sgr = getattr(nd.edge, "ui_style", "")
                for xx in range(x0[c], x0[c] + box_w[c]):
                    cv.put(y, xx, "─", sgr=sgr)
                continue
            lbl = _label(nd)
            w = box_w[c]
            y = row[nd] * pitch
            sgr = _node_style(nd)
            cv.text(y, x0[c], "┌" + "─" * (w - 2) + "┐", sgr)
            cv.text(y + 1, x0[c], "│ " + lbl.ljust(w - 4) + " │", sgr)
            cv.text(y + 2, x0[c], "└" + "─" * (w - 2) + "┘", sgr)

    # routed hops per gutter: horizontal out → lane vertical → horizontal in ▶
    for c in range(n_cols - 1):
        lane_x0 = x0[c] + box_w[c] + 1
        gutter_hops = [(s, d, e) for s, d, e in hops
                       if s in cols[c] and d in cols[c + 1]]
        gutter_hops.sort(key=lambda h: (y_mid(h[0]), y_mid(h[1])))
        for lane, (s, d, e) in enumerate(gutter_hops):
            sgr = getattr(e, "ui_style", "")
            lx = lane_x0 + 2 * lane
            ys, yd = y_mid(s), y_mid(d)
            for xx in range(x0[c] + box_w[c], lx):
                cv.put(ys, xx, "─", sgr=sgr)
            if ys == yd:
                for xx in range(lx, x0[c + 1] - 1):
                    cv.put(ys, xx, "─", sgr=sgr)
            else:
                down = yd > ys
                cv.put(ys, lx, "╮" if down else "╯", sgr=sgr)
                step = 1 if down else -1
                for yy in range(ys + step, yd, step):
                    cv.put(yy, lx, "│", sgr=sgr)
                cv.put(yd, lx, "╰" if down else "╭", sgr=sgr)
                for xx in range(lx + 1, x0[c + 1] - 1):
                    cv.put(yd, xx, "─", sgr=sgr)
            cv.put(yd, x0[c + 1] - 1,
                   "▶" if not isinstance(d, _VNode) else "─", force=True,
                   sgr=sgr)

    # feedback edges: route through the bottom gutter — down from the src box,
    # left under the diagram, up into the dst box (one lane per loop)
    y_floor = (max(row[nd] for nd in row) + 1) * pitch
    for lane, e in enumerate(fbs):
        sgr = getattr(e, "ui_style", "") or _sgr("cyan")
        xs_ = x0[depth[e.src]] + box_w[depth[e.src]] // 2 + 1 + lane
        xd_ = x0[depth[e.dst]] + box_w[depth[e.dst]] // 2 - 1 - lane
        ysrc = row[e.src] * pitch + 3            # just below the src box
        ydst = row[e.dst] * pitch + 3
        yl = y_floor + lane                      # this loop's bottom lane
        for yy in range(ysrc, yl):
            cv.put(yy, xs_, "│", sgr=sgr)
        cv.put(yl, xs_, "╯", sgr=sgr)
        for xx in range(xd_ + 1, xs_):
            cv.put(yl, xx, "─", sgr=sgr)
        cv.put(yl, xd_, "╰", sgr=sgr)
        for yy in range(ydst + 1, yl):
            cv.put(yy, xd_, "│", sgr=sgr)
        cv.put(ydst, xd_, "▲", force=True, sgr=sgr)

    art = cv.render(max_width, color=color)
    return _with_edge_appendix(art, flat)


def _with_edge_appendix(art: str, flat) -> str:
    from .formatting import edge as fmt_edge
    lines = [art, "", "edges:"]
    for e in flat.edges:
        fb = " (feedback)" if getattr(e, "feedback", False) else ""
        nm = f" [{e.name}]" if getattr(e, "name", "") else ""
        lines.append("  " + fmt_edge(e) + nm + fb)
    for src, dst in flat.message_edges:
        lines.append(f"  {_label(src)} ╌▶ {_label(dst)} (message)")
    return "\n".join(lines)


def _draw_vertical(cols, row, hops, fbs, depth, max_width: int, color: bool
                   ) -> str:
    """Top-to-bottom layout (layout_pref='vertical', qa_ImGraph.cpp:101-124):
    depth bands stack vertically; edges route down through horizontal lane
    gutters between bands; feedback loops ride a right-side gutter back up."""
    cv = _Canvas()
    labels = [_label(nd) for col in cols for nd in col
              if not isinstance(nd, _VNode)]
    slot_w = max((len(s) for s in labels), default=2) + 6
    lanes = [max(1, sum(1 for s, d, _ in hops
                        if s in cols[c] and d in cols[c + 1]))
             for c in range(len(cols) - 1)]
    y0 = []
    y = 0
    for c in range(len(cols)):
        y0.append(y)
        y += 3                          # box height
        if c < len(cols) - 1:
            y += lanes[c] + 2           # one row per lane + spacing

    def x_mid(nd) -> int:
        return row[nd] * slot_w + slot_w // 2

    for c, col in enumerate(cols):
        for nd in col:
            if isinstance(nd, _VNode):
                sgr = getattr(nd.edge, "ui_style", "")
                for yy in range(y0[c], y0[c] + 3):
                    cv.put(yy, x_mid(nd), "│", sgr=sgr)
                continue
            lbl = _label(nd)
            w = len(lbl) + 4
            xl = x_mid(nd) - w // 2
            sgr = _node_style(nd)
            cv.text(y0[c], xl, "┌" + "─" * (w - 2) + "┐", sgr)
            cv.text(y0[c] + 1, xl, "│ " + lbl + " │", sgr)
            cv.text(y0[c] + 2, xl, "└" + "─" * (w - 2) + "┘", sgr)

    for c in range(len(cols) - 1):
        gutter_hops = [(s, d, e) for s, d, e in hops
                       if s in cols[c] and d in cols[c + 1]]
        gutter_hops.sort(key=lambda h: (x_mid(h[0]), x_mid(h[1])))
        lane_y0 = y0[c] + 3
        for lane, (s, d, e) in enumerate(gutter_hops):
            sgr = getattr(e, "ui_style", "")
            xs_, xd_ = x_mid(s), x_mid(d)
            ly = lane_y0 + lane
            for yy in range(y0[c] + 3, ly):
                cv.put(yy, xs_, "│", sgr=sgr)
            if xs_ == xd_:
                for yy in range(ly, y0[c + 1] - 1):
                    cv.put(yy, xs_, "│", sgr=sgr)
            else:
                right = xd_ > xs_
                cv.put(ly, xs_, "╰" if right else "╯", sgr=sgr)
                step = 1 if right else -1
                for xx in range(xs_ + step, xd_, step):
                    cv.put(ly, xx, "─", sgr=sgr)
                cv.put(ly, xd_, "╮" if right else "╭", sgr=sgr)
                for yy in range(ly + 1, y0[c + 1] - 1):
                    cv.put(yy, xd_, "│", sgr=sgr)
            cv.put(y0[c + 1] - 1, xd_,
                   "▼" if not isinstance(d, _VNode) else "│", force=True,
                   sgr=sgr)

    # feedback: right-side gutter, one column per loop, routed back UP
    if fbs:
        x_wall = max((row[nd] * slot_w + slot_w for nd in row), default=0) + 1
        for lane, e in enumerate(fbs):
            sgr = getattr(e, "ui_style", "") or _sgr("cyan")
            ys_ = y0[depth[e.src]] + 1
            yd_ = y0[depth[e.dst]] + 1
            xw = x_wall + 2 * lane
            xs_edge = x_mid(e.src) + (len(_label(e.src)) + 4) // 2
            xd_edge = x_mid(e.dst) + (len(_label(e.dst)) + 4) // 2
            for xx in range(xs_edge, xw):
                cv.put(ys_, xx, "─", sgr=sgr)
            cv.put(ys_, xw, "╯", sgr=sgr)
            for yy in range(yd_ + 1, ys_):
                cv.put(yy, xw, "│", sgr=sgr)
            cv.put(yd_, xw, "╮", sgr=sgr)
            for xx in range(xd_edge + 1, xw):
                cv.put(yd_, xx, "─", sgr=sgr)
            cv.put(yd_, xd_edge, "◀", force=True, sgr=sgr)
    return cv.render(max_width, color=color)


def to_dot(graph: Graph) -> str:
    """Graphviz DOT rendering of the flowgraph (for docs/visualization tools)."""
    flat = graph.flatten()
    lines = ["digraph flowgraph {", "  rankdir=LR;",
             '  node [shape=box, fontname="monospace"];']

    def ident(b) -> str:
        return b.unique_name.replace("#", "_")

    for b in flat.blocks:
        label = b.name if b.name != b.unique_name else type(b).__name__
        lines.append(f'  {ident(b)} [label="{label}\\n{type(b).__name__}"];')
    for e in flat.edges:
        attrs = []
        if e.samples_per_step:
            attrs.append(f'label="{e.samples_per_step}"')
        if getattr(e, "feedback", False):
            attrs.append("style=dashed, color=red, constraint=false")
        a = f" [{', '.join(attrs)}]" if attrs else ""
        lines.append(f"  {ident(e.src)} -> {ident(e.dst)}{a};")
    for src, dst in flat.message_edges:
        lines.append(f"  {ident(src)} -> {ident(dst)} [style=dashed];")
    lines.append("}")
    return "\n".join(lines)
