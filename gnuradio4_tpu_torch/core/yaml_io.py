"""GRC-style YAML flowgraph serialization.

≈ reference ``loadGrc``/``saveGrc`` (core Graph_yaml_importer.hpp:396,407) with the
same round-trip guarantee (load→save→load equality, qa_grc.cpp). Schema:

```yaml
name: my_flowgraph
sample_rate: 48000.0
block_len: 65536
blocks:
  - name: src                 # instance name (unique)
    id: SignalGenerator       # registry type name
    parameters: {frequency: 1000.0, n_samples: 4096}
    ctx_parameters:           # optional settings contexts (≈ SettingsCtx presets)
      - {context: "calib", time: 0.0, parameters: {amplitude: 0.5}}
connections:
  - [src, out, fir, in]       # src_block, src_port, dst_block, dst_port
```

Nested graphs serialize blocks of type ``Graph`` with their own blocks/connections
and ``exports: {in: {...}, out: {...}}``.

The text is read and written by this package's own YAML code (``yaml_pmt`` on
``yaml_lite``); PyYAML is not needed. An edge's compute domain travels as
its ``domain`` attribute ("kind:backend:idx"), as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .block import Block
from .errors import GrError
from .graph import Graph
from .registry import BlockRegistry, PluginLoader, global_registry
from .settings import SettingsCtx
from .yaml_lite import dump_document


def _clean_value(v: Any) -> Any:
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (tuple, list)):
        return [_clean_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _clean_value(x) for k, x in v.items()}
    return v


def _block_to_map(block: Block) -> dict[str, Any]:
    if isinstance(block, Graph):
        # nested graphs serialize structurally (composites like WbfmReceiver
        # flatten to their constituent registry blocks — lossless behavior-wise)
        return {"name": block.name, "id": "Graph", **_graph_body(block)}
    params = {}
    defaults = block.settings._defaults
    for k in block.settings.keys():
        v = block.settings.get(k)
        params[k] = _clean_value(v)
    m: dict[str, Any] = {"name": block.name,
                         "id": getattr(type(block), "registry_name",
                                       type(block).__name__)}
    # the reference's loadGrc requires parameters.name (Graph_yaml_importer.hpp:101
    # getOrThrow) — duplicate the instance name inside the parameters map so YAML
    # written here loads in the reference too; load_grc strips it back out
    params["name"] = block.name
    m["parameters"] = params
    ctxs = block.settings.stored_contexts()
    if ctxs:
        m["ctx_parameters"] = [
            {"context": c.context, "time": c.time,
             "parameters": _clean_value(block.settings._contexts[c])}
            for c in ctxs]
    return m


def _edge_entry(e) -> list:
    entry: list = [e.src.name, e.src_port, e.dst.name, e.dst_port]
    extra: dict[str, Any] = {}
    if e.feedback:
        extra["feedback"] = True
        extra["delay"] = int(e.delay)
        if e.fb_init:
            extra["fb_init"] = float(e.fb_init)
    if e.domain is not None:
        extra["domain"] = str(e.domain)
    if e.min_buffer_size:
        extra["min_buffer_size"] = int(e.min_buffer_size)
    if e.weight:
        extra["weight"] = int(e.weight)
    if extra:
        entry.append(extra)
    return entry


def _graph_body(graph: Graph) -> dict[str, Any]:
    body: dict[str, Any] = {
        "blocks": [_block_to_map(b) for b in graph.blocks],
        "connections": [_edge_entry(e) for e in graph.edges],
    }
    exports: dict[str, Any] = {}
    if graph._exports_in:
        exports["in"] = {pub: [blk.name, prt]
                         for pub, (blk, prt) in graph._exports_in.items()}
    if graph._exports_out:
        exports["out"] = {pub: [blk.name, prt]
                          for pub, (blk, prt) in graph._exports_out.items()}
    if exports:
        body["exports"] = exports
    return body


def save_grc(graph: Graph, *, sample_rate: float | None = None,
             block_len: int | None = None) -> str:
    """Serialize a flowgraph to YAML (≈ saveGrc, Graph_yaml_importer.hpp:407)."""
    doc: dict[str, Any] = {"name": graph.name}
    if sample_rate is not None:
        doc["sample_rate"] = float(sample_rate)
    if block_len is not None:
        doc["block_len"] = int(block_len)
    doc.update(_graph_body(graph))
    return dump_document(doc)


def _strip_reference_id(bid: str) -> str:
    """Map a reference-style block id to a registry name: drop the template
    argument list and C++ namespace qualifiers —
    'gr::testing::ArraySource<float64>' → 'ArraySource'
    (reference ids per qa_grc.cpp:130-137)."""
    base = bid.split("<", 1)[0]
    return base.rsplit("::", 1)[-1].strip()


def _resolve_port_name(block: Block, entry: Any, *, output: bool) -> str:
    """Port refs may be names (this framework) or index forms (the reference:
    plain index, or [collection, sub] pairs, qa_grc.cpp:143-147)."""
    ports = block.out_ports if output else block.in_ports
    if isinstance(entry, int):
        idx = entry
    elif isinstance(entry, (list, tuple)):
        a, b = (int(entry[0]), int(entry[1])) if len(entry) == 2 else (0, 0)
        idx = a + b if (a == 0 or b == 0) else a   # flat best-effort mapping
    else:
        return str(entry)
    if not 0 <= idx < len(ports):
        raise GrError(f"{block.name}: port index {entry} out of range "
                      f"({len(ports)} {'out' if output else 'in'} ports)")
    return ports[idx].name


def _build_graph(body: dict[str, Any], registry: BlockRegistry,
                 name: str = "graph") -> Graph:
    g = Graph(name=body.get("name", name), registry=registry)
    by_name: dict[str, Block] = {}
    for bm in body.get("blocks", []) or []:
        bid = bm.get("id")
        if bid and not registry.contains(bid) and \
                registry.contains(_strip_reference_id(bid)):
            bid = _strip_reference_id(bid)
        # the reference carries the instance name ONLY inside parameters
        # (Graph_yaml_importer.hpp:101); accept either location
        bname = bm.get("name") or (bm.get("parameters") or {}).get("name")
        if bid == "Graph" or ("blocks" in bm and not registry.contains(bid)):
            sub = _build_graph(bm, registry, name=bname or "subgraph")
            sub.name = bname or sub.name
            g.add(sub)
            by_name[sub.name] = sub
            continue
        params = dict(bm.get("parameters") or {})
        # reference-format compatibility: parameters.name mirrors the instance
        # name (see _block_to_map); it is not a block setting
        params.pop("name", None)
        params = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in params.items()}
        # reference ids templated on UncertainValue (e.g.
        # 'gr::blocks::math::Add<gr::UncertainValue<float>>', Math.hpp:68)
        # map to our 2-plane uncertain-stream mode where supported
        if "UncertainValue" in str(bm.get("id") or "") \
                and "uncertain" not in params:
            from .settings import Setting as _Setting
            f = registry.get(bid)
            if isinstance(f, type) and \
                    isinstance(getattr(f, "uncertain", None), _Setting):
                params["uncertain"] = True
        blk = registry.create(bid, **params)
        blk.name = bname or blk.name
        for cm in bm.get("ctx_parameters", []) or []:
            ctx = SettingsCtx(time=float(cm.get("time", 0.0)),
                              context=str(cm.get("context", "")))
            blk.settings.set(dict(cm.get("parameters") or {}), ctx=ctx)
        g.add(blk)
        if blk.name in by_name:
            raise GrError(f"duplicate block name {blk.name!r} in YAML")
        by_name[blk.name] = blk
    exports = body.get("exports") or {}
    for pub, (bn, prt) in (exports.get("in") or {}).items():
        g.export_in(pub, by_name[bn], prt)
    for pub, (bn, prt) in (exports.get("out") or {}).items():
        g.export_out(pub, by_name[bn], prt)
    for conn in body.get("connections", []) or []:
        if len(conn) == 5 and isinstance(conn[4], dict):
            extra = dict(conn[4])
            conn = conn[:4]
        elif len(conn) == 4:
            extra = {}
        else:
            raise GrError(f"connection entry must be "
                          f"[src, port, dst, port(, attrs)]: {conn}")
        sname, sport, dname, dport = conn
        try:
            src, dst = by_name[sname], by_name[dname]
        except KeyError as e:
            raise GrError(f"connection references unknown block {e}") from e
        sport = _resolve_port_name(src, sport, output=True)
        dport = _resolve_port_name(dst, dport, output=False)
        g.connect(src, dst, src_port=sport, dst_port=dport,
                  feedback=bool(extra.get("feedback", False)),
                  delay=int(extra.get("delay", 1)),
                  fb_init=float(extra.get("fb_init", 0.0)),
                  domain=extra.get("domain"),
                  min_buffer_size=int(extra.get("min_buffer_size", 0)),
                  weight=int(extra.get("weight", 0)))
    return g


def load_grc(source: str, *, loader: PluginLoader | None = None,
             registry: BlockRegistry | None = None) -> Graph:
    """Instantiate a flowgraph from YAML (≈ loadGrc, Graph_yaml_importer.hpp:396)."""
    registry = registry or (loader.registry if loader else global_registry)
    # reference-dialect loader: GRC files written by the reference carry
    # pmt type tags (!!float32, !!complex64 (re, im), … — YamlPmt.hpp);
    # parameters arrive as correctly-typed numpy scalars/arrays
    from .yaml_pmt import load as load_pmt_yaml
    doc = load_pmt_yaml(source)
    if not isinstance(doc, dict):
        raise GrError("flowgraph YAML must be a mapping")
    for plugin in doc.get("plugins", []) or []:
        (loader or PluginLoader(registry)).load(plugin)
    g = _build_graph(doc, registry)
    g.yaml_meta = {k: doc[k] for k in ("sample_rate", "block_len") if k in doc}
    return g


def run_grc(source: str, *, n_steps: int | None = None,
            scheduler_kwargs: dict | None = None):
    """Load + run a YAML flowgraph; returns the scheduler (for sink inspection)."""
    from .scheduler import Scheduler
    g = load_grc(source)
    meta = getattr(g, "yaml_meta", {})
    kw = dict(scheduler_kwargs or {})
    kw.setdefault("sample_rate", meta.get("sample_rate", 1.0))
    kw.setdefault("block_len", meta.get("block_len", 1 << 16))
    sched = Scheduler(g, **kw)
    sched.run_and_wait(n_steps)
    return sched
