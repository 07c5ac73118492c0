"""Graph → step function.

The whole flattened graph becomes one step function

    step(states, params, feeds, overlays) → (states', sink_inputs)

that runs every block's ``apply`` in topological order on the graph's device.
PyTorch runs it eagerly: each block launches its kernels on the current CUDA
stream, and intermediates stay on the device. Carried block state (FIR tails,
NCO phase — the analog of HistoryBuffer) threads through the step as a dict of
tensors. Host-fed sources (``FEED`` blocks) see their fed arrays as inputs.

Static shapes: per-edge samples-per-step come from Graph.resolve_rates (the rate
algebra replacing the reference's per-work() computeResampling, Block.hpp:1611).

Feedback loops (≈ reference feedback merges, BlockMerging.hpp:628-645): each
cycle closed by a ``feedback=True`` edge is contracted into a loop group that
runs as a Python loop over ``delay``-sized sub-steps. The back-edge values are
the loop's carry, one sub-step behind; they persist across steps as the
``__fb__<i>`` state, seeded from the edges' ``fb_init``.
"""

from __future__ import annotations

import dataclasses
import os
from fractions import Fraction
from typing import Any

import numpy as np
import torch

from .block import Block, BlockCtx, SinkBlock
from .errors import GrError
from .graph import Edge, Graph
from .stream import canonical_dtype, torch_dtype


def default_device() -> torch.device:
    """The card (``cuda``). Raises :class:`GrError` when there is none: running
    on the CPU is asked for with ``device="cpu"``, never chosen silently."""
    if not torch.cuda.is_available():
        raise GrError("no CUDA device is present (torch.cuda.is_available() is "
                      "False); pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def _feed_tensor(a: np.ndarray | torch.Tensor, device: torch.device
                 ) -> torch.Tensor:
    """A host-fed array as a tensor of its stream's torch dtype on ``device``
    (uint32 streams travel as int64, as everywhere in this package). A tensor
    (a pipeline stage's input) only moves to ``device``."""
    if torch.is_tensor(a):
        return a.to(device)
    dt = torch_dtype(a.dtype)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype != dt:
        t = t.to(dt)
    return t.to(device)


def _apply_or_raise(b: Block, what: str, fn, *args):
    """``fn(*args)`` for block ``b`` (its ``apply`` or sp lowering, named by
    ``what``): a ``GrError`` is raised again with ``b`` as its block where it
    names none, any other error as a ``GrError`` naming ``b``."""
    try:
        return fn(*args)
    except GrError as e:
        if e.block is None:
            e.block = b.name
        raise
    except Exception as e:
        raise GrError(f"{b.name} ({type(b).__name__}).{what} failed: "
                      f"{type(e).__name__}: {e}", block=b.name) from e


@dataclasses.dataclass
class CompiledGraph:
    """A rate-resolved flowgraph bound to a device, ready for the scheduler."""

    graph: Graph                      # flattened
    order: list[Block]
    in_len: dict[str, int]            # block unique_name → input samples/step
    out_len: dict[str, int]
    block_ctx: dict[str, BlockCtx]
    in_edges: dict[str, list[Edge]]
    fed_blocks: list[Block]           # sources taking host-fed arrays
    sink_names: list[str]
    sample_rate: float
    block_len: int
    device: torch.device
    batch_steps: int = 1              # sub-steps per step() call
    # each block's static settings as compiled: blocks read their settings
    # when they run, so a static change applied before its recompile runs
    # with these (the scheduler's ``_compiled_statics``)
    statics: dict[str, dict[str, Any]] = dataclasses.field(default_factory=dict)
    # the step's execution order: blocks, with each feedback loop group
    # contracted into one dict ``{members, order, delay, fb, fb_keys,
    # state_key, outputs}`` at its place in the condensed topological order
    exec_plan: list[Any] = dataclasses.field(default_factory=list)
    loop_groups: list[dict] = dataclasses.field(default_factory=list)
    fb_init_states: dict[str, Any] = dataclasses.field(default_factory=dict)
    mesh: Any = None
    # under an 'sp' mesh axis: the axis (name, shard devices), each block's
    # per-shard contexts, and the lowering each block got — "local" (per
    # shard), "halo" (left-neighbour halo), "island" (gathered on the home
    # device) or "custom" (the block's own apply_sp); the default lowering's
    # halo lengths
    sp_axis: Any = None
    sp_local_ctx: dict[str, list[BlockCtx]] = dataclasses.field(
        default_factory=dict)
    sp_plan: dict[str, str] = dataclasses.field(default_factory=dict)
    # each block that takes the default lowering: its sp_halo answer
    sp_halos: dict[str, int | None] = dataclasses.field(default_factory=dict)
    # under a 'chan' mesh axis: (block, port) → the PartitionSpec its
    # out_sharding asks for (values stay whole on the home device)
    out_specs: dict[tuple[str, str], Any] = dataclasses.field(
        default_factory=dict)
    _params_cache: Any = None
    _zero_feeds_cache: Any = None
    _pump_plan: Any = None
    _tag_plan: Any = None

    def init_states(self) -> dict[str, Any]:
        """Fresh block states (and the loops' back-edge values, from their
        ``fb_init``), created on the graph's device."""
        states = {b.unique_name: b.init_state(self.block_ctx[b.unique_name])
                  for b in self.order}
        states.update({k: {fk: v.clone() for fk, v in fb.items()}
                       for k, fb in self.fb_init_states.items()})
        return states

    def gather_params(self, refresh: bool = True) -> dict[str, dict[str, Any]]:
        """Dynamic params (host values) for the next step. Blocks that override
        ``prepare_params`` refresh every step; the rest are cached until
        :meth:`invalidate_params`. ``refresh=False`` (batched pump) skips the
        refresh: the per-sub-step overlays carry those blocks' params."""
        if self._params_cache is None:
            self._params_cache = {
                b.unique_name: b.prepare_params(b.settings.dynamic_params())
                for b in self.order}
        elif refresh:
            for b in self.order:
                if type(b).prepare_params is not Block.prepare_params:
                    self._params_cache[b.unique_name] = b.prepare_params(
                        b.settings.dynamic_params())
        return self._params_cache

    def invalidate_params(self) -> None:
        self._params_cache = None

    def zero_feeds(self) -> dict[str, dict[str, np.ndarray]]:
        """One step of zeros for every host-fed source (finished sources and
        padding of partial blocks)."""
        if self._zero_feeds_cache is None:
            feeds: dict[str, dict[str, np.ndarray]] = {}
            for b in self.fed_blocks:
                ctx = self.block_ctx[b.unique_name]
                feeds[b.unique_name] = {
                    p.name: np.zeros(_shape(ctx.channels.get(p.name, 0),
                                            ctx.out_len[p.name]),
                                     dtype=_feed_dtype(b, p.name))
                    for p in b.out_ports}
            self._zero_feeds_cache = feeds
        return self._zero_feeds_cache

    def pump_plan(self):
        """Static per-block record for the scheduler's per-step validity
        passes: (block, uname, is_feed, has_ins, srcs=((src_uname,
        src_out_len)...), ratio_num, ratio_den, stock_clamp, allow_underrun).
        Ratios are settings-derived and fixed per compile (a change marks the
        scheduler dirty and recompiles)."""
        if self._pump_plan is None:
            plan = []
            for b in self.order:
                uname = b.unique_name
                srcs = tuple((e.src.unique_name, self.out_len[e.src.unique_name])
                             for e in self.in_edges[uname])
                r = b.ratio
                num, den = r.numerator, r.denominator
                plan.append((b, uname, bool(getattr(b, "FEED", False)),
                             bool(srcs), srcs, num, den,
                             type(b).clamp_valid is Block.clamp_valid,
                             bool(getattr(b, "ALLOW_UNDERRUN", False))))
            self._pump_plan = plan
        return self._pump_plan

    def tag_plan(self):
        """Static per-block tag-walk plan: (block, uname, [(src_key,
        dst_port)], fast, is_sink, out_port_names, is_source). ``fast`` marks
        blocks with stock propagation and no host tag emission — with no
        incoming tags they can be skipped wholesale each step. A
        WANTS_TAG_ARRAYS block is never fast: a step without tags must still
        clear the tags it received the step before."""
        if self._tag_plan is None:
            plan = []
            for b in self.order:
                uname = b.unique_name
                in_keys = [((e.src.unique_name, e.src_port), e.dst_port)
                           for e in self.in_edges[uname]]
                fast = (type(b).emit_tags is Block.emit_tags
                        and type(b).process_tags is Block.process_tags
                        and not getattr(b, "WANTS_TAG_ARRAYS", False))
                plan.append((b, uname, in_keys, fast, uname in self.sink_names,
                             [p.name for p in b.out_ports],
                             not self.in_edges[uname]))
            self._tag_plan = plan
        return self._tag_plan

    def _run_loop_group(self, group, states, params, values, new_states):
        """One step of a feedback loop group: S = T / delay sub-steps of
        ``delay`` samples each. The external inputs are sliced as views, the
        back-edge values and the member states are the carry, and the
        outputs that leave the group are joined once after the loop."""
        L = group["delay"]
        members: list[Block] = group["order"]
        member_names = group["members"]
        fb_keys = group["fb_keys"]
        S = self.in_len[members[0].unique_name] // L
        plan = []
        for b in members:
            uname = b.unique_name
            lctx = dataclasses.replace(
                self.block_ctx[uname], params=params.get(uname, {}),
                in_len={p.name: L for p in b.in_ports},
                out_len={p.name: L for p in b.out_ports})
            srcs = []
            for e in self.in_edges[uname]:
                skey = (e.src.unique_name, e.src_port)
                if e.feedback:
                    srcs.append((e.dst_port, "fb", fb_keys[skey]))
                elif e.src.unique_name in member_names:
                    srcs.append((e.dst_port, "val", skey))
                else:
                    srcs.append((e.dst_port, "ext", values[skey]))
            plan.append((b, uname, lctx, srcs))
        fb = states[group["state_key"]]     # init_states seeds it
        sts = {b.unique_name: states.get(b.unique_name) for b in members}
        outputs = group["outputs"]
        pieces: dict[tuple[str, str], list[torch.Tensor]] = \
            {k: [] for k in outputs}
        for s in range(S):
            lo, hi = s * L, (s + 1) * L
            vals: dict[tuple[str, str], torch.Tensor] = {}
            for b, uname, lctx, srcs in plan:
                ins = {}
                for port, kind, ref in srcs:
                    if kind == "fb":
                        ins[port] = fb[ref]
                    elif kind == "val":
                        ins[port] = vals[ref]
                    else:
                        ins[port] = ref[..., lo:hi]
                st, outs = b.apply(sts[uname], ins, lctx)
                sts[uname] = st
                for pname, arr in outs.items():
                    vals[(uname, pname)] = arr
            fb = {fk: vals[skey] for skey, fk in fb_keys.items()}
            for key in outputs:
                pieces[key].append(vals[key])
        new_states[group["state_key"]] = fb
        new_states.update(sts)
        for key, parts in pieces.items():
            values[key] = torch.cat(parts, dim=-1)

    def _run_group_or_raise(self, group, states, params, values, new_states):
        """:meth:`_run_loop_group`, any error but a ``GrError`` raised again
        as one naming the group's members."""
        try:
            self._run_loop_group(group, states, params, values, new_states)
        except GrError:
            raise
        except Exception as e:
            names = [m.name for m in group["order"]]
            raise GrError(f"feedback loop {names} failed: "
                          f"{type(e).__name__}: {e}") from e

    def _substep(self, states, params, feeds):
        values: dict[tuple[str, str], torch.Tensor] = {}
        new_states: dict[str, Any] = {}
        sink_ins: dict[str, dict[str, torch.Tensor]] = {}
        for b in self.exec_plan:
            if isinstance(b, dict):      # a contracted feedback loop group
                self._run_group_or_raise(b, states, params, values, new_states)
                continue
            uname = b.unique_name
            ctx = dataclasses.replace(self.block_ctx[uname],
                                      params=params.get(uname, {}))
            ins = {e.dst_port: values[(e.src.unique_name, e.src_port)]
                   for e in self.in_edges[uname]}
            if uname in feeds:
                # host-fed sources see their fed arrays as inputs
                ins = {**feeds[uname], **ins}
            if uname in self.sink_names:
                sink_ins[uname] = ins
            st, outs = _apply_or_raise(b, "apply", b.apply, states.get(uname),
                                       ins, ctx)
            new_states[uname] = st
            for pname, arr in outs.items():
                values[(uname, pname)] = arr
        return new_states, sink_ins

    def _substep_sp(self, states, params, feeds):
        """One step under time sharding: every stream value is a list of
        local shards, one per device of ``sp_axis``; each block runs through
        its ``apply_sp``, a feedback loop group once on the home device over
        its gathered inputs, and each sink's inputs are joined on the home
        device.

        When the axis spans processes, the lists hold this process's shards:
        ``feeds`` are this process's time slice (the scheduler cuts them), a
        loop group all-gathers its inputs and runs on every process,
        replicated, and a sink's join is this process's slice (what the JAX
        package's ``drain_local`` gives its sinks)."""
        from ..parallel.collectives import (gather, gather_global, split,
                                            split_local)
        axis = self.sp_axis
        home = axis.home
        values: dict[tuple[str, str], list[torch.Tensor]] = {}
        new_states: dict[str, Any] = {}
        sink_ins: dict[str, dict[str, torch.Tensor]] = {}
        for b in self.exec_plan:
            if isinstance(b, dict):      # a feedback loop group: an island
                full: dict[tuple[str, str], torch.Tensor] = {}
                for m in b["order"]:
                    for e in self.in_edges[m.unique_name]:
                        key = (e.src.unique_name, e.src_port)
                        if not e.feedback and key not in full and \
                                e.src.unique_name not in b["members"]:
                            full[key] = gather_global(values[key], axis,
                                                      home)
                self._run_group_or_raise(b, states, params, full, new_states)
                for key in b["outputs"]:
                    values[key] = split(full[key], axis)
                continue
            uname = b.unique_name
            ctx = dataclasses.replace(self.block_ctx[uname],
                                      params=params.get(uname, {}))
            ins = [{} for _ in range(axis.local_size)]
            for p, t in feeds.get(uname, {}).items():
                for d, part in zip(ins, split_local(t, axis)):
                    d[p] = part
            for e in self.in_edges[uname]:
                for d, part in zip(ins, values[(e.src.unique_name,
                                                e.src_port)]):
                    d[e.dst_port] = part
            if uname in self.sink_names:
                sink_ins[uname] = {p: gather([d[p] for d in ins], home)
                                   for p in ins[0]}
            lctx = [dataclasses.replace(c, params=ctx.params)
                    for c in self.sp_local_ctx[uname]]
            if uname in self.sp_halos:      # the default lowering
                st, outs = _apply_or_raise(
                    b, "apply_sp", b.lower_sp, self.sp_halos[uname],
                    states.get(uname), ins, ctx, lctx, axis)
            else:
                st, outs = _apply_or_raise(b, "apply_sp", b.apply_sp,
                                           states.get(uname), ins, ctx, lctx,
                                           axis)
            new_states[uname] = st
            for pname in outs[0]:
                values[(uname, pname)] = [o[pname] for o in outs]
        return new_states, sink_ins

    def step(self, states, params, feeds=None, overlays=None, *,
             stack: bool = True):
        """Run ``batch_steps`` sub-steps.

        ``feeds``: ``{uname: {port: ndarray}}`` for the host-fed sources, one
        step's arrays, or ``[S, ...]`` stacked when batched. ``overlays``
        (batched): ``{uname: [params_0, …, params_{S-1}]}``, per-sub-step
        params merged over ``params`` (tag-accurate ramps, mid-batch settings).
        With one sub-step the sink inputs are the blocks' tensors; with S > 1
        every sink input is S tensors, stacked on a leading [S] axis (the JAX
        package's batched layout) or, with ``stack=False``, a list."""
        fed = {u: {p: _feed_tensor(a, self.device) for p, a in d.items()}
               for u, d in (feeds or {}).items()}
        substep = self._substep if self.sp_axis is None else self._substep_sp
        if self.batch_steps == 1:
            return substep(states, params, fed)
        per: list[dict[str, dict[str, torch.Tensor]]] = []
        for k in range(self.batch_steps):
            p = params
            if overlays:
                p = dict(params)
                for uname, snaps in overlays.items():
                    p[uname] = {**params.get(uname, {}), **snaps[k]}
            states, sink_ins = substep(
                states, p, {u: {q: t[k] for q, t in d.items()}
                            for u, d in fed.items()})
            per.append(sink_ins)
        join = torch.stack if stack else list
        return states, {u: {q: join([s[u][q] for s in per]) for q in per[0][u]}
                        for u in per[0]}


def _fb_init_values(group: dict, out_channels: dict, out_dtypes: dict,
                    device: torch.device) -> dict[str, torch.Tensor]:
    """Initial back-edge values: fb_init broadcast over [channels?, delay]."""
    fb0 = {}
    for e in group["fb"]:
        key = (e.src.unique_name, e.src_port)
        ch = out_channels[key]
        shape = (group["delay"],) if ch == 0 else (ch, group["delay"])
        fb0[group["fb_keys"][key]] = torch.full(
            shape, e.fb_init, dtype=torch_dtype(out_dtypes[key]),
            device=device)
    return fb0


def _plan_feedback(flat: Graph, order: list[Block], fb_edges: list[Edge],
                   in_len: dict[str, int], sink_names: list[str],
                   fed_names: set[str]) -> tuple[list[Any], list[dict]]:
    """Identify feedback-loop groups and build a contracted execution plan.

    A loop group = the blocks on any forward path from a feedback edge's dst to
    its src (overlapping groups merge). The plan is a topological order over
    the condensation: plain blocks interleaved with group dicts
    ``{members, order, delay, fb, fb_keys, state_key, outputs}``; ``outputs``
    are the members' output ports that blocks outside the group read.
    """
    fwd_out: dict[str, list[Edge]] = {b.unique_name: [] for b in flat.blocks}
    for e in flat.edges:
        if not e.feedback:
            fwd_out[e.src.unique_name].append(e)

    def descendants(u0: str) -> set[str]:
        seen: set[str] = set()
        stack = [u0]
        while stack:
            u = stack.pop()
            for e in fwd_out[u]:
                v = e.dst.unique_name
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return seen

    desc_cache = {b.unique_name: descendants(b.unique_name) for b in order}
    raw_groups: list[set[str]] = []
    for e in fb_edges:
        d, s = e.dst.unique_name, e.src.unique_name
        reach = desc_cache[d] | {d}
        members = {u for u in reach if s == u or s in desc_cache[u]}
        if s not in members:
            raise GrError(f"feedback edge {e} closes no forward path "
                          f"{e.dst.name} → {e.src.name}")
        raw_groups.append(members)
    merged: list[set[str]] = []
    for g in raw_groups:
        acc = set(g)
        rest = []
        for m in merged:
            if m & acc:
                acc |= m
            else:
                rest.append(m)
        merged = rest + [acc]

    by_uname = {b.unique_name: b for b in order}
    groups: list[dict] = []
    gid_of: dict[str, int] = {}
    for gi, mem in enumerate(merged):
        blocks = [b for b in order if b.unique_name in mem]  # topo within group
        lens = {in_len[u] for u in mem}
        for b in blocks:
            if b.ratio != Fraction(1):
                raise GrError(f"feedback loop member {b.name} has ratio "
                              f"{b.ratio}; loop blocks must be rate-1")
            if b.unique_name in sink_names or b.unique_name in fed_names:
                raise GrError(f"feedback loop member {b.name} is a sink/"
                              f"host-fed block; move it outside the loop")
        if len(lens) != 1:
            raise GrError(f"feedback loop {[b.name for b in blocks]} has "
                          f"unequal step lengths {sorted(lens)}")
        edges_in = [e for e in fb_edges if e.src.unique_name in mem]
        # stable back-edge value keys (distinct src ports, group-local index):
        # checkpoint-portable across processes and packages, unlike
        # unique_names
        fb_keys: dict[tuple[str, str], str] = {}
        for e in edges_in:
            k = (e.src.unique_name, e.src_port)
            if k not in fb_keys:
                fb_keys[k] = f"v{len(fb_keys)}"
        delays = {e.delay for e in edges_in}
        if len(delays) != 1:
            raise GrError(f"feedback edges of one loop must share a delay; "
                          f"got {sorted(delays)}")
        delay = delays.pop()
        n = lens.pop()
        if n % delay:
            raise GrError(f"feedback delay {delay} must divide the loop's "
                          f"samples-per-step {n}")
        outputs = []
        for e in flat.edges:
            k = (e.src.unique_name, e.src_port)
            if not e.feedback and e.src.unique_name in mem \
                    and e.dst.unique_name not in mem and k not in outputs:
                outputs.append(k)
        groups.append({"members": mem, "order": blocks, "delay": delay,
                       "fb": edges_in, "fb_keys": fb_keys,
                       "state_key": f"__fb__{gi}", "outputs": outputs})
        for u in mem:
            gid_of[u] = gi

    # condensation topo sort (groups contracted to one node each)
    def node_of(u: str):
        return ("g", gid_of[u]) if u in gid_of else ("b", u)

    nodes: list[tuple[str, Any]] = []
    seen_nodes: set = set()
    for b in order:
        nd = node_of(b.unique_name)
        if nd not in seen_nodes:
            seen_nodes.add(nd)
            nodes.append(nd)
    indeg = {nd: 0 for nd in nodes}
    succ: dict[Any, list[Any]] = {nd: [] for nd in nodes}
    for e in flat.edges:
        if e.feedback:
            continue
        a, b_ = node_of(e.src.unique_name), node_of(e.dst.unique_name)
        if a != b_:
            succ[a].append(b_)
            indeg[b_] += 1
    ready = [nd for nd in nodes if indeg[nd] == 0]
    plan_nodes: list[Any] = []
    while ready:
        nd = ready.pop(0)
        plan_nodes.append(nd)
        for m in succ[nd]:
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
    if len(plan_nodes) != len(nodes):
        raise GrError("feedback loop groups form a cycle among themselves; "
                      "restructure the graph")
    exec_plan: list[Any] = []
    for kind, v in plan_nodes:
        exec_plan.append(groups[v] if kind == "g" else by_uname[v])
    return exec_plan, groups


def _shape(channels: int, n: int) -> tuple[int, ...]:
    return (n,) if channels == 0 else (channels, n)


def _feed_dtype(block: Block, port: str) -> np.dtype:
    d = block.out_dtype(port, {})
    return np.dtype(canonical_dtype(d)) if d is not None else np.dtype(np.float32)


def _consume_domains(graph: Graph) -> None:
    """Edge ComputeDomain consumption (≈ reference per-edge domain consumed at
    buffer binding, BlockModel.hpp:89-97): a ``host`` domain forces the dst
    block's inputs through the host each step (HOST_TAP delivery); ``gpu`` is
    the graph's device and needs nothing; ``tpu`` and ``fpga`` are refused."""
    from .compute_domain import DomainKind
    for e in graph.edges:
        if e.domain is None:
            continue
        if e.domain.kind in (DomainKind.TPU, DomainKind.FPGA):
            raise GrError(f"edge {e} requests compute domain "
                          f"{e.domain.kind.value!r}; this package targets "
                          f"gpu (cuda) and host only")
        if e.domain.kind is DomainKind.HOST:
            if not hasattr(e.dst, "consume"):
                raise GrError(
                    f"edge {e} has domain=host but {e.dst.name} has no "
                    f"consume() hook to receive host-side data; use a "
                    f"SinkBlock or a block with HOST_TAP semantics")
            e.dst.HOST_TAP = True


def _mesh_device(mesh: Any, device: torch.device | str | None
                 ) -> torch.device:
    """The mesh's home device, which a ``device`` given beside the mesh must
    equal."""
    from ..parallel.mesh import Mesh, canonical_device
    if not isinstance(mesh, Mesh):
        raise GrError(f"mesh must be a gnuradio4_tpu_torch.parallel.mesh.Mesh "
                      f"(make_mesh); got {type(mesh).__name__}")
    if mesh.process_count > 1 and set(mesh.axis_names) != {"sp"}:
        raise GrError("multi-host scheduling currently requires a mesh "
                      "with exactly the 'sp' (time) axis spanning all "
                      "processes")
    home = mesh.home
    if device is not None and canonical_device(device) != home:
        raise GrError(f"device={device} conflicts with the mesh, whose first "
                      f"device {home} is where the graph runs")
    return home


def compile_graph(graph: Graph, *, block_len: int = 1 << 16,
                  sample_rate: float = 1.0, batch_steps: int = 1,
                  device: torch.device | str | None = None,
                  mesh: Any = None) -> CompiledGraph:
    """Flatten nested graphs, validate, solve rates/dtypes/channels, run the
    rotation-absorption pass, and bind the graph to ``device`` (default:
    :func:`default_device`). ``CompiledGraph.graph`` is the flattened graph.

    ``mesh`` (``parallel.mesh.Mesh``): the graph runs on the mesh's first
    device (a different ``device`` raises). An ``sp`` axis time-shards the
    WHOLE graph: every stream value becomes a list of local time shards,
    one per device along ``sp``, and each block lowers by its sp protocol
    (``Block.apply_sp``: per shard, a left-neighbour halo, or a gather
    island; ``compiled.sp_plan`` says which); feedback loop groups run once
    on the home device over their gathered inputs; sinks receive their
    inputs joined on the home device. A mesh that spans processes
    (``parallel.multihost.global_mesh``) has exactly the ``sp`` axis; each
    process runs its own shards, and its sinks receive its time slice
    (``_substep_sp``). A ``chan`` axis records each
    multi-channel output's ``out_sharding`` spec in ``compiled.out_specs``
    and leaves the values whole on the home device."""
    if mesh is not None:
        device = _mesh_device(mesh, device)
    device = default_device() if device is None else torch.device(device)
    graph = graph.flatten()
    graph.validate()
    _consume_domains(graph)
    order = graph.topological_order()
    axis_names = tuple(getattr(mesh, "axis_names", ()))
    sp = int(mesh.shape["sp"]) if "sp" in axis_names else 1
    in_len, out_len = graph.resolve_rates(block_len, sample_rate, shard=sp)

    # per-edge dtype/channel resolution (compile-time type inference over the DAG)
    in_edges: dict[str, list[Edge]] = {b.unique_name: [] for b in graph.blocks}
    for e in graph.edges:
        in_edges[e.dst.unique_name].append(e)

    block_ctx: dict[str, BlockCtx] = {}
    out_channels: dict[tuple[str, str], int] = {}
    out_dtypes: dict[tuple[str, str], Any] = {}
    for b in order:
        # back-edges resolve afterwards, from their src's outputs
        ins = [e for e in in_edges[b.unique_name] if not e.feedback]
        in_ch = {e.dst_port: out_channels[(e.src.unique_name, e.src_port)] for e in ins}
        in_dt = {e.dst_port: out_dtypes[(e.src.unique_name, e.src_port)] for e in ins}
        # input-side sample rate = the producing edges' resolved rate
        rate_b = max((e.sample_rate for e in ins), default=sample_rate)
        ch_map: dict[str, int] = dict(in_ch)
        dt_map = dict(in_dt)
        for p in b.out_ports:
            ch = b.out_channels(p.name, in_ch)
            dt = canonical_dtype(b.out_dtype(p.name, in_dt))
            out_channels[(b.unique_name, p.name)] = ch
            out_dtypes[(b.unique_name, p.name)] = dt
            ch_map[p.name] = ch
            dt_map[p.name] = dt
        n_in = in_len[b.unique_name]
        n_out = out_len[b.unique_name]
        block_ctx[b.unique_name] = BlockCtx(
            in_len={p.name: n_in for p in b.in_ports},
            out_len={p.name: n_out for p in b.out_ports},
            sample_rate=rate_b, params={}, channels=ch_map, dtypes=dt_map,
            device=device)
    for e in graph.edges:
        e.channels = out_channels[(e.src.unique_name, e.src_port)]
        e.dtype = out_dtypes[(e.src.unique_name, e.src_port)]
        # resolved-dtype check against declared input port types (≈ Graph.hpp:493)
        for p in e.dst.in_ports:
            if p.name == e.dst_port and p.dtype is not None \
                    and np.dtype(p.dtype) != np.dtype(e.dtype):
                raise GrError(
                    f"dtype mismatch on {e}: {e.src.name}.{e.src_port} produces "
                    f"{np.dtype(e.dtype).name}, {e.dst.name}.{e.dst_port} expects "
                    f"{np.dtype(p.dtype).name}")

    # -- rotation absorption (graph-level algebraic pass) ---------------------
    # A frequency-translating producer's output de-rotation y·e^{-jωm} is a
    # full-rate elementwise pass. Consumers that are invariant to (FFT
    # magnitude views: a linear phase ramp folds into a COMPLEX window, the
    # per-frame unit phasor cancels in |·|) or can correct for (quadrature
    # demod: a constant offset) a residual linear phase absorb it instead, and
    # the producer skips the NCO entirely. GR4TPU_NO_ROTATION_ABSORB=1 turns
    # the pass off, the same switch the JAX package reads.
    for b in order:
        b._rotation_absorbed = False                  # reset stale flags
        if hasattr(b, "_absorbed_rotation"):
            b._absorbed_rotation = {}
    if os.environ.get("GR4TPU_NO_ROTATION_ABSORB") != "1":
        for b in order:
            fn = getattr(b, "rotation_descriptor", None)
            if fn is None:
                continue
            desc = fn(block_ctx[b.unique_name].sample_rate)
            if desc is None:
                continue
            outs = [e for e in graph.edges if e.src is b]
            if any(e.feedback for e in outs):
                continue
            if outs and all(getattr(e.dst, "absorb_rotation", None) is not None
                            and e.dst.absorb_rotation(desc, e.dst_port)
                            for e in outs):
                b._rotation_absorbed = True
                for e in outs:
                    if not getattr(e.dst, "_absorbed_rotation", None):
                        e.dst._absorbed_rotation = {}
                    e.dst._absorbed_rotation[e.dst_port] = desc

    fed_blocks = [b for b in order if getattr(b, "FEED", False)]
    # sinks: terminal blocks + HOST_TAP blocks (mid-graph blocks whose inputs
    # must reach the host each step)
    sink_names = [b.unique_name for b in order
                  if isinstance(b, SinkBlock) or not b.out_ports
                  or getattr(b, "HOST_TAP", False)]
    fed_names = {b.unique_name for b in fed_blocks}
    fb_edges = [e for e in graph.edges if e.feedback]
    exec_plan: list[Any] = list(order)
    loop_groups: list[dict] = []
    if fb_edges:
        exec_plan, loop_groups = _plan_feedback(
            graph, order, fb_edges, in_len, sink_names, fed_names)
    batch_steps = int(batch_steps)
    if batch_steps < 1:
        raise GrError(f"batch_steps must be >= 1, got {batch_steps}")
    out_specs: dict[tuple[str, str], Any] = {}
    if mesh is not None and (sp == 1 or "chan" in axis_names):
        for b in order:
            for p in b.out_ports:
                spec = b.out_sharding(
                    p.name, mesh, out_channels[(b.unique_name, p.name)])
                if spec is not None:
                    out_specs[(b.unique_name, p.name)] = spec
    sp_axis, sp_local_ctx, sp_plan, sp_halos = None, {}, {}, {}
    if sp > 1:
        sp_axis = mesh.shard_axis("sp")
        for b in order:
            uname = b.unique_name
            c = block_ctx[uname]
            sp_local_ctx[uname] = [dataclasses.replace(
                c, in_len={k: v // sp for k, v in c.in_len.items()},
                out_len={k: v // sp for k, v in c.out_len.items()},
                device=d) for d in sp_axis.devices]
            if type(b).apply_sp is not Block.apply_sp:
                sp_plan[uname] = "custom"
            else:
                h = sp_halos[uname] = b.sp_halo(c)
                sp_plan[uname] = "local" if h == 0 else \
                    "island" if h is None else "halo"
        for g in loop_groups:
            for uname in g["members"]:
                sp_plan[uname] = "island"
    return CompiledGraph(
        graph=graph, order=order, in_len=in_len, out_len=out_len,
        block_ctx=block_ctx, in_edges=in_edges, fed_blocks=fed_blocks,
        sink_names=sink_names,
        sample_rate=sample_rate,
        block_len=in_len[order[0].unique_name] if order else block_len,
        device=device, batch_steps=batch_steps,
        statics={b.unique_name: b.settings.static_params() for b in order},
        exec_plan=exec_plan, loop_groups=loop_groups,
        fb_init_states={g["state_key"]: _fb_init_values(
            g, out_channels, out_dtypes, device) for g in loop_groups},
        mesh=mesh, sp_axis=sp_axis, sp_local_ctx=sp_local_ctx,
        sp_plan=sp_plan, sp_halos=sp_halos, out_specs=out_specs)
