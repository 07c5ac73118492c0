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
"""

from __future__ import annotations

import dataclasses
import os
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


def _feed_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host-fed array as a tensor of its stream's torch dtype on ``device``
    (uint32 streams travel as int64, as everywhere in this package)."""
    dt = torch_dtype(a.dtype)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype != dt:
        t = t.to(dt)
    return t.to(device)


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
    _params_cache: Any = None
    _zero_feeds_cache: Any = None
    _pump_plan: Any = None
    _tag_plan: Any = None

    def init_states(self) -> dict[str, Any]:
        """Fresh block states, created on the graph's device."""
        return {b.unique_name: b.init_state(self.block_ctx[b.unique_name])
                for b in self.order}

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
        incoming tags they can be skipped wholesale each step."""
        if self._tag_plan is None:
            plan = []
            for b in self.order:
                uname = b.unique_name
                in_keys = [((e.src.unique_name, e.src_port), e.dst_port)
                           for e in self.in_edges[uname]]
                fast = (type(b).emit_tags is Block.emit_tags
                        and type(b).process_tags is Block.process_tags)
                plan.append((b, uname, in_keys, fast, uname in self.sink_names,
                             [p.name for p in b.out_ports],
                             not self.in_edges[uname]))
            self._tag_plan = plan
        return self._tag_plan

    def _substep(self, states, params, feeds):
        values: dict[tuple[str, str], torch.Tensor] = {}
        new_states: dict[str, Any] = {}
        sink_ins: dict[str, dict[str, torch.Tensor]] = {}
        for b in self.order:
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
            try:
                st, outs = b.apply(states.get(uname), ins, ctx)
            except GrError:
                raise
            except Exception as e:
                raise GrError(f"{b.name} ({type(b).__name__}).apply failed: "
                              f"{type(e).__name__}: {e}", block=b.name) from e
            new_states[uname] = st
            for pname, arr in outs.items():
                values[(uname, pname)] = arr
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
        if self.batch_steps == 1:
            return self._substep(states, params, fed)
        per: list[dict[str, dict[str, torch.Tensor]]] = []
        for k in range(self.batch_steps):
            p = params
            if overlays:
                p = dict(params)
                for uname, snaps in overlays.items():
                    p[uname] = {**params.get(uname, {}), **snaps[k]}
            states, sink_ins = self._substep(
                states, p, {u: {q: t[k] for q, t in d.items()}
                            for u, d in fed.items()})
            per.append(sink_ins)
        join = torch.stack if stack else list
        return states, {u: {q: join([s[u][q] for s in per]) for q in per[0][u]}
                        for u in per[0]}


def _shape(channels: int, n: int) -> tuple[int, ...]:
    return (n,) if channels == 0 else (channels, n)


def _feed_dtype(block: Block, port: str) -> np.dtype:
    d = block.out_dtype(port, {})
    return np.dtype(canonical_dtype(d)) if d is not None else np.dtype(np.float32)


def compile_graph(graph: Graph, *, block_len: int = 1 << 16,
                  sample_rate: float = 1.0, batch_steps: int = 1,
                  device: torch.device | str | None = None) -> CompiledGraph:
    """Flatten nested graphs, validate, solve rates/dtypes/channels, run the
    rotation-absorption pass, and bind the graph to ``device`` (default:
    :func:`default_device`). ``CompiledGraph.graph`` is the flattened graph."""
    device = default_device() if device is None else torch.device(device)
    graph = graph.flatten()
    graph.validate()
    loops = [e for e in graph.edges if e.feedback]
    if loops:
        raise GrError(f"feedback loop groups are not ported to this package "
                      f"yet; back-edges {loops} close loops through "
                      f"{sorted({b.name for e in loops for b in (e.src, e.dst)})}")
    order = graph.topological_order()
    in_len, out_len = graph.resolve_rates(block_len, sample_rate)

    # per-edge dtype/channel resolution (compile-time type inference over the DAG)
    in_edges: dict[str, list[Edge]] = {b.unique_name: [] for b in graph.blocks}
    for e in graph.edges:
        in_edges[e.dst.unique_name].append(e)

    block_ctx: dict[str, BlockCtx] = {}
    out_channels: dict[tuple[str, str], int] = {}
    out_dtypes: dict[tuple[str, str], Any] = {}
    for b in order:
        ins = in_edges[b.unique_name]
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
    batch_steps = int(batch_steps)
    if batch_steps < 1:
        raise GrError(f"batch_steps must be >= 1, got {batch_steps}")
    return CompiledGraph(
        graph=graph, order=order, in_len=in_len, out_len=out_len,
        block_ctx=block_ctx, in_edges=in_edges, fed_blocks=fed_blocks,
        sink_names=sink_names,
        sample_rate=sample_rate,
        block_len=in_len[order[0].unique_name] if order else block_len,
        device=device, batch_steps=batch_steps,
        statics={b.unique_name: b.settings.static_params() for b in order})
