"""Graph → step function.

The whole flattened graph becomes one step function

    step(states, params) → (states', sink_inputs)

that runs every block's ``apply`` in topological order on the graph's device.
PyTorch runs it eagerly: each block launches its kernels on the current CUDA
stream, and intermediates stay on the device. Carried block state (FIR tails,
NCO phase — the analog of HistoryBuffer) threads through the step as a dict of
tensors.

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
from .stream import canonical_dtype


def default_device() -> torch.device:
    """``cuda`` when a GPU is present, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@dataclasses.dataclass
class CompiledGraph:
    """A rate-resolved flowgraph bound to a device, ready for the scheduler."""

    graph: Graph                      # flattened
    order: list[Block]
    in_len: dict[str, int]            # block unique_name → input samples/step
    out_len: dict[str, int]
    block_ctx: dict[str, BlockCtx]
    in_edges: dict[str, list[Edge]]
    sink_names: list[str]
    sample_rate: float
    block_len: int
    device: torch.device
    batch_steps: int = 1              # sub-steps per step() call
    _params_cache: Any = None

    def init_states(self) -> dict[str, Any]:
        """Fresh block states, created on the graph's device."""
        return {b.unique_name: b.init_state(self.block_ctx[b.unique_name])
                for b in self.order}

    def gather_params(self) -> dict[str, dict[str, Any]]:
        """Dynamic params (host values) for the next step. Blocks that override
        ``prepare_params`` refresh every step; the rest are cached until
        :meth:`invalidate_params`."""
        if self._params_cache is None:
            self._params_cache = {
                b.unique_name: b.prepare_params(b.settings.dynamic_params())
                for b in self.order}
        else:
            for b in self.order:
                if type(b).prepare_params is not Block.prepare_params:
                    self._params_cache[b.unique_name] = b.prepare_params(
                        b.settings.dynamic_params())
        return self._params_cache

    def invalidate_params(self) -> None:
        self._params_cache = None

    def _substep(self, states, params):
        values: dict[tuple[str, str], torch.Tensor] = {}
        new_states: dict[str, Any] = {}
        sink_ins: dict[str, dict[str, torch.Tensor]] = {}
        for b in self.order:
            uname = b.unique_name
            ctx = dataclasses.replace(self.block_ctx[uname],
                                      params=params.get(uname, {}))
            ins = {e.dst_port: values[(e.src.unique_name, e.src_port)]
                   for e in self.in_edges[uname]}
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

    def step(self, states, params):
        """Run ``batch_steps`` sub-steps. With one sub-step the sink inputs are
        the blocks' tensors; with S > 1 every sink input gains a leading [S]
        axis (the JAX package's batched-step layout)."""
        if self.batch_steps == 1:
            return self._substep(states, params)
        per: list[dict[str, dict[str, torch.Tensor]]] = []
        for _ in range(self.batch_steps):
            states, sink_ins = self._substep(states, params)
            per.append(sink_ins)
        stacked = {u: {p: torch.stack([s[u][p] for s in per])
                       for p in per[0][u]} for u in per[0]}
        return states, stacked


def compile_graph(graph: Graph, *, block_len: int = 1 << 16,
                  sample_rate: float = 1.0, batch_steps: int = 1,
                  device: torch.device | str | None = None) -> CompiledGraph:
    """Flatten nested graphs, validate, solve rates/dtypes/channels, run the
    rotation-absorption pass, and bind the graph to ``device`` (default:
    :func:`default_device`). ``CompiledGraph.graph`` is the flattened graph."""
    device = default_device() if device is None else torch.device(device)
    graph = graph.flatten()
    graph.validate()
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

    sink_names = [b.unique_name for b in order
                  if isinstance(b, SinkBlock) or not b.out_ports]
    batch_steps = int(batch_steps)
    if batch_steps < 1:
        raise GrError(f"batch_steps must be >= 1, got {batch_steps}")
    return CompiledGraph(
        graph=graph, order=order, in_len=in_len, out_len=out_len,
        block_ctx=block_ctx, in_edges=in_edges, sink_names=sink_names,
        sample_rate=sample_rate,
        block_len=in_len[order[0].unique_name] if order else block_len,
        device=device, batch_steps=batch_steps)
