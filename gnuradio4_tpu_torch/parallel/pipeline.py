"""Pipeline parallelism (PP): stage-per-device streaming.

≈ the reference's job-list partitioning — blocks of one flowgraph split across
worker threads with ring buffers between them (Scheduler.hpp:79-86, :1519) —
re-expressed as *device placement*: the flowgraph is cut into stages, each
stage compiled onto its own device; time blocks stream through the chain,
and CUDA's asynchronous launches overlap stage k's block i with stage k+1's
block i−1 where the stages sit on different cards. Inter-stage transfers are
device-to-device copies (``.to(device)``), the analog of the inter-worker
rings. Stages may share a device (then they run one after another there).

Use when a graph has serial segments that don't shard well along time/channel
axes; compose with sp inside stages for the full mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..core.block import Block, Port, SinkBlock, SourceBlock
from ..core.compiler import compile_graph
from ..core.errors import GrError
from ..core.graph import Graph


class _StageIn(SourceBlock):
    """Boundary source: the pipeline feeds its output directly."""

    FEED = True
    OUT = (Port("out"),)

    def __init__(self, dtype, channels: int, name=None):
        super().__init__(name=name)
        self._dtype = np.dtype(dtype)
        self._channels = channels

    def out_dtype(self, port, in_dtypes):
        return self._dtype

    def out_channels(self, port, in_channels):
        return self._channels

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


class _StageTap(SinkBlock):
    """Boundary sink: its input surfaces in the step's sink inputs as a
    device tensor."""

    IN = (Port("in"),)


@dataclasses.dataclass
class _Stage:
    graph: Graph
    device: torch.device
    compiled: Any
    states: Any
    params: Any
    in_name: str | None    # unique_name of the _StageIn (None for source stages)
    tap_name: str | None   # unique_name of the _StageTap (None for sink stages)


class StagePipeline:
    """Chain of subgraphs with exported 'in'/'out' ports, one device per stage.

    Stage 0 may self-source (no exported input); the last stage may sink
    internally (no exported output). :meth:`push` advances one time block and
    returns the final stage's output tensor (or None). ``devices`` defaults to
    every visible CUDA device; devices may repeat.
    """

    def __init__(self, stages: Sequence[Graph], *, block_len: int,
                 sample_rate: float = 1.0, boundary_dtype=np.complex64,
                 boundary_channels: int = 0,
                 devices: Sequence[Any] | None = None):
        if devices is None:
            n_cuda = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            devices = [torch.device("cuda", i) for i in range(n_cuda)]
        devices = [torch.device(d) for d in devices]
        if len(devices) < len(stages):
            raise GrError(f"need {len(stages)} devices, have {len(devices)}")
        self.stages: list[_Stage] = []
        n = block_len
        rate = sample_rate
        dtype = boundary_dtype
        channels = boundary_channels
        for i, g in enumerate(stages):
            wrap = Graph(name=f"stage{i}")
            wrap.add(g)
            in_name = tap_name = None
            if g._exports_in:
                pub = next(iter(g._exports_in))
                sin = _StageIn(dtype, channels, name=f"stage{i}.in")
                wrap.connect(sin, g[pub])
                in_name = sin.unique_name
            if g._exports_out:
                pub = next(iter(g._exports_out))
                tap = _StageTap(name=f"stage{i}.out")
                wrap.connect(g[pub], tap)
                tap_name = tap.unique_name
            compiled = compile_graph(wrap, block_len=n, sample_rate=rate,
                                     device=devices[i])
            if tap_name is not None:
                tap_block = next(b for b in compiled.order
                                 if b.unique_name == tap_name)
                n = compiled.in_len[tap_name]
                e = next(e for e in compiled.graph.edges if e.dst is tap_block)
                dtype = e.dtype
                channels = e.channels
                rate = e.sample_rate
            self.stages.append(_Stage(
                graph=wrap, device=devices[i], compiled=compiled,
                states=compiled.init_states(),
                params=compiled.gather_params(),
                in_name=in_name, tap_name=tap_name))
        self.latency = len(self.stages) - 1

    @classmethod
    def from_graph(cls, graph: Graph, *, block_len: int,
                   sample_rate: float = 1.0,
                   devices: Sequence[Any] | None = None) -> "StagePipeline":
        """Cut one flowgraph into pipeline stages at edges annotated with a GPU
        ComputeDomain (``Graph.connect(..., domain="gpu:cuda:<stage>")``; the
        JAX package cuts at ``tpu:xla:<stage>``): the edge's
        ``device_index`` names the stage its *dst* block (and everything
        downstream) runs on. This is the reference's per-edge ComputeDomain
        (BlockModel.hpp:89-97) consumed as actual device placement.
        """
        from ..core.compute_domain import DomainKind
        flat = graph.flatten()
        order = flat.topological_order()
        in_edges: dict[Block, list] = {b: [] for b in flat.blocks}
        for e in flat.edges:
            in_edges[e.dst].append(e)
        stage_of: dict[Block, int] = {}
        for b in order:
            s = 0
            for e in in_edges[b]:
                s = max(s, stage_of[e.src])
                if e.domain is not None and e.domain.kind is DomainKind.GPU \
                        and e.domain.device_index > 0:
                    s = max(s, e.domain.device_index)
            stage_of[b] = s
        n_stages = max(stage_of.values(), default=0) + 1
        # boundary edges: src and dst on different stages
        cuts = [e for e in flat.edges if stage_of[e.src] != stage_of[e.dst]]
        for e in cuts:
            if stage_of[e.dst] != stage_of[e.src] + 1:
                raise GrError(f"edge {e} skips from stage {stage_of[e.src]} to "
                              f"{stage_of[e.dst]}; stages must be consecutive")
        by_stage: dict[int, list] = {}
        for e in cuts:
            by_stage.setdefault(stage_of[e.src], []).append(e)
        for k, es in by_stage.items():
            if len(es) != 1:
                raise GrError(f"stage {k} has {len(es)} boundary edges; "
                              f"pipeline stages need exactly one")
        stages: list[Graph] = []
        for k in range(n_stages):
            sg = Graph(name=f"{graph.name}.stage{k}")
            for b in order:
                if stage_of[b] == k:
                    sg.add(b)
            for e in flat.edges:
                if stage_of[e.src] == k and stage_of[e.dst] == k:
                    sg.edges.append(e)
            if k > 0:
                e = by_stage[k - 1][0]
                sg.export_in("in", e.dst, e.dst_port)
            if k < n_stages - 1:
                e = by_stage[k][0]
                sg.export_out("out", e.src, e.src_port)
            else:
                # final stage: surface a dangling terminal output (if exactly
                # one) so push() returns the pipeline's product
                consumed = {(e.src.unique_name, e.src_port) for e in flat.edges}
                dangling = [(b, p.name) for b in sg.blocks for p in b.out_ports
                            if (b.unique_name, p.name) not in consumed]
                if len(dangling) == 1:
                    sg.export_out("out", *dangling[0])
            stages.append(sg)
        return cls(stages, block_len=block_len, sample_rate=sample_rate,
                   devices=devices)

    def push(self, block: Any | None = None) -> torch.Tensor | None:
        """Advance every stage by one time block. ``block``: the first
        stage's input (a tensor or NumPy array; None for a self-sourcing
        first stage). Returns the last stage's tap output (a tensor on its
        stage's device)."""
        value = block
        for st in self.stages:
            feeds = {}
            if st.in_name is not None:
                if value is None:
                    raise GrError(f"{st.graph.name} expects an input block")
                if not torch.is_tensor(value):
                    value = torch.from_numpy(np.ascontiguousarray(value))
                feeds = {st.in_name: {"out": value.to(st.device)}}
            st.states, sink_ins = st.compiled.step(st.states, st.params, feeds)
            value = None
            if st.tap_name is not None:
                value = sink_ins[st.tap_name]["in"]
        return value

    def run(self, blocks) -> list[Any]:
        """Push a sequence of blocks; returns the outputs (aligned — the caller
        accounts for pipeline fill latency if stages buffer internally)."""
        return [self.push(b) for b in blocks]
