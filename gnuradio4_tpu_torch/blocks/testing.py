"""Deterministic test/instrumentation blocks (≈ reference blocks/testing/:
NullSource/NullSink, ConstantSource, CountingSource, CountingSink, Copy,
HeadBlock, VectorSource/VectorSink, TagSource/TagSink/TagMonitor, Delay,
SettingsChangeRecorder, SlowSource, SimCompute, PerformanceMonitor,
ArraySource/ArraySink — NullSources.hpp, TagMonitors.hpp, Delay.hpp,
PerformanceMonitor.hpp, CollectionTestBlocks.hpp). They drive the
golden-value tests: deterministic sources → block under test → capturing
sinks."""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..core.block import Block, Port, SinkBlock, SourceBlock
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.stream import canonical_dtype, torch_dtype
from ..core.tags import Tag


def _shape(ctx) -> tuple[int, ...]:
    n, ch = ctx.out_len["out"], ctx.channels["out"]
    return (n,) if ch == 0 else (ch, n)


@register_block("NullSource")
class NullSource(SourceBlock):
    """Zeros forever (≈ NullSource, NullSources.hpp)."""

    OUT = (Port("out"),)
    dtype = Setting(default="float32", kind="static", description="sample dtype")
    channels = Setting(default=0, kind="static", description="0 → 1-D stream")

    def out_channels(self, port, in_channels):
        return int(self.settings.get("channels"))

    def out_dtype(self, port, in_dtypes):
        return self.settings.get("dtype")

    def apply(self, state, ins, ctx):
        return state, {"out": torch.zeros(
            _shape(ctx), dtype=torch_dtype(self.settings.get("dtype")),
            device=ctx.device)}


@register_block("ConstantSource")
class ConstantSource(SourceBlock):
    OUT = (Port("out"),)
    value = Setting(default=1.0, description="constant sample value")
    dtype = Setting(default="float32", kind="static")
    channels = Setting(default=0, kind="static")
    n_samples = Setting(default=0, kind="static",
                        description="stop after N samples (0 = unbounded)")

    def out_channels(self, port, in_channels):
        return int(self.settings.get("channels"))

    def out_dtype(self, port, in_dtypes):
        return self.settings.get("dtype")

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def apply(self, state, ins, ctx):
        dt = canonical_dtype(self.settings.get("dtype"))
        v = np.asarray(ctx.p("value", 1.0)).astype(dt)
        return state, {"out": torch.full(_shape(ctx), v.item(),
                                         dtype=torch_dtype(dt), device=ctx.device)}


@register_block("CountingSource")
class CountingSource(SourceBlock):
    """0,1,2,… ramp (≈ CountingSource). The state is the step counter, a 0-d
    int64 host tensor holding the JAX package's uint32 counter; the ramp is
    computed in float32 as there (``start + (iota + f32(steps·n))·step``)."""

    OUT = (Port("out"),)
    dtype = Setting(default="float32", kind="static")
    n_samples = Setting(default=0, kind="static", description="0 = unbounded")
    start = Setting(default=0.0, description="first value")
    step = Setting(default=1.0, description="increment per sample")

    def out_dtype(self, port, in_dtypes):
        return self.settings.get("dtype")

    def init_state(self, ctx):
        return torch.zeros((), dtype=torch.int64)

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        base = np.float32(int(state)) * np.float32(n)
        idx = torch.arange(n, dtype=torch.float32, device=ctx.device) + float(base)
        out = (float(np.float32(ctx.p("start", 0.0)))
               + idx * float(np.float32(ctx.p("step", 1.0))))
        nxt = torch.tensor((int(state) + 1) & 0xFFFFFFFF, dtype=torch.int64)
        return nxt, {"out": out.to(torch_dtype(self.settings.get("dtype")))}


@register_block("VectorSource")
class VectorSource(SourceBlock):
    """Plays back a host array once (or repeated); ≈ VectorSource qa helper.

    Host-fed by default: the scheduler takes each step's slice from
    ``host_feed`` and the block passes it through. ``device_resident=True``
    uploads the array ONCE (into the block's state) and slices it on the
    device each step — no per-step host→device feed. EOS/partial-final-step
    semantics and tags are the same on both paths."""

    OUT = (Port("out"),)
    FEED = True
    repeat = Setting(default=False, kind="static")
    device_resident = Setting(default=False, kind="static",
                              description="upload the array once; per-step "
                                          "on-device slice instead of host "
                                          "feeds")

    def __init__(self, data: Any = (), name: str | None = None, tags: list[Tag] = (),
                 **settings: Any):
        super().__init__(name=name, **settings)
        self.data = np.asarray(data)
        self.tags = list(tags)
        if self.settings.get("device_resident"):
            self.FEED = False          # instance attr shadows the class flag

    def out_channels(self, port, in_channels):
        return 0 if self.data.ndim <= 1 else self.data.shape[0]

    def out_dtype(self, port, in_dtypes):
        return self.data.dtype

    def host_feed(self, n, abs_index):
        total = self.data.shape[-1]
        if self.settings.get("repeat"):
            idx = (np.arange(abs_index, abs_index + n) % total)
            return {"out": self.data[..., idx]}, n
        if abs_index >= total:
            return None
        chunk = self.data[..., abs_index:abs_index + n]
        return {"out": chunk}, chunk.shape[-1]

    def host_done(self, abs_out, n):
        # EOS for the device-resident path (the FEED path signals EOS by
        # returning None from host_feed instead)
        if not self.settings.get("device_resident") \
                or self.settings.get("repeat"):
            return None
        total = self.data.shape[-1]
        if abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def init_state(self, ctx):
        if not self.settings.get("device_resident"):
            return None
        payload = self.data
        if not self.settings.get("repeat"):
            # zero-pad up to a whole block so the final partial step's valid
            # prefix stays aligned; the scheduler's n_valid masks the tail
            n = ctx.out_len["out"]
            pad = (-self.data.shape[-1]) % n
            payload = np.pad(self.data,
                             [(0, 0)] * (self.data.ndim - 1) + [(0, pad)])
        # the read position is a host int: slicing needs no device read
        return {"idx": torch.zeros((), dtype=torch.int64),
                "data": torch.from_numpy(np.ascontiguousarray(payload)).to(
                    torch_dtype(payload.dtype)).to(ctx.device)}

    def emit_tags(self, ctx):
        lo, hi = ctx.abs_index, ctx.abs_index + next(iter(ctx.out_len.values()), 0)
        return [t.shifted(-lo) for t in self.tags if lo <= t.index < hi]

    def apply(self, state, ins, ctx):
        if not self.settings.get("device_resident"):
            return state, {"out": ins["out"]}
        n = ctx.out_len["out"]
        idx, data = int(state["idx"]), state["data"]
        total = self.data.shape[-1]
        if self.settings.get("repeat"):
            take = (torch.arange(n, device=data.device) + idx) % total
            out = data.index_select(-1, take)
            nxt = (idx + n) % total
        else:
            # past the end (the steps after EOS) the window clamps to the
            # last block, as the JAX package's dynamic_slice does: the
            # scheduler marks those samples invalid
            start = min(idx, data.shape[-1] - n)
            out = data[..., start:start + n]
            nxt = idx + n
        return {"idx": torch.tensor(nxt, dtype=torch.int64), "data": data}, \
            {"out": out}


@register_block("VectorSink")
class VectorSink(SinkBlock):
    """Captures everything on the host (list → np.concatenate), with the tags
    it received at absolute indices."""

    IN = (Port("in"),)

    def __init__(self, name: str | None = None, **settings):
        super().__init__(name=name, **settings)
        self._chunks: list[np.ndarray] = []
        self.tags: list[Tag] = []
        self._n = 0

    def consume(self, arrays, tags, n_valid, abs_index):
        a = arrays["in"][..., :n_valid]
        if n_valid:
            self._chunks.append(a)
        for t in tags.get("in", []):
            if t.index <= n_valid:  # keep in-range tags incl. EOS at the boundary
                self.tags.append(t.shifted(abs_index))
        self._n += n_valid

    def data(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0)
        return np.concatenate(self._chunks, axis=-1)

    def clear(self):
        self._chunks.clear()
        self.tags.clear()
        self._n = 0


@register_block("NullSink")
class NullSink(SinkBlock):
    IN = (Port("in"),)
    WANTS_HOST_DATA = False  # count only — no device→host copy
    CONSUME_IGNORES_DATA = True  # counters never read array contents

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.count = 0

    def consume(self, arrays, tags, n_valid, abs_index):
        self.count += n_valid


@register_block("CountingSink")
class CountingSink(NullSink):
    """Counts valid samples (≈ CountingSink)."""


@register_block("Copy")
class Copy(Block):
    """Identity (≈ Copy block)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"]}


@register_block("HeadBlock")
class HeadBlock(Block):
    """Pass the first N samples, then end the stream (≈ HeadBlock): the runtime
    clamps valid counts mid-graph and winds the graph down once exhausted."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    n_samples = Setting(default=1024, kind="static")
    terminate_graph_when_done = True

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"]}

    def clamp_valid(self, n_valid_out, abs_out):
        total = int(self.settings.get("n_samples"))
        return max(0, min(n_valid_out, total - abs_out))


@register_block("Delay")
class Delay(Block):
    """Integer-sample delay (≈ Delay.hpp): carries the last D samples as state."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    delay = Setting(default=0, kind="static", limits=(0, 2 ** 31),
                    description="delay in samples")

    def init_state(self, ctx):
        d = int(self.settings.get("delay"))
        ch = ctx.channels.get("in", 0)
        shape = (d,) if ch == 0 else (ch, d)
        return torch.zeros(shape, dtype=torch_dtype(ctx.dtype("in")),
                           device=ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"]
        d = int(self.settings.get("delay"))
        if d == 0:
            return state, {"out": x}
        xc = torch.cat([state.to(x.dtype), x], dim=-1)
        return xc[..., -d:].clone(), {"out": xc[..., :x.shape[-1]]}

    def process_tags(self, in_tags, ctx):
        d = int(self.settings.get("delay"))
        out = {}
        for p, tags in in_tags.items():
            out["out"] = [t.shifted(d) for t in tags]
        return out


@register_block("TagSource")
class TagSource(SourceBlock):
    """Emits a constant stream + user-scheduled tags at absolute indices
    (≈ TagSource, TagMonitors.hpp)."""

    OUT = (Port("out"),)
    value = Setting(default=0.0)
    n_samples = Setting(default=0, kind="static")

    def __init__(self, tags: list[Tag] = (), name=None, **settings):
        super().__init__(name=name, **settings)
        self.scheduled = sorted(tags)

    def host_done(self, abs_out, n):
        total = int(self.settings.get("n_samples"))
        if total and abs_out + n >= total:
            return max(0, total - abs_out)
        return None

    def emit_tags(self, ctx):
        n = next(iter(ctx.out_len.values()), 0)
        lo, hi = ctx.abs_index, ctx.abs_index + n
        return [t.shifted(-lo) for t in self.scheduled if lo <= t.index < hi]

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        v = float(np.float32(ctx.p("value", 0.0)))
        return state, {"out": torch.full((n,), v, dtype=torch.float32,
                                         device=ctx.device)}


@register_block("TagSink")
class TagSink(VectorSink):
    """VectorSink that is primarily inspected for received tags (≈ TagSink)."""


@register_block("TagMonitor")
class TagMonitor(Block):
    """Pass-through recording tags it sees (≈ TagMonitor)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.observed: list[Tag] = []

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"]}

    def process_tags(self, in_tags, ctx):
        for t in in_tags.get("in", []):
            self.observed.append(t.shifted(ctx.abs_index))
        return {"out": list(in_tags.get("in", []))}


@register_block("SettingsChangeRecorder")
class SettingsChangeRecorder(Block):
    """Pass-through that scales by ``scaling_factor`` and records every applied
    settings change (≈ reference SettingsChangeRecorder test block) — used to
    assert staged→applied timing, tag auto-update, and context switches.

    ``recorded`` holds ``(step, {key: new_value})`` in apply order.
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    scaling_factor = Setting(default=1.0, kind="dynamic")
    context = Setting(default="", kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.recorded: list[tuple[int | None, dict]] = []
        self._step = 0

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"] * float(ctx.params["scaling_factor"])}

    def on_settings_applied(self, res) -> None:
        if res.applied:
            self.recorded.append((self._step, dict(res.applied)))

    def process_tags(self, in_tags, ctx):
        self._step = ctx.step
        return super().process_tags(in_tags, ctx)


@register_block("SlowSource")
class SlowSource(ConstantSource):
    """Wall-clock-throttled source (≈ SlowSource, NullSources.hpp): sleeps
    ``delay_s`` per feed step to simulate a slow producer."""

    delay_s = Setting(default=0.01, limits=(0.0, 10.0))

    def host_done(self, abs_out, n):
        time.sleep(float(self.settings.get("delay_s")))
        return super().host_done(abs_out, n)


@register_block("SimCompute")
class SimCompute(Block):
    """Simulated compute load: N fused multiply-adds per sample (≈ SimCompute with
    target_throughput; here the knob is explicit ops/sample)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    ops_per_sample = Setting(default=64, kind="static", limits=(1, 1 << 20))

    def apply(self, state, ins, ctx):
        y = ins["in"]
        for _ in range(int(self.settings.get("ops_per_sample"))):
            y = y * 1.0000001 + 1e-9
        return state, {"out": y}


@register_block("PerformanceMonitor")
class PerformanceMonitor(SinkBlock):
    """Measures delivered samples/s at its input (≈ PerformanceMonitor.hpp)."""

    IN = (Port("in"),)
    WANTS_HOST_DATA = False
    CONSUME_IGNORES_DATA = True   # rate metering never reads contents

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.n = 0
        self.t0: float | None = None
        self.t_last: float | None = None

    def consume(self, arrays, tags, n_valid, abs_index):
        now = time.monotonic()
        if self.t0 is None:
            self.t0 = now
        self.t_last = now
        self.n += n_valid

    @property
    def samples_per_second(self) -> float:
        if self.t0 is None or self.t_last is None or self.t_last <= self.t0:
            return 0.0
        return self.n / (self.t_last - self.t0)


@register_block("ArraySource")
class ArraySource(SourceBlock):
    """Multi-port playback source: one host array per output port
    (≈ ArraySource qa helper, CollectionTestBlocks.hpp). All arrays must share
    the trailing (time) length; ports are named out0..outN-1."""

    OUT = ()
    FEED = True
    repeat = Setting(default=False, kind="static")

    def __init__(self, arrays=(), name=None, **settings):
        super().__init__(name=name, **settings)
        self.arrays = [np.asarray(a) for a in arrays]
        if not self.arrays:
            raise GrError("ArraySource needs at least one array")
        if len({a.shape[-1] for a in self.arrays}) != 1:
            raise GrError("ArraySource arrays must share the time length")
        self.out_ports = tuple(Port(f"out{i}") for i in range(len(self.arrays)))

    def out_dtype(self, port, in_dtypes):
        return self.arrays[int(port[3:])].dtype

    def out_channels(self, port, in_channels):
        a = self.arrays[int(port[3:])]
        return 0 if a.ndim <= 1 else a.shape[0]

    def host_feed(self, n, abs_index):
        total = self.arrays[0].shape[-1]
        if self.settings.get("repeat"):
            idx = (np.arange(abs_index, abs_index + n) % total)
            return {f"out{i}": a[..., idx] for i, a in enumerate(self.arrays)}, n
        if abs_index >= total:
            return None
        out = {f"out{i}": a[..., abs_index:abs_index + n]
               for i, a in enumerate(self.arrays)}
        return out, self.arrays[0][..., abs_index:abs_index + n].shape[-1]

    def apply(self, state, ins, ctx):
        return state, dict(ins)


@register_block("ArraySink")
class ArraySink(SinkBlock):
    """Multi-port collecting sink: captures each input port into its own list
    (≈ ArraySink qa helper). ``data(i)`` returns port i's concatenated stream."""

    IN = ()

    def __init__(self, n_inputs: int = 1, name=None, **settings):
        super().__init__(name=name, **settings)
        self.in_ports = tuple(Port(f"in{i}") for i in range(int(n_inputs)))
        self._chunks: dict[str, list[np.ndarray]] = \
            {p.name: [] for p in self.in_ports}

    def consume(self, arrays, tags, n_valid, abs_index):
        for pname, arr in arrays.items():
            if n_valid > 0:
                self._chunks[pname].append(np.asarray(arr[..., :n_valid]))

    def data(self, port: int = 0) -> np.ndarray:
        chunks = self._chunks[f"in{port}"]
        if not chunks:
            return np.zeros(0)
        return np.concatenate(chunks, axis=-1)
