"""Block & port model (≈ reference ``Block<Derived>``, Block.hpp:711).

A block is a Python object carrying

- **port declarations** (:class:`Port`) — typed, named streams;
- **settings** (:class:`~.settings.Settings`) — staged, split into dynamic (host
  parameters of each step) and static (shape the compiled graph);
- a **step function** ``apply(state, ins, ctx) → (state, outs)`` over fixed-shape
  time blocks held in torch tensors on the graph's device (the analog of
  processBulk over spans);
- static **rate descriptors**: ``ratio`` (out/in chunk ratio ≈ ``Resampling``,
  annotated.hpp:122) and ``alignment``, resolved by the graph's rate algebra;
- **host hooks** the scheduler calls between steps: tag forwarding
  (``process_tags``, default policy-based ≈ ``forwardInputTags``,
  Block.hpp:1130), tag emission, sample-accurate tag-driven settings ramps,
  host feeds, mid-graph valid clamps, block-to-block messages and the
  lifecycle callbacks.

States are tensors or dicts of tensors, created by :meth:`Block.init_state` on
the compiled graph's device.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from fractions import Fraction
from typing import Any, ClassVar

import numpy as np
import torch

from .errors import GrError
from .settings import ApplyResult, Setting, Settings
from .stream import StreamSpec, canonical_dtype  # noqa: F401  (StreamSpec: re-export)
from .tags import Tag, TagPropagation, propagate

_instance_counter = itertools.count()


@dataclasses.dataclass(frozen=True)
class Port:
    """Typed named port (≈ reference Port<T, portDirection, ...>, Port.hpp).

    ``dtype=None`` → polymorphic (resolved at compile time from the upstream edge).
    ``optional`` ports may stay unconnected (≈ Optional attribute, Port.hpp:329).
    ``asynchronous`` marks a port that does not gate scheduling (≈ Async,
    Port.hpp:394); here it is read once per step like any other input.
    """

    name: str
    dtype: Any = None
    optional: bool = False
    asynchronous: bool = False

    def __post_init__(self):
        if self.dtype is not None:
            object.__setattr__(self, "dtype", canonical_dtype(self.dtype))


@dataclasses.dataclass
class BlockCtx:
    """Static + dynamic context handed to ``apply``.

    ``in_len``/``out_len`` give the static per-port samples-per-step resolved by the
    rate algebra; ``sample_rate`` is the input-side rate; ``params`` holds the
    block's dynamic settings as host values; ``device`` is where the block's
    tensors live.
    """

    in_len: dict[str, int]
    out_len: dict[str, int]
    sample_rate: float
    params: dict[str, Any]
    channels: dict[str, int] = dataclasses.field(default_factory=dict)
    dtypes: dict[str, Any] = dataclasses.field(default_factory=dict)
    device: torch.device = torch.device("cpu")

    def p(self, key: str, default: Any = None) -> Any:
        """Dynamic param lookup with default."""
        v = self.params.get(key)
        return default if v is None else v

    def dtype(self, port: str, default: Any = None) -> np.dtype:
        d = self.dtypes.get(port)
        if d is None:
            return np.dtype(default if default is not None else np.float32)
        return np.dtype(d)


class UICategory(enum.Enum):
    """Semantic UI placement intent (≈ gr::UICategory, Drawable annotation —
    reference docs/USER_API_Drawable_UI.md). The framework records what a block
    wants to display; a UI application decides how/where to render it."""

    NONE = "None"
    TOOLBAR = "Toolbar"
    MENU = "Menu"
    CONTENT = "ChartPane"
    STATUS_BAR = "StatusBar"


class Block:
    """Base class for all blocks. Subclasses declare ports + settings and implement
    :meth:`apply` (device path)."""

    IN: ClassVar[tuple[Port, ...]] = ()
    OUT: ClassVar[tuple[Port, ...]] = ()
    TAG_POLICY: ClassVar[TagPropagation] = TagPropagation.TPP_ALL_TO_ALL
    _settings_spec: ClassVar[dict[str, Setting]] = {}

    def __init__(self, name: str | None = None, **settings: Any):
        cls = type(self)
        self.unique_name = f"{cls.__name__}#{next(_instance_counter)}"
        self.name = name or self.unique_name
        self.in_ports: tuple[Port, ...] = tuple(cls.IN)
        self.out_ports: tuple[Port, ...] = tuple(cls.OUT)
        self.tag_policy: TagPropagation = cls.TAG_POLICY
        spec = dict(cls._settings_spec)
        self.settings = Settings(spec, init=None)
        unknown = self.settings.set(settings)
        if unknown:
            raise GrError(f"{self.name}: unknown settings {sorted(unknown)}; "
                          f"known: {sorted(spec)}")
        self.settings.apply_staged()
        self.settings.store_defaults()
        self._graph = None  # back-ref set by Graph.add

    # -- rate/overlap descriptors (static; read by the rate algebra) -----------
    @property
    def ratio(self) -> Fraction:
        """Output/input chunk ratio (≈ Resampling<inputChunkSize, outputChunkSize>)."""
        return Fraction(1)

    @property
    def alignment(self) -> int:
        """Input block length must be a multiple of this (e.g. FFT size)."""
        return 1

    def out_channels(self, port: str, in_channels: dict[str, int]) -> int:
        """Channel count produced on ``port``; default: the first input's (0 ⇒ 1-D)."""
        if in_channels:
            return next(iter(in_channels.values()))
        return 0

    def out_dtype(self, port: str, in_dtypes: dict[str, Any]) -> Any:
        """Output dtype on ``port``; default: declared port dtype, else first input's."""
        for p in self.out_ports:
            if p.name == port and p.dtype is not None:
                return p.dtype
        if in_dtypes:
            return next(iter(in_dtypes.values()))
        return np.float32

    # -- device path -----------------------------------------------------------
    def init_state(self, ctx: BlockCtx) -> Any:
        """Carried state (≈ HistoryBuffer FIR tails, NCO phase…). Default none."""
        return None

    def apply(self, state: Any, ins: dict[str, torch.Tensor], ctx: BlockCtx
              ) -> tuple[Any, dict[str, torch.Tensor]]:
        """One step over one time block, on the tensors' device."""
        raise NotImplementedError(f"{type(self).__name__}.apply")

    def out_sharding(self, port: str, mesh: Any, channels: int):
        """PartitionSpec for this output under a mesh, or None.

        Default policy: shard the channel axis over a mesh axis named 'chan'
        when it divides evenly; 1-D streams stay unsharded (time sharding is
        the ``sp`` path). The compiler records the spec
        (``CompiledGraph.out_specs``); the values stay whole on the mesh's
        home device."""
        if mesh is None or channels == 0:
            return None
        if "chan" in getattr(mesh, "axis_names", ()) and \
                channels % mesh.shape["chan"] == 0:
            from ..parallel.mesh import PartitionSpec
            return PartitionSpec("chan", None)
        return None

    # -- sp (time-axis) sharding protocol --------------------------------------
    # Under a mesh with an 'sp' axis every stream value is a list of local
    # time shards [..., T/sp], one per shard device, and each block declares
    # how it lowers:
    #
    #   sp_halo(ctx) == 0     time-local (stateless elementwise/FFT) — apply
    #                         per shard unchanged;
    #   sp_halo(ctx) == h>0   overlap-save: each shard needs the last h input
    #                         samples of its LEFT neighbour (parallel/halo.py
    #                         halo_left; ≈ HistoryBuffer prehistory, core
    #                         HistoryBuffer.hpp:68);
    #   sp_halo(ctx) is None  not time-shardable (sequential scan state etc.)
    #                         — a gather island: the shards joined on the
    #                         mesh's home device, the full block run once
    #                         there, its outputs split again.
    #
    # Blocks with h>0 map between their carried state and a raw input tail
    # via sp_state_to_tail / sp_tail_to_state. Blocks with bespoke needs
    # (position-dependent NCOs) override apply_sp.

    def sp_halo(self, ctx: BlockCtx):
        """Left-halo length in input samples under time sharding (see above).
        The compiler asks once per compile (``CompiledGraph.sp_halos``)."""
        return 0 if self.init_state(ctx) is None else None

    def sp_state_to_tail(self, state: Any, ctx: BlockCtx) -> torch.Tensor:
        """Carried state → input-tail tensor [..., sp_halo] (shard 0's halo)."""
        return state

    def sp_tail_to_state(self, tail: torch.Tensor, state: Any, ctx: BlockCtx
                         ) -> Any:
        """Input tail [..., sp_halo] (+ previous state for non-tail parts) →
        carried state."""
        dt = getattr(state, "dtype", None)
        return tail if dt is None else tail.to(dt)

    def apply_sp(self, state: Any, ins: list[dict[str, torch.Tensor]],
                 ctx: BlockCtx, local_ctx: list[BlockCtx], axis: Any
                 ) -> tuple[Any, list[dict[str, torch.Tensor]]]:
        """Apply under time sharding.

        ``ins`` holds one input dict per shard (local time shards on the
        shard's device); ``local_ctx`` one context per shard (per-shard
        lengths and device); ``axis`` the ``parallel.collectives.ShardAxis``.
        Returns ``(new_state, outs)``: ONE new state (the state the unsharded
        block would carry on; it lives on the mesh's home device) and one
        output dict per shard. The default lowers via :meth:`sp_halo`."""
        return self.lower_sp(self.sp_halo(ctx), state, ins, ctx, local_ctx,
                             axis)

    def lower_sp(self, h: int | None, state: Any,
                 ins: list[dict[str, torch.Tensor]], ctx: BlockCtx,
                 local_ctx: list[BlockCtx], axis: Any
                 ) -> tuple[Any, list[dict[str, torch.Tensor]]]:
        """The default :meth:`apply_sp` for a halo of ``h`` (an
        :meth:`sp_halo` answer): per shard, a gather island, or overlap-save
        with the left neighbour's last ``h`` inputs."""
        if h == 0:
            outs = []
            for x, lctx in zip(ins, local_ctx):
                st, o = self.apply(state, x, lctx)
                outs.append(o)
            return st, outs
        from ..parallel.collectives import gather, split
        if h is None:
            # gather island: the full block once on the home device, then
            # each shard keeps its slice
            full = {p: gather([d[p] for d in ins], axis.home) for p in ins[0]}
            new_state, outs = self.apply(state, full, ctx)
            parts = {p: split(v, axis) for p, v in outs.items()}
            return new_state, [{p: v[i] for p, v in parts.items()}
                               for i in range(axis.size)]
        # overlap-save halo path
        stream_ins = [p.name for p in self.in_ports if not p.asynchronous]
        if len(stream_ins) != 1:
            raise GrError(
                f"{self.name}: default halo sharding needs exactly one stream "
                f"input (has {stream_ins}); override apply_sp")
        from ..parallel.halo import halo_left, last_shard_tail
        xs = [d[stream_ins[0]] for d in ins]
        seed = self.sp_state_to_tail(state, ctx)
        halos = halo_left(xs, h, seed)
        outs = []
        for x, halo, lctx in zip(ins, halos, local_ctx):
            _, o = self.apply(self.sp_tail_to_state(halo, state, ctx), x, lctx)
            outs.append(o)
        # new state: the LAST shard's input tail
        return self.sp_tail_to_state(last_shard_tail(xs, h), state, ctx), outs

    # -- host path -------------------------------------------------------------
    def process_tags(self, in_tags: dict[str, list[Tag]], ctx: "HostCtx"
                     ) -> dict[str, list[Tag]]:
        """Host-side tag forwarding; indices are step-relative. Default: policy."""
        if not any(in_tags.values()):       # steady state: nothing to forward
            return {p.name: [] for p in self.out_ports}
        return propagate(
            in_tags,
            policy=self.tag_policy,
            out_ports=[p.name for p in self.out_ports],
            in_ports=[p.name for p in self.in_ports],
            ratio=self.ratio,
        )

    def on_settings_applied(self, result: ApplyResult) -> None:
        """Hook after staged settings were applied (host, between steps)."""

    # -- block-to-block message ports (≈ MsgPortIn/MsgPortOut, Port.hpp) -------
    def post_message(self, data: dict[str, Any]) -> None:
        """Queue a property map on this block's message output; the scheduler
        routes it over message edges at the next step boundary."""
        if not hasattr(self, "_msg_outbox"):
            self._msg_outbox = []
        self._msg_outbox.append(dict(data))

    def handle_message(self, data: dict[str, Any], *, from_block: "Block") -> None:
        """Receive a property map from an upstream message edge. Default: stage
        matching settings (the reference's property-message → settings path)."""
        self.settings.set({k: v for k, v in data.items()
                           if k in self.settings.spec})

    def drain_messages(self) -> list[dict[str, Any]]:
        out = getattr(self, "_msg_outbox", [])
        self._msg_outbox = []
        return out

    def prepare_params(self, params: dict[str, Any]) -> dict[str, Any]:
        """Host hook: derive extra dynamic params from applied settings (runs on the
        host, cheap). E.g. an NCO derives its integer phase increment in float64
        here so the device never loses precision. Default: passthrough."""
        return params

    # -- sample-accurate tag-driven settings -----------------------------------
    # The reference chunk-breaks work at the next tag so tag-driven settings
    # apply at the exact sample (Block.hpp:1986 getNextTagAndEosPosition). The
    # static-shape equivalent: a tag at step-relative index k turns the changed
    # dynamic setting into a per-sample parameter ARRAY (old value before k,
    # new from k on) for this one step; subsequent steps use the new scalar.
    SAMPLE_ACCURATE: ClassVar[frozenset] = frozenset()

    def tag_param_ramps(self, events: list[tuple[int, dict[str, Any]]],
                        n: int) -> dict[str, Any]:
        """Build per-sample param arrays (host NumPy) for this step from tag
        events ``[(index, {setting: new_value}), ...]`` (sorted). Default:
        piecewise-constant float32 ramps for keys in :attr:`SAMPLE_ACCURATE`."""
        keys = set().union(*[set(m) for _, m in events]) & self.SAMPLE_ACCURATE
        out: dict[str, Any] = {}
        for key in keys:
            arr = np.full(n, float(self.settings.get(key)), np.float32)
            for k, m in events:
                if key in m:
                    arr[min(max(k, 0), n):] = float(m[key])
            out[key] = arr
        return out

    # -- host-side streaming hooks (used by the scheduler) ---------------------
    FEED: ClassVar[bool] = False  # True → runtime feeds this source's outputs from host
    # True → a partial host_feed block is a transient underrun (live sources,
    # warming-up bridges), not EOS; only returning None ends the stream
    ALLOW_UNDERRUN: ClassVar[bool] = False

    def host_feed(self, n: int, abs_index: int):
        """For FEED sources: return {port: np.ndarray} (or (dict, n_valid)) for the
        next ``n`` samples starting at ``abs_index``; None signals EOS. The
        arrays reach ``apply`` as ``ins[port]``, tensors on the graph's device."""
        return None

    def host_done(self, abs_out: int, n: int) -> int | None:
        """For device-generating sources: return remaining valid samples (≤ n) when
        this step is the last one, else None (keep going)."""
        return None

    def emit_tags(self, ctx: "HostCtx") -> list[Tag]:
        """Host hook: tags this block emits on all outputs this step (step-relative
        indices). Used by tag sources and settings auto-forwarding."""
        return []

    terminate_graph_when_done: ClassVar[bool] = False

    def clamp_valid(self, n_valid_out: int, abs_out: int) -> int | None:
        """Host hook: clamp this step's valid output count (HeadBlock-style
        truncation). Return None to pass through; returning ≤ 0 plus
        ``terminate_graph_when_done=True`` winds the whole graph down."""
        return None

    # -- Drawable protocol (≈ gr::Drawable<UICategory, toolkit>) --------------
    UI_CATEGORY: ClassVar["UICategory"] = None  # set to a UICategory to opt in

    def draw(self, config: dict | None = None) -> str | None:
        """Render this block's UI contribution (host side, called by a UI loop
        or the CLI). Text-toolkit blocks return an ANSI/braille string."""
        return None

    @property
    def is_drawable(self) -> bool:
        return self.UI_CATEGORY is not None and \
            self.UI_CATEGORY is not UICategory.NONE

    # lifecycle hooks (≈ start/stop/pause/resume/reset user methods)
    def start(self) -> None: ...
    def stop(self) -> None: ...
    def pause(self) -> None: ...
    def resume(self) -> None: ...
    def reset(self) -> None: ...

    # -- plumbing --------------------------------------------------------------
    def port(self, name: str, *, output: bool | None = None) -> "PortRef":
        for p in self.out_ports:
            if p.name == name and output is not False:
                return PortRef(self, name, True)
        for p in self.in_ports:
            if p.name == name and output is not True:
                return PortRef(self, name, False)
        raise GrError(f"{self.name}: no port named {name!r}")

    def __getitem__(self, port_name: str) -> "PortRef":
        return self.port(port_name)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


@dataclasses.dataclass(frozen=True)
class PortRef:
    """(block, port, direction) handle used by Graph.connect."""

    block: Block
    port: str
    is_output: bool


@dataclasses.dataclass
class HostCtx:
    """Host-side per-step context for tag processing."""

    step: int
    in_len: dict[str, int]
    out_len: dict[str, int]
    sample_rate: float
    abs_index: int  # absolute index of the first input sample of this step


class SourceBlock(Block):
    """Convenience base: no stream inputs; apply(state, {}, ctx) generates a block."""

    IN: ClassVar[tuple[Port, ...]] = ()


class SinkBlock(Block):
    """Convenience base: no stream outputs. The scheduler hands this block's
    *input* tensors to :meth:`consume` after each step (≈ DataSink egress).

    ``WANTS_HOST_DATA = False`` skips the device→host copy — consume() then
    receives the device tensors (metrics-only sinks).
    """

    OUT: ClassVar[tuple[Port, ...]] = ()
    WANTS_HOST_DATA: ClassVar[bool] = True
    # True → consume() never reads the array CONTENTS (pure metrics sinks:
    # counters). The batched delivery then skips the per-sub-step slicing;
    # consume() still runs once per logical step with correct tags/n_valid/
    # abs_index, and its arrays hold the super-step's per-sub-step tensors.
    CONSUME_IGNORES_DATA: ClassVar[bool] = False
    # True → consume() receives n_valid as {port: count}, each input's own
    # (≈ the reference's Async input ports progressing independently)
    PER_PORT_VALID: ClassVar[bool] = False

    def apply(self, state, ins, ctx):
        return state, {}

    def consume(self, arrays: dict[str, Any], tags: dict[str, list[Tag]],
                n_valid: int, abs_index: int) -> None:
        """Host callback with this step's input arrays (numpy) + tags."""
