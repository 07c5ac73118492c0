"""Host streaming scheduler (≈ reference Scheduler.hpp, gr::scheduler::Simple).

The device does the stream compute in one step of the compiled graph
(compiler.py); the scheduler is a host pump that per step

  1. drains the message plane (settings get/set, lifecycle, graph mutation)
     and routes block-to-block message edges,
  2. applies staged settings — dynamic ones land as new step params, static
     ones recompile at the step boundary,
  3. collects host feeds and works out how many samples of this step are
     valid (sources end, HeadBlock-style clamps),
  4. advances the host tag sideband in topological order (auto-updating
     settings, turning SAMPLE_ACCURATE hits into per-sample param ramps),
  5. runs the step on the graph's device (kernels queue on the current CUDA
     stream and the pump moves on),
  6. delivers sink inputs ``pipeline_depth`` steps behind dispatch — inline,
     or on one worker thread with ``async_delivery`` — and with
     ``batch_steps`` = S plans S logical steps per dispatch.

Lifecycle, pause/resume, EOS propagation, the watchdog and zombie pruning
mirror the reference's semantics (Scheduler.hpp:515 runAndWait, :845
watchdog, :1210 cleanupZombieBlocks).

Delivery on a CUDA device: each dispatched step records a CUDA event on the
stream it ran on; delivery waits on that event (not on the whole device) from
a side stream and copies the sink tensors into pinned host memory. The
in-flight record holds the tensors until their copy has landed, so the caching
allocator cannot hand their memory to a later step early.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from fractions import Fraction
from typing import Any

import numpy as np
import torch

from ..utils import thread_pool
from .block import Block, HostCtx, SinkBlock
from .compiler import (CompiledGraph, _mesh_device, compile_graph,
                       default_device)
from .errors import Error, GrError
from .graph import Graph
from .lifecycle import State, StateMachine
from .messages import Command, Message, MessageBus, Property
from .profiler import NullProfiler
from .registry import global_registry, register_scheduler
from .settings import SettingsCtx, _equal
from .tags import Keys, Tag


@dataclasses.dataclass
class _SubStep:
    """Per-sub-step host bookkeeping of a batched dispatch (batch_steps > 1)."""
    step: int
    sink_tags: dict[str, dict[str, list[Tag]]]
    n_valid: dict[str, int]
    abs_in: dict[str, int]
    n_valid_ports: dict[str, dict[str, int]]


@dataclasses.dataclass
class _InFlight:
    step: int
    sink_ins: dict[str, dict[str, Any]]
    sink_tags: dict[str, dict[str, list[Tag]]]
    n_valid: dict[str, int]
    abs_in: dict[str, int]
    n_valid_ports: dict[str, dict[str, int]] = dataclasses.field(
        default_factory=dict)   # PER_PORT_VALID sinks: per-port counts
    batch: list[_SubStep] | None = None   # batched dispatch: sink_ins leaves
                                          # are lists of S per-sub-step tensors
    event: Any = None     # CUDA event recorded after the step's dispatch


class Scheduler:
    """Streaming scheduler (≈ gr::scheduler::Simple) on one device, or over
    the shards of a mesh (``mesh=``, see ``compile_graph``)."""

    def __init__(self, graph: Graph, *, block_len: int = 1 << 16,
                 sample_rate: float = 1.0,
                 device: torch.device | str | None = None, mesh: Any = None,
                 pipeline_depth: int = 2, profiler: Any = None,
                 watchdog_timeout: float | None = None,
                 watchdog_action: str = "notify",
                 max_tags_per_step: int = 64, name: str = "scheduler",
                 on_block_error: str = "shutdown",
                 async_delivery: bool = False, batch_steps: int = 1):
        self.name = name
        self.graph = graph
        self.block_len = block_len
        self.sample_rate = sample_rate
        # a mesh (parallel.mesh.Mesh) shards the compiled step over its
        # devices; the scheduler runs on the mesh's first device
        self.mesh = mesh
        if mesh is not None:
            device = _mesh_device(mesh, device)
        # multi-process (parallel/multihost.py): every process runs this
        # same scheduler; each feeds its own time slice of the host feeds,
        # and sinks receive this process's slice
        self._multihost = mesh is not None and mesh.process_count > 1
        self.device = default_device() if device is None else torch.device(device)
        # step batching: plan S logical sub-steps on the host and run them in
        # one dispatch. STATIC/structural settings changes and block state
        # resets staged mid-batch take effect at the next super-step boundary
        # (up to S-1 logical steps late); tag-accurate SAMPLE_ACCURATE ramps
        # and dynamic settings changes still hit their exact sub-step via
        # per-sub-step param overlays.
        self.batch_steps = int(batch_steps)
        if self.batch_steps < 1:
            raise GrError(f"batch_steps must be >= 1, got {batch_steps}")
        self.pipeline_depth = max(1, pipeline_depth)
        self.profiler = profiler if profiler is not None else NullProfiler()
        self.watchdog_timeout = watchdog_timeout
        if watchdog_action not in ("notify", "stop", "error"):
            raise GrError("watchdog_action must be 'notify', 'stop' or 'error'")
        self.watchdog_action = watchdog_action
        # capacity of the TagArrays a WANTS_TAG_ARRAYS block receives per step
        self.max_tags_per_step = max_tags_per_step
        # 'shutdown' (default): any block failure stops the whole graph;
        # 'prune': failed blocks go zombie — they and their dependent branch
        # are removed, the rest of the graph recompiles and keeps streaming
        # (≈ reference cleanupZombieBlocks, Scheduler.hpp:1210-1217)
        if on_block_error not in ("shutdown", "prune"):
            raise GrError("on_block_error must be 'shutdown' or 'prune'")
        self.on_block_error = on_block_error
        self.zombies: list[str] = []   # names of pruned blocks

        self.fsm = StateMachine()
        self.bus = MessageBus()
        # every lifecycle transition notifies the message plane (the
        # reference's setAndNotifyState publishing kLifecycleState)
        for _st in State:
            self.fsm.on(_st, (lambda s: lambda: self.bus.notify(
                self.name, Property.LIFECYCLE_STATE, {"state": s.value}))(_st))
        self.compiled: CompiledGraph | None = None
        self._states: dict[str, Any] = {}
        self._dirty = True            # needs (re)compile
        self._step = 0
        self._abs_in: dict[str, int] = {}   # block → absolute input-sample counter
        self._abs_out: dict[str, int] = {}
        self._pending_out_tags: dict[tuple[str, str], list[Tag]] = {}
        self._tag_ramps: dict[str, list] = {}   # uname → tag-settings events
        self._finished_sources: set[str] = set()
        self._eos_announced: set[str] = set()
        self._inflight: collections.deque[_InFlight] = collections.deque()
        # async delivery (≈ reference DataSink poller threads): sink D2H +
        # consume run on ONE worker (FIFO order kept) so the pump never waits
        # on the device. Delivery errors are deferred to the pump thread.
        self.async_delivery = bool(async_delivery)
        self._dq: queue.Queue | None = None
        self._dworker: threading.Thread | None = None
        self._deferred_errors: list = []
        self._copy_stream: Any = None
        self._runner: threading.Thread | None = None
        self._watchdog: threading.Thread | None = None
        # step-boundary lock: held for the whole of _pump_once so external
        # readers see states/counters atomically
        self.step_lock = threading.RLock()
        self._last_progress = time.monotonic()
        self._stall_flagged = False
        self.error: Error | None = None

    # -- public control --------------------------------------------------------
    @property
    def state(self) -> State:
        return self.fsm.state

    @property
    def steps(self) -> int:
        """Logical steps dispatched so far."""
        return self._step

    def init(self) -> None:
        """Compile the graph and create its states (≈ changeStateTo(INITIALISED))."""
        if self.fsm.state is State.IDLE:
            with self.profiler.duration("scheduler.compile", step=self._step):
                self._recompile(reset_state=True)
            self.fsm.transition_to(State.INITIALISED)

    def run_and_wait(self, n_steps: int | None = None) -> None:
        """Run the pump on the calling thread until EOS, a stop request or
        ``n_steps`` logical steps (≈ runAndWait, Scheduler.hpp:515)."""
        self.init()
        self.fsm.transition_to(State.RUNNING)
        self._start_watchdog()
        self._call_hooks("start")
        try:
            self._pump(n_steps)
        except Exception as e:
            self.error = Error.here(str(e), block=self.name)
            self.fsm.force_error()
            raise
        finally:
            try:
                self._drain()
            except Exception as e:
                if self.error is None:
                    self.error = Error.here(str(e), block=self.name)
                self.fsm.force_error()
                raise
            finally:
                self._stop_delivery_worker()
            if self.fsm.state in (State.RUNNING, State.PAUSED, State.REQUESTED_PAUSE):
                self.fsm.transition_to(State.REQUESTED_STOP)
            if self.fsm.state is State.REQUESTED_STOP:
                self.fsm.transition_to(State.STOPPED)
            self._call_hooks("stop")
            self._process_messages()  # final message pump (≈ Scheduler.hpp:543-554)

    def start(self, n_steps: int | None = None) -> None:
        """Run the pump on a background thread (≈ multiThreaded policy)."""
        def runner():
            try:
                self.run_and_wait(n_steps)
            except Exception:
                # recorded in self.error / ERROR state; wait_done() re-raises
                # it on the waiter's thread
                pass

        self._runner = thread_pool.spawn(runner, name=f"{self.name}-runner")

    def wait_done(self, timeout: float | None = None) -> None:
        if self._runner is not None:
            self._runner.join(timeout)
            if self._runner.is_alive():
                if self.fsm.state is State.ERROR and self.error is not None:
                    # the pump is wedged but the watchdog already marked the
                    # run failed: raise the diagnosis instead of timing out
                    raise GrError(f"{self.name} failed: {self.error.message}")
                raise TimeoutError(f"{self.name} still running")
        if self.fsm.state is State.ERROR and self.error is not None:
            raise GrError(f"{self.name} failed: {self.error.message}")

    def step_once(self) -> bool:
        """Advance the graph by exactly one scheduler step (a super-step of
        ``batch_steps`` logical steps) under external control (≈
        ExecutionPolicy::externalStep, Scheduler.hpp:79): the caller owns the
        cadence, so every call returns with its step delivered to the sinks.

        Returns True while the graph can make further progress, False once the
        stream completed. The scheduler must be INITIALISED or RUNNING;
        lifecycle hooks fire on first use."""
        if self.fsm.state is State.IDLE:
            self.init()
        if self.fsm.state is State.INITIALISED:
            self.fsm.transition_to(State.RUNNING)
            self._call_hooks("start")
        if self.fsm.state is not State.RUNNING:
            raise GrError(f"step_once in state {self.fsm.state.name}")
        more = self._pump_once()
        self._drain()
        if not more:
            self._stop_delivery_worker()
            self.fsm.transition_to(State.REQUESTED_STOP)
            self.fsm.transition_to(State.STOPPED)
            self._call_hooks("stop")
        return more

    def request_pause(self) -> None:
        self.fsm.transition_to(State.REQUESTED_PAUSE)

    def resume(self) -> None:
        self.fsm.transition_to(State.RUNNING)
        self._call_hooks("resume")

    def request_stop(self) -> None:
        st = self.fsm.state
        if st in (State.RUNNING, State.PAUSED, State.REQUESTED_PAUSE, State.INITIALISED):
            self.fsm.transition_to(State.REQUESTED_STOP)

    def reset(self) -> None:
        if self.fsm.state is State.ERROR:
            self.fsm.transition_to(State.IDLE)
        self._stop_delivery_worker()
        self._deferred_errors.clear()
        self._step = 0
        self._dirty = True
        self._finished_sources.clear()
        self._eos_announced.clear()
        self._inflight.clear()
        self._pending_out_tags.clear()
        self.error = None
        self._call_hooks("reset")

    # -- compile ---------------------------------------------------------------
    def _recompile(self, *, reset_state: bool) -> None:
        old_states = None if reset_state else self._states
        while True:
            try:
                self.compiled = compile_graph(
                    self.graph, block_len=self.block_len,
                    sample_rate=self.sample_rate, batch_steps=self.batch_steps,
                    device=self.device, mesh=self.mesh)
                if self.batch_steps > 1 and any(
                        getattr(b, "FEED", False) and hasattr(b, "consume")
                        for b in self.compiled.order):
                    # a ring-bridged subgraph's feed depends on the PREVIOUS
                    # step's delivery — batching would starve it S steps deep
                    raise GrError(
                        "batch_steps > 1 is incompatible with ring-bridged "
                        "subgraphs (a block with both FEED and consume): its "
                        "feed consumes the previous step's delivery, which a "
                        "batched dispatch only produces at the super-step "
                        "boundary. Run this graph with batch_steps=1.")
                states = self.compiled.init_states()
                break
            except GrError as e:
                # zombie path: remove the failing block (+ its dependent
                # branch), keep the rest running (≈ Scheduler.hpp:1210-1217)
                if self.on_block_error != "prune" or not e.block:
                    raise
                self._zombify(e.block, str(e))
        self._states = states
        if old_states:
            # carry state across a recompile where shapes still match
            for k, v in old_states.items():
                if k in self._states and _same_struct(v, self._states[k]):
                    self._states[k] = v
        for b in self.compiled.order:
            self._abs_in.setdefault(b.unique_name, 0)
            self._abs_out.setdefault(b.unique_name, 0)
        self._dirty = False
        self.compiled.profiler = self.profiler

    def _zombify(self, name: str, reason: str) -> None:
        """Remove a failed block and every block whose non-optional input
        depends on it; the survivors keep streaming after a recompile."""
        flat = self.graph.flatten()
        target = next((b for b in flat.blocks
                       if b.name == name or b.unique_name == name), None)
        if target is None:
            raise GrError(f"cannot prune unknown block {name!r}: {reason}")
        doomed = {target}
        changed = True
        while changed:
            changed = False
            for e in flat.edges:
                if e.src in doomed and e.dst not in doomed:
                    decl = next((p for p in e.dst.in_ports
                                 if p.name == e.dst_port), None)
                    if decl is None or not decl.optional:
                        doomed.add(e.dst)
                        changed = True
        survivors = [b for b in flat.blocks if b not in doomed]
        if not survivors:
            raise GrError(f"block {name!r} failed and nothing survives "
                          f"pruning it: {reason}")
        for b in doomed:
            _remove_deep(self.graph, b)
            self._states.pop(b.unique_name, None)
            self._finished_sources.discard(b.unique_name)
        self.zombies.extend(b.name for b in doomed)
        self.bus.notify(self.name, "BlockError",
                        {"block": name, "reason": reason,
                         "removed": sorted(b.name for b in doomed)})

    def _contain_block_error(self, block: Block, err: Exception,
                             what: str) -> bool:
        """Prune-mode containment for host-side block failures (feed/consume).
        Returns True when the error was absorbed (block zombified)."""
        if self.on_block_error != "prune":
            return False
        self._zombify(block.name, f"{what}: {err}")
        self._dirty = True
        return True

    # -- per-step planning (shared by the unbatched and batched pumps) ---------
    def _plan_substep(self, c: CompiledGraph, feed_failures: list | None = None):
        """Collect feeds + per-source valid counts and propagate validity
        through the DAG for ONE logical step. Reads/updates
        ``_finished_sources`` and reads the abs counters (advanced by the
        caller afterwards).

        Returns ``(feeds, n_valid, n_valid_deliver, n_valid_ports,
        produced_any, graph_done)`` or None when a feed failure was contained
        by zombie-pruning (the caller retries the pump on the pruned graph).
        With ``feed_failures`` (batched planning), failing feed blocks are not
        pruned mid-batch: they are recorded as ``(block, err)``, treated as
        finished sources for the remaining sub-steps (zero feeds), and the
        caller prunes after the batched dispatch.
        """
        in_edges = c.in_edges
        plan = c.pump_plan()
        feeds: dict[str, dict[str, np.ndarray]] = {}
        n_valid: dict[str, int] = {}
        for b, uname, is_feed, has_ins, srcs, num, den, stock_clamp, \
                allow_underrun in plan:
            if uname in self._finished_sources:
                n_valid[uname] = 0
                if is_feed:
                    feeds[uname] = c.zero_feeds()[uname]
            elif is_feed:
                try:
                    with self.profiler.duration("block.host_feed", block=b.name,
                                                step=self._step):
                        got = b.host_feed(c.out_len[uname], self._abs_out[uname])
                except Exception as err:
                    if feed_failures is not None \
                            and self.on_block_error == "prune":
                        feed_failures.append((b, err))
                        self._finished_sources.add(uname)
                        n_valid[uname] = 0
                        feeds[uname] = c.zero_feeds()[uname]
                        continue
                    if self._contain_block_error(b, err, "host_feed"):
                        return None   # retry next pump on the pruned graph
                    raise
                if got is None:
                    self._finished_sources.add(uname)
                    n_valid[uname] = 0
                    feeds[uname] = c.zero_feeds()[uname]
                else:
                    arrays, nv = got if isinstance(got, tuple) else (got, c.out_len[uname])
                    zero = c.zero_feeds()[uname]
                    feeds[uname] = {p: _pad_to(np.asarray(a), zero[p].shape, zero[p].dtype)
                                    for p, a in arrays.items()}
                    nv = min(nv, min((np.asarray(a).shape[-1] for a in arrays.values()),
                                     default=nv))
                    n_valid[uname] = nv
                    # ALLOW_UNDERRUN feeds signal EOS only by returning None;
                    # a partial block is a transient underrun
                    if nv < c.out_len[uname] and not allow_underrun:
                        self._finished_sources.add(uname)
            elif not has_ins:  # pure device source
                done = b.host_done(self._abs_out[uname], c.out_len[uname])
                if done is not None and done <= c.out_len[uname]:
                    n_valid[uname] = max(0, done)
                    self._finished_sources.add(uname)
                else:
                    n_valid[uname] = c.out_len[uname]

        # propagate valid counts through the DAG (host-side bookkeeping)
        graph_done = False
        nv_get = n_valid.get
        for b, uname, is_feed, has_ins, srcs, num, den, stock_clamp, _au \
                in plan:
            if (not has_ins or is_feed) and uname in n_valid:
                continue      # sources: validity comes from the feed
            if has_ins:
                nv_in = min(nv_get(s, dflt) for s, dflt in srcs)
                nv_out = nv_in if num == den else (nv_in * num) // den
            else:
                nv_out = nv_get(uname, c.out_len[uname])
            # mid-graph valid clamp (HeadBlock-style truncation, ≈ reference
            # disconnect_on_done)
            if not stock_clamp:
                clamp = b.clamp_valid(nv_out, self._abs_out[uname])
                if clamp is not None:
                    nv_out = min(nv_out, clamp)
                    if clamp <= 0 and b.terminate_graph_when_done:
                        graph_done = True
            n_valid[uname] = nv_out

        produced_any = any(nv_get(uname, 0) > 0
                           for _b, uname, _f, has_ins, *_ in plan
                           if not has_ins)

        # delivery-side validity: a FEED block WITH inputs has its n_valid set
        # by its own feed; what its consume() receives is the input stream.
        # PER_PORT_VALID sinks additionally get each port's own count.
        n_valid_deliver = dict(n_valid)
        n_valid_ports: dict[str, dict[str, int]] = {}
        for b, uname, is_feed, has_ins, srcs, *_ in plan:
            if not has_ins:
                continue
            if is_feed:
                n_valid_deliver[uname] = min(nv_get(s, d) for s, d in srcs)
            if getattr(b, "PER_PORT_VALID", False):
                n_valid_ports[uname] = {
                    e.dst_port: nv_get(e.src.unique_name,
                                       c.out_len[e.src.unique_name])
                    for e in in_edges[uname]}
        return (feeds, n_valid, n_valid_deliver, n_valid_ports,
                produced_any, graph_done)

    # -- the pump --------------------------------------------------------------
    def _pump(self, n_steps: int | None) -> None:
        while True:
            st = self.fsm.state
            if st is State.REQUESTED_STOP or st is State.ERROR:
                return
            if st is State.REQUESTED_PAUSE:
                self.fsm.transition_to(State.PAUSED)
                self._call_hooks("pause")
                st = self.fsm.state
            if st is State.PAUSED:
                self._process_messages()
                time.sleep(0.001)
                continue
            if n_steps is not None and self._step >= n_steps:
                return
            if not self._pump_once():
                return

    def _pump_once(self) -> bool:
        """One scheduler step (a SUPER-step of ``batch_steps`` logical steps
        when batching). Returns False on EOS completion."""
        with self.step_lock, \
                self.profiler.duration("scheduler.step", step=self._step):
            if self.batch_steps > 1:
                return self._pump_once_batched()
            return self._pump_once_inner()

    def _step_head(self) -> CompiledGraph | None:
        """Work both pumps do first: messages and message edges, staged
        settings, recompile, then deliver matured in-flight results (feeds may
        depend on deliveries). None when a stop was requested."""
        self._process_messages()
        if self.fsm.state in (State.REQUESTED_STOP, State.ERROR):
            return None
        # block-to-block message edges (≈ MsgPortIn/Out): deliver posted
        # property maps before settings staging so they apply this step
        if self.compiled is not None:
            for src, dst in self.compiled.graph.message_edges:
                for m in src.drain_messages():
                    dst.handle_message(m, from_block=src)
        self._apply_staged_settings()
        if self._dirty:
            with self.profiler.duration("scheduler.compile", step=self._step):
                self._recompile(reset_state=False)
        worker = self._async_delivery_active()
        if worker:
            self._flush_deferred_errors()
        if len(self._inflight) >= self.pipeline_depth:
            with self.profiler.duration("scheduler.retire", step=self._step):
                while len(self._inflight) >= self.pipeline_depth:
                    if worker:
                        # bounded queue (maxsize = pipeline_depth) gives
                        # backpressure: put() blocks when the delivery
                        # worker lags too far behind
                        self._dq.put(self._inflight.popleft())
                    else:
                        self._deliver(self._inflight.popleft())
        return self.compiled

    def _dispatch(self, c: CompiledGraph, step: int, params, feeds,
                  overlays=None, refit=None):
        """Run one (super-)step on the device. A block whose ``apply`` fails
        raises from inside the eager step, possibly after earlier blocks ran;
        under 'prune' the failing branch is removed and the WHOLE step runs
        again on the pruned graph from the states as they were before it (the
        failed attempt's new states are dropped). ``refit(c)`` rebuilds
        ``(params, feeds, overlays)`` for the recompiled graph. ``step``: the
        logical step of the first sub-step."""
        while True:
            try:
                fed = self._local_feeds(feeds) if self._multihost else feeds
                with self._compiled_statics(c):
                    new_states, sink_ins = c.step(self._states, params, fed,
                                                  overlays, stack=False,
                                                  step=step)
                break
            except GrError as e:
                if self.on_block_error != "prune" or not e.block:
                    raise
                self._zombify(e.block, str(e))
                self._recompile(reset_state=False)
                c = self.compiled
                params, feeds, overlays = refit(c)
        self._states = new_states
        event = None
        if c.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(c.device))
        return c, sink_ins, event

    def _local_feeds(self, feeds: dict) -> dict:
        """This process's time slice of the host feeds (≈ the JAX package's
        ``_globalize_feeds``): every process's ``host_feed`` returns the
        full global block, and process ``p`` of ``n`` keeps
        ``[p·T/n, (p+1)·T/n)`` of its last axis (of each sub-step's when
        batched)."""
        n, p = self.mesh.process_count, self.mesh.process_index
        out = {}
        for uname, d in feeds.items():
            od = {}
            for port, arr in d.items():
                arr = np.asarray(arr)
                tl = arr.shape[-1] // n
                od[port] = np.ascontiguousarray(arr[..., p * tl:(p + 1) * tl])
            out[uname] = od
        return out

    @contextlib.contextmanager
    def _compiled_statics(self, c: CompiledGraph):
        """Blocks read their static settings when they run. A static change
        applied since ``c`` was compiled (mid-batch, or a tag-staged change
        that re-solved the rates) takes effect at the next boundary's
        recompile; until then ``c`` runs with the values it was compiled with
        (≈ the JAX package dispatching its previously traced program)."""
        swapped = []
        if self._dirty:
            for b in c.order:
                applied = b.settings._applied
                newer = {k: applied[k] for k, v in c.statics[b.unique_name].items()
                         if not _equal(applied[k], v)}
                if newer:
                    swapped.append((applied, newer))
                    applied.update({k: c.statics[b.unique_name][k] for k in newer})
        try:
            yield
        finally:
            for applied, newer in swapped:
                applied.update(newer)

    def _pump_once_inner(self) -> bool:
        c = self._step_head()
        if c is None:
            return False
        planned = self._plan_substep(c)
        if planned is None:
            return True   # feed failure contained (prune): retry next pump
        (feeds, n_valid, n_valid_deliver, n_valid_ports, produced_any,
         graph_done) = planned

        # host tag sideband FIRST — tag-derived dynamic params must be visible
        # to this step's dispatch
        with self.profiler.duration("scheduler.tags", step=self._step):
            sink_tags = self._advance_tags(n_valid)

        # settings staged by the tag walk (auto-update, context activation)
        # apply THIS step — the reference chunk-breaks work at the tag
        # (Block.hpp:1986). Blocks with pending SAMPLE_ACCURATE ramps keep
        # their applied value as the pre-tag baseline.
        self._apply_staged_settings(exclude=set(self._tag_ramps))
        if self._dirty:
            old_compiled, old_states = self.compiled, self._states
            with self.profiler.duration("scheduler.compile", step=self._step):
                self._recompile(reset_state=False)
            c = self.compiled
            if c.in_len != old_compiled.in_len \
                    or c.out_len != old_compiled.out_len:
                # the tag-staged change re-solved the RATE solution: this
                # step's feeds/validity/tags were planned on the old grid.
                # Run the old program once more; the new one takes over at
                # the next step boundary.
                self.compiled, self._states = old_compiled, old_states
                self._dirty = True
                c = old_compiled
            else:
                feeds = _refit_feeds(feeds, c.zero_feeds())

        # dispatch; tag-driven settings at index k become per-sample param
        # arrays for this step (exact application)
        with self.profiler.duration("scheduler.dispatch", step=self._step):
            ramp_events = self._tag_ramps
            self._tag_ramps = {}

            def params_with_ramps(c):
                params = c.gather_params()
                if not ramp_events:
                    return params
                params = dict(params)
                for uname, events in ramp_events.items():
                    blk = next((b for b in c.order
                                if b.unique_name == uname), None)
                    if blk is None:      # ramped block was zombie-pruned
                        continue
                    over = blk.tag_param_ramps(events, c.in_len[uname])
                    if over:
                        params[uname] = {**params.get(uname, {}), **over}
                return params

            def refit(c):
                return (params_with_ramps(c),
                        _refit_feeds(feeds, c.zero_feeds()), None)

            c, sink_ins, event = self._dispatch(c, self._step,
                                                params_with_ramps(c), feeds,
                                                refit=refit)

        # book-keeping + pipelined sink delivery
        abs_in_snapshot = dict(self._abs_in)
        for b in c.order:
            uname = b.unique_name
            self._abs_in[uname] += c.in_len[uname]
            self._abs_out[uname] += c.out_len[uname]
        self._inflight.append(_InFlight(
            step=self._step, sink_ins=sink_ins, sink_tags=sink_tags,
            n_valid=n_valid_deliver, abs_in=abs_in_snapshot,
            n_valid_ports=n_valid_ports,
            event=event))
        self._step += 1
        self._last_progress = time.monotonic()
        return not self._ended(c, produced_any, graph_done)

    def _ended(self, c: CompiledGraph, produced_any: bool, graph_done: bool
               ) -> bool:
        """EOS: all sources finished and nothing produced this step, or a
        terminate-graph block (HeadBlock) completed. Mid-graph FEED blocks
        count as sources."""
        sources = [uname for _b, uname, is_feed, has_ins, *_ in c.pump_plan()
                   if not has_ins or is_feed]
        all_done = sources and all(u in self._finished_sources for u in sources)
        return bool((all_done and not produced_any) or graph_done)

    # -- batched pump (batch_steps > 1) ----------------------------------------
    def _pump_once_batched(self) -> bool:
        """One SUPER-step: plan ``batch_steps`` logical sub-steps on the host
        (feeds, validity, tag walk, staged settings — advancing the abs
        counters per sub-step), then run them all in ONE dispatch. Tag-accurate
        ramps and mid-batch dynamic-settings changes ride a per-sub-step params
        overlay; static/structural changes and state resets land at the next
        super-step boundary."""
        c = self._step_head()
        if c is None:
            return False
        S = c.batch_steps

        # params snapshot for the whole batch; blocks whose params change
        # mid-batch (or that derive params from the per-step tag walk) get
        # per-sub-step overlays instead
        params_base = c.gather_params(refresh=False)
        by_uname = {b.unique_name: b for b in c.order}
        prep_overriders = [b.unique_name for b in c.order
                           if type(b).prepare_params is not Block.prepare_params]

        feeds_list: list[dict] = []
        sub_meta: list[_SubStep] = []
        snaps: dict[str, dict[int, dict]] = {}
        feed_failures: list[tuple[Block, Exception]] = []
        deferred_resets: list[Block] = []
        produced_any = False
        graph_done = False

        for k in range(S):
            if graph_done:
                # a terminate-graph block (HeadBlock) completed in an earlier
                # sub-step: the rest are INERT — no host_feed calls, zero
                # validity, no counter advance (the dispatch still runs S)
                sub_meta.append(_SubStep(
                    step=self._step, sink_tags={},
                    n_valid={b.unique_name: 0 for b in c.order},
                    abs_in=dict(self._abs_in), n_valid_ports={}))
                feeds_list.append(c.zero_feeds())
                continue
            planned = self._plan_substep(c, feed_failures=feed_failures)
            if planned is None:   # only reachable when on_block_error=shutdown
                return True
            (feeds_k, n_valid, n_valid_deliver, n_valid_ports,
             produced_k, done_k) = planned
            with self.profiler.duration("scheduler.tags", step=self._step):
                sink_tags = self._advance_tags(n_valid)
            ramp_events = self._tag_ramps
            self._tag_ramps = {}
            # ramps use the PRE-apply baseline (old value before the tag)
            ramp_over: dict[str, dict] = {}
            for uname, events in ramp_events.items():
                blk = by_uname.get(uname)
                if blk is None:
                    continue
                over = blk.tag_param_ramps(events, c.in_len[uname])
                if over:
                    ramp_over[uname] = over
            applied = self._apply_staged_settings(
                defer_state_reset=deferred_resets)
            # snapshot effective params for this sub-step
            for uname in set(prep_overriders) | set(applied) | set(ramp_over):
                blk = by_uname.get(uname)
                if blk is None:
                    continue
                snap = blk.prepare_params(blk.settings.dynamic_params())
                if uname in ramp_over:
                    snap = {**snap, **ramp_over[uname]}
                snaps.setdefault(uname, {})[k] = snap
                if uname in ramp_over and k + 1 < S:
                    # the sub-step after a ramp reverts to the (new) scalar
                    # params; a later snapshot at k+1 overwrites this
                    snaps[uname][k + 1] = blk.prepare_params(
                        blk.settings.dynamic_params())
            abs_in_snapshot = dict(self._abs_in)
            for b in c.order:
                uname = b.unique_name
                self._abs_in[uname] += c.in_len[uname]
                self._abs_out[uname] += c.out_len[uname]
            sub_meta.append(_SubStep(
                step=self._step, sink_tags=sink_tags,
                n_valid=n_valid_deliver, abs_in=abs_in_snapshot,
                n_valid_ports=n_valid_ports))
            feeds_list.append(feeds_k)
            produced_any = produced_any or produced_k
            graph_done = graph_done or done_k
            self._step += 1

        overlays = self._build_overlays(snaps, params_base, S)
        with self.profiler.duration("scheduler.dispatch", step=self._step):
            def refit(c):
                alive = {b.unique_name for b in c.order}
                return (c.gather_params(),
                        _stack_feeds([_refit_feeds(f, c.zero_feeds())
                                      for f in feeds_list], c.zero_feeds()),
                        {u: o for u, o in overlays.items() if u in alive})

            c, sink_ins, event = self._dispatch(
                c, sub_meta[0].step, params_base,
                _stack_feeds(feeds_list, c.zero_feeds()), overlays, refit=refit)

        self._inflight.append(_InFlight(
            step=sub_meta[0].step, sink_ins=sink_ins,
            sink_tags=sub_meta[0].sink_tags, n_valid=sub_meta[0].n_valid,
            abs_in=sub_meta[0].abs_in,
            n_valid_ports=sub_meta[0].n_valid_ports, batch=sub_meta,
            event=event))
        self._last_progress = time.monotonic()

        # post-batch: prune feed-failed blocks (kept alive through the batch
        # so the compiled graph's states stayed intact), apply deferred resets
        for blk, err in feed_failures:
            if blk.unique_name not in self.zombies and blk.name not in self.zombies:
                self._zombify(blk.name, f"host_feed: {err}")
                self._dirty = True
        for blk in deferred_resets:
            uname = blk.unique_name
            if uname in self._states:
                self._states[uname] = blk.init_state(c.block_ctx[uname])
        return not self._ended(c, produced_any, graph_done)

    @staticmethod
    def _build_overlays(snaps: dict[str, dict[int, dict]], params_base: dict,
                        S: int) -> dict[str, list[dict]]:
        """Per-sub-step params snapshots → ``{uname: [params_0, …,
        params_{S-1}]}``: sub-steps without a snapshot forward-fill from the
        latest one (or the batch-start base params). Each sub-step runs
        eagerly, so a ramp array in one sub-step and scalars in the others
        need no common shape."""
        overlays: dict[str, list[dict]] = {}
        for uname, by_k in snaps.items():
            cur = dict(params_base.get(uname, {}))
            per_step = []
            for k in range(S):
                cur = by_k.get(k, cur)
                per_step.append(cur)
            overlays[uname] = per_step
        return overlays

    def _drain(self) -> None:
        if self._async_delivery_active():
            while self._inflight:
                self._dq.put(self._inflight.popleft())
            self._dq.join()            # wait for the worker to finish FIFO
            self._flush_deferred_errors()
            return
        while self._inflight:
            self._deliver(self._inflight.popleft())

    # -- async delivery (opt-in) ----------------------------------------------
    def _async_delivery_active(self) -> bool:
        if not self.async_delivery:
            return False
        c = self.compiled
        if c is not None and any(getattr(b, "FEED", False)
                                 and hasattr(b, "consume") for b in c.order):
            # a feed depending on a delivery would deadlock behind its own
            # queue — force the sync path
            return False
        if self._dworker is None or not self._dworker.is_alive():
            self._dq = queue.Queue(maxsize=self.pipeline_depth)

            def worker():
                while True:
                    rec = self._dq.get()
                    if rec is None:
                        self._dq.task_done()
                        return
                    try:
                        self._deliver(rec, deferred=self._deferred_errors)
                    except Exception as err:  # defensive: never kill the worker
                        self._deferred_errors.append((None, err, "deliver"))
                    finally:
                        self._dq.task_done()

            self._dworker = thread_pool.spawn(
                worker, name=f"{self.name}-delivery")
        return True

    def _flush_deferred_errors(self) -> None:
        """Handle delivery-thread errors on the PUMP thread (zombie pruning
        mutates the graph and must never run concurrently with dispatch)."""
        while self._deferred_errors:
            block, err, stage = self._deferred_errors.pop(0)
            if block is not None and (block.unique_name in self.zombies
                                      or block.name in self.zombies):
                continue   # queued deliveries raced a block already pruned
            if block is None or not self._contain_block_error(
                    block, err, stage):
                raise err

    def _stop_delivery_worker(self) -> None:
        if self._dworker is not None and self._dworker.is_alive():
            self._dq.put(None)
            self._dworker.join(timeout=10)
        self._dworker = None
        self._dq = None

    def _to_host(self, rec: _InFlight, ins: dict[str, Any]
                 ) -> dict[str, np.ndarray]:
        """Sink tensors → host arrays. On CUDA: wait for the step's event on a
        side stream, copy into pinned memory, wait for the copies. A batched
        record's per-sub-step tensors land in one ``[S, ...]`` array."""
        with self.profiler.duration("scheduler.to_host", step=rec.step):
            if rec.event is None:
                return {p: (np.stack([t.detach().numpy() for t in a])
                            if isinstance(a, list) else a.detach().numpy())
                        for p, a in ins.items()}
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=self.device)
            stream = self._copy_stream
            out = {}
            with torch.cuda.stream(stream):
                stream.wait_event(rec.event)
                for p, a in ins.items():
                    parts = a if isinstance(a, list) else [a]
                    host = torch.empty((len(parts), *parts[0].shape),
                                       dtype=parts[0].dtype, pin_memory=True)
                    for k, t in enumerate(parts):
                        host[k].copy_(t, non_blocking=True)
                    out[p] = host if isinstance(a, list) else host[0]
            stream.synchronize()
            return {p: h.numpy() for p, h in out.items()}

    def _late_tag_routes(self, c: CompiledGraph, src_uname: str):
        """Downstream sink/tap consumers reachable from ``src_uname`` with the
        cumulative rate ratio along the path and the arrival port: data-derived
        tags (host_emit_tags) exist only once device results land, so they ride
        the *delivery* path to consumers, not the dispatch-time sideband."""
        routes: list[tuple[str, str, Fraction]] = []
        out_edges: dict[str, list] = {}
        for e in c.graph.edges:
            out_edges.setdefault(e.src.unique_name, []).append(e)
        by_uname = {b.unique_name: b for b in c.order}
        seen = set()
        frontier = [(src_uname, Fraction(1))]
        while frontier:
            uname, ratio = frontier.pop()
            for e in out_edges.get(uname, []):
                dst = e.dst.unique_name
                if (dst, e.dst_port) in seen:
                    continue
                seen.add((dst, e.dst_port))
                blk = by_uname.get(dst)
                if blk is None:
                    continue
                if isinstance(blk, SinkBlock) or getattr(blk, "HOST_TAP", False):
                    routes.append((dst, e.dst_port, ratio))
                frontier.append((dst, ratio * blk.ratio))
        return routes

    def _deliver(self, rec: _InFlight, deferred: list | None = None) -> None:
        if rec.batch is None:
            return self._deliver_one(rec, deferred)
        # batched record: ONE host array per sink port for the whole batch
        # (leading [S] axis), then S logical deliveries from host slices
        by_uname = {b.unique_name: b for b in self.compiled.order}
        host_cache: dict[str, dict[str, np.ndarray]] = {}
        skip_slice = set()
        for uname, ins in rec.sink_ins.items():
            block = by_uname.get(uname)
            if block is None:
                continue
            if getattr(block, "WANTS_HOST_DATA", True) \
                    or getattr(block, "EMITS_HOST_TAGS", False):
                host_cache[uname] = self._to_host(rec, ins)
            elif getattr(block, "CONSUME_IGNORES_DATA", False):
                skip_slice.add(uname)
        for k, meta in enumerate(rec.batch):
            sub_ins = {
                uname: (ins if uname in skip_slice else
                        {p: (host_cache[uname][p][k] if uname in host_cache
                             else a[k])
                         for p, a in ins.items()})
                for uname, ins in rec.sink_ins.items()}
            self._deliver_one(_InFlight(
                step=meta.step, sink_ins=sub_ins, sink_tags=meta.sink_tags,
                n_valid=meta.n_valid, abs_in=meta.abs_in,
                n_valid_ports=meta.n_valid_ports,
                event=rec.event),
                deferred, pre_host=set(host_cache))

    def _deliver_one(self, rec: _InFlight, deferred: list | None = None,
                     pre_host: set[str] = frozenset()) -> None:
        """Hand one logical step's sink inputs to the sinks. ``pre_host``:
        sinks whose arrays already landed on the host (batched delivery)."""
        c = self.compiled
        by_uname = {b.unique_name: b for b in c.order}
        landed: dict[str, dict[str, np.ndarray]] = {}

        def host(uname):
            if uname in pre_host:
                return dict(rec.sink_ins[uname])
            if uname not in landed:
                landed[uname] = self._to_host(rec, rec.sink_ins[uname])
            return landed[uname]

        with self.profiler.duration("scheduler.deliver", step=rec.step):
            # pass 1: data-derived tags from emitting blocks (topological) —
            # computed on landed host data, routed to downstream consumers
            late: dict[str, dict[str, list[Tag]]] = {}
            for b in c.order:
                uname = b.unique_name
                if uname not in rec.sink_ins or \
                        not getattr(b, "EMITS_HOST_TAGS", False):
                    continue
                emitted = b.host_emit_tags(
                    host(uname), rec.sink_tags.get(uname, {}),
                    rec.n_valid.get(uname, c.in_len[uname]),
                    rec.abs_in.get(uname, 0))
                if not emitted:
                    continue
                for dst, port, ratio in self._late_tag_routes(c, uname):
                    bucket = late.setdefault(dst, {}).setdefault(port, [])
                    bucket += [t if ratio == 1 else t.rescaled(ratio)
                               for t in emitted]
            for uname, ins in rec.sink_ins.items():
                # None: the block was zombie-pruned after this step's dispatch
                block = by_uname.get(uname)
                if block is None or not (isinstance(block, SinkBlock)
                                         or getattr(block, "HOST_TAP", False)):
                    continue
                if getattr(block, "WANTS_HOST_DATA", True):
                    arrays = host(uname)
                else:  # metrics-only sink: device tensors, no copy
                    arrays = dict(ins)
                tags = rec.sink_tags.get(uname, {})
                if uname in late:
                    tags = {p: sorted(list(tags.get(p, [])) + extra)
                            for p, extra in late[uname].items()} | \
                           {p: v for p, v in tags.items()
                            if p not in late[uname]}
                nv = rec.n_valid.get(uname, c.in_len[uname])
                if getattr(block, "PER_PORT_VALID", False):
                    nv = rec.n_valid_ports.get(uname) or \
                        {p.name: nv for p in block.in_ports}
                try:
                    with self.profiler.duration("block.consume", block=block.name,
                                                step=rec.step):
                        block.consume(arrays, tags, nv, rec.abs_in.get(uname, 0))
                except Exception as err:
                    if deferred is not None:
                        # async worker: zombie pruning mutates the graph —
                        # marshal to the pump thread instead of acting here
                        deferred.append((block, err, "consume"))
                        continue
                    if not self._contain_block_error(block, err, "consume"):
                        raise

    # -- tags ------------------------------------------------------------------
    def _advance_tags(self, n_valid: dict[str, int]) -> dict[str, dict[str, list[Tag]]]:
        c = self.compiled
        edge_tags: dict[tuple[str, str], list[Tag]] = {}
        sink_tags: dict[str, dict[str, list[Tag]]] = {}
        in_edges = c.in_edges
        # one-shot per-step work that can inject tags outside the propagation
        # walk: pending forward-on-apply publishes and fresh source EOS
        pending = self._pending_out_tags
        new_eos = [u for u in self._finished_sources
                   if u not in self._eos_announced]
        for b, uname, in_keys, fast, is_sink, out_names, is_src in c.tag_plan():
            in_tags: dict[str, list[Tag]] = {}
            any_in = False
            for sk, dp in in_keys:
                ts = edge_tags.get(sk)
                in_tags[dp] = list(ts) if ts else []
                any_in = any_in or bool(ts)
            # steady-state fast path: no incoming tags, stock propagation, no
            # host tag emission — nothing below can produce output tags
            if fast and not any_in:
                if pending:
                    for pn in out_names:
                        pend = pending.pop((uname, pn), None)
                        if pend:
                            edge_tags[(uname, pn)] = list(pend)
                if is_src and new_eos and uname in new_eos:
                    self._eos_announced.add(uname)
                    t = Tag(n_valid.get(uname, 0), {Keys.END_OF_STREAM: True})
                    for pn in out_names:
                        edge_tags.setdefault((uname, pn), []).append(t)
                if is_sink:
                    sink_tags[uname] = in_tags
                continue
            hc = HostCtx(step=self._step,
                         in_len={p.name: c.in_len[uname] for p in b.in_ports},
                         out_len={p.name: c.out_len[uname] for p in b.out_ports},
                         sample_rate=c.block_ctx[uname].sample_rate,
                         abs_index=self._abs_in[uname])
            # auto-update settings from incoming tag maps (Settings.hpp:329);
            # changes to SAMPLE_ACCURATE dynamic params additionally become
            # per-sample ramps applied at the exact tag index THIS step
            events: list[tuple[int, dict]] = []
            for tags in in_tags.values():
                for t in tags:
                    hits = b.settings.auto_update(t.map)
                    if hits and (b.SAMPLE_ACCURATE & hits.keys()):
                        events.append((int(t.index), hits))
                    if Keys.CONTEXT in t.map:
                        b.settings.activate_context(SettingsCtx(
                            time=float(t.map.get(Keys.CTX_TIME, 0.0)),
                            context=str(t.map[Keys.CONTEXT])))
                    elif Keys.CTX_TIME in t.map:
                        # bare ctx_time advances the preset clock
                        b.settings.activate_context_for_time(
                            float(t.map[Keys.CTX_TIME]))
            if events:
                if "sp" in getattr(self.mesh, "axis_names", ()):
                    # a per-sample ramp is a full-step-length param, which
                    # the time shards cannot split: under sp the change
                    # applies at the next step boundary
                    self.bus.notify(b.name, "TagSettings",
                                    {"note": "sample-accurate ramp skipped "
                                             "under sp sharding; applied at "
                                             "the next step boundary"})
                else:
                    # sort by index only (stable: arrival order for ties)
                    self._tag_ramps[uname] = sorted(events, key=lambda e: e[0])
            # device-visible tag path: blocks that gate on tags on the device
            # (WANTS_TAG_ARRAYS) receive this step's input tags; their
            # prepare_params packs them into fixed-capacity TagArrays
            # (capacity = max_tags_per_step)
            if getattr(b, "WANTS_TAG_ARRAYS", False):
                b._step_in_tags = [t for ts in in_tags.values() for t in ts]
                b._tag_capacity = self.max_tags_per_step
            out_tags = b.process_tags(in_tags, hc)
            # source-emitted tags (host hook, e.g. TagSource)
            for t in b.emit_tags(hc):
                for p in b.out_ports:
                    out_tags.setdefault(p.name, []).append(t)
            # EOS tag when this source just finished (Tag.hpp end_of_stream);
            # "source" = no CONNECTED inputs
            if (not in_edges[uname] and uname in self._finished_sources
                    and uname not in self._eos_announced):
                self._eos_announced.add(uname)
                for p in b.out_ports:
                    out_tags.setdefault(p.name, []).append(
                        Tag(n_valid.get(uname, 0), {Keys.END_OF_STREAM: True}))
            # forward-on-apply settings published as tags (pending from apply)
            for p in b.out_ports:
                pend = self._pending_out_tags.pop((uname, p.name), None)
                if pend:
                    out_tags.setdefault(p.name, []).extend(pend)
                edge_tags[(uname, p.name)] = out_tags.get(p.name, [])
            if is_sink:
                sink_tags[uname] = in_tags
        return sink_tags

    # -- settings --------------------------------------------------------------
    def _apply_staged_settings(self, exclude: set[str] = frozenset(),
                               defer_state_reset: list | None = None
                               ) -> list[str]:
        """Apply staged settings on every block. Returns the unique_names of
        blocks whose settings actually changed (the batched pump snapshots
        their params per sub-step). With ``defer_state_reset`` (batched
        planning), requested state resets are recorded there instead of
        applied, and land at the super-step boundary."""
        applied_unames: list[str] = []
        if self.compiled is None:
            return applied_unames
        for b in self.compiled.order:
            if b.unique_name in exclude or not b.settings.changed():
                continue
            res = b.settings.apply_staged()
            self.compiled.invalidate_params()
            b.on_settings_applied(res)
            if getattr(b, "_state_reset", False):
                # block asked for a fresh state after this settings change
                b._state_reset = False
                if defer_state_reset is not None:
                    defer_state_reset.append(b)
                else:
                    self._states[b.unique_name] = b.init_state(
                        self.compiled.block_ctx[b.unique_name])
            if res.static_changed:
                self._dirty = True
            if res.forward:
                for p in b.out_ports:
                    self._pending_out_tags.setdefault(
                        (b.unique_name, p.name), []).append(Tag(0, dict(res.forward)))
            if res.applied:
                applied_unames.append(b.unique_name)
                self.bus.notify(b.name, Property.SETTING, dict(res.applied))
        return applied_unames

    # -- messages --------------------------------------------------------------
    def _process_messages(self) -> None:
        for msg in self.bus.drain_inbox():
            try:
                self._handle_message(msg)
            except Exception as e:
                self.bus.reply(msg, Error.here(str(e)))

    def _handle_message(self, msg: Message) -> None:
        if msg.service_name in ("", self.name):
            self._handle_scheduler_message(msg)
            return
        block = self._find_block(msg.service_name)
        if block is None:
            self.bus.reply(msg, Error.here(f"no block named {msg.service_name!r}"))
            return
        ep, cmd, data = msg.endpoint, msg.command, msg.data or {}
        if ep == Property.HEARTBEAT:
            self.bus.reply(msg, {"heartbeat": time.time()})
        elif ep == Property.ECHO:
            self.bus.reply(msg, dict(data))
        elif ep == Property.SETTING:
            if cmd is Command.Set:
                unknown = block.settings.set(dict(data))
                if unknown:
                    self.bus.reply(msg, Error.here(f"unknown keys {sorted(unknown)}"))
                    return
            self.bus.reply(msg, block.settings.as_dict())
        elif ep == Property.STAGED_SETTING:
            if cmd is Command.Set:
                block.settings.set(dict(data))
            self.bus.reply(msg, dict(block.settings._staged))
        elif ep == Property.STORE_DEFAULTS:
            block.settings.store_defaults()
            self.bus.reply(msg, {})
        elif ep == Property.RESET_DEFAULTS:
            block.settings.reset_defaults()
            self.bus.reply(msg, {})
        elif ep == Property.ACTIVE_CONTEXT:
            if cmd is Command.Set:
                ctx = SettingsCtx(time=float(data.get("time", 0.0)),
                                  context=str(data.get("context", "")))
                # Set creates-and-activates (≈ Block.hpp kActiveContext Set)
                if ctx.context:
                    block.settings._contexts.setdefault(ctx, {})
                block.settings.activate_context(ctx)
            ctx = block.settings.active_context
            self.bus.reply(msg, {"context": ctx.context, "time": ctx.time})
        elif ep == Property.SETTINGS_CONTEXTS:
            if cmd is Command.Set:       # create/store a context preset
                ctx = SettingsCtx(time=float(data.get("time", 0.0)),
                                  context=str(data.get("context", "")))
                block.settings.set(dict(data.get("properties", {})), ctx=ctx)
                block.settings._contexts.setdefault(ctx, {})
            elif cmd is Command.Disconnect:   # remove (≈ kSettingsCtx removal)
                ctx = SettingsCtx(time=float(data.get("time", 0.0)),
                                  context=str(data.get("context", "")))
                if not block.settings.remove_context(ctx):
                    self.bus.reply(msg, Error.here(
                        f"no stored context {ctx.context!r}"))
                    return
            ctxs = block.settings.stored_contexts()
            self.bus.reply(msg, {"contexts": [c.context for c in ctxs],
                                 "times": [c.time for c in ctxs]})
        elif ep == Property.META_INFORMATION:
            self.bus.reply(msg, {
                "type": type(block).__name__, "name": block.name,
                "unique_name": block.unique_name,
                "settings": {k: s.description for k, s in block.settings.spec.items()}})
        elif ep == Property.INSPECT_BLOCK:
            self.bus.reply(msg, _inspect_block(block))
        elif ep == Property.LIFECYCLE_STATE:
            self.bus.reply(msg, {"state": self.fsm.state.value})
        elif cmd in (Command.Subscribe, Command.Unsubscribe):
            # applied-settings notifications already flow to the outbox;
            # acknowledge the (un)subscription
            self.bus.reply(msg, {"endpoint": ep}, command=Command.Ready)
        else:
            self.bus.reply(msg, Error.here(f"unknown endpoint {ep!r}"))

    def _handle_scheduler_message(self, msg: Message) -> None:
        ep, cmd, data = msg.endpoint, msg.command, msg.data or {}
        if ep == Property.LIFECYCLE_STATE:
            if cmd is Command.Set:
                target = State(data["state"])
                if target is State.REQUESTED_STOP:
                    self.request_stop()
                elif target is State.REQUESTED_PAUSE:
                    self.request_pause()
                elif target is State.RUNNING:
                    self.resume()
                else:
                    self.fsm.transition_to(target)
            self.bus.reply(msg, {"state": self.fsm.state.value})
        elif ep == Property.HEARTBEAT:
            self.bus.reply(msg, {"heartbeat": time.time()})
        elif ep == Property.INSPECT_GRAPH:
            g = self.compiled.graph if self.compiled else self.graph
            self.bus.reply(msg, {
                "blocks": [{"name": b.name, "unique_name": b.unique_name,
                            "type": type(b).__name__} for b in g.blocks],
                "edges": [{"src": e.src.name, "src_port": e.src_port,
                           "dst": e.dst.name, "dst_port": e.dst_port,
                           "samples_per_step": e.samples_per_step}
                          for e in g.edges]})
        elif ep == Property.REGISTRY_BLOCK_TYPES:
            self.bus.reply(msg, {"types": sorted(global_registry.known_blocks())})
        elif ep == Property.EMPLACE_BLOCK:
            b = self.graph.emplace(data["type"], **data.get("properties", {}))
            self._dirty = True
            self.bus.reply(msg, {"unique_name": b.unique_name, "name": b.name})
        elif ep == Property.REMOVE_BLOCK:
            b = self._find_block(data["name"])
            if b is None:
                raise GrError(f"no block {data['name']!r}")
            self.graph.remove(b)
            self._dirty = True
            self.bus.reply(msg, {})
        elif ep == Property.REPLACE_BLOCK:
            # ≈ kReplaceBlock (Scheduler.hpp:227-238): a new block takes over
            # the old one's name and connections; recompile at the boundary
            old = self._find_block(data["name"])
            if old is None:
                raise GrError(f"replace: no block {data['name']!r}")
            new = self.graph.registry.create(data["type"],
                                             **data.get("properties", {}))
            new.name = old.name
            # validate EVERY rewired port before mutating anything
            for e in self.graph.edges:
                if e.src is old:
                    new.port(e.src_port, output=True)
                if e.dst is old:
                    new.port(e.dst_port, output=False)
            for e in self.graph.edges:
                if e.src is old:
                    e.src = new
                if e.dst is old:
                    e.dst = new
            self.graph.blocks[self.graph.blocks.index(old)] = new
            self.graph.message_edges = [
                (new if s is old else s, new if d is old else d)
                for s, d in self.graph.message_edges]
            self._dirty = True
            self.bus.reply(msg, {"unique_name": new.unique_name,
                                 "name": new.name})
        elif ep == Property.EMPLACE_EDGE:
            src = self._find_block(data["src"])
            dst = self._find_block(data["dst"])
            if src is None or dst is None:
                raise GrError("emplace edge: unknown block")
            self.graph.connect(src, dst, src_port=data.get("src_port"),
                               dst_port=data.get("dst_port"))
            self._dirty = True
            self.bus.reply(msg, {})
        elif ep == Property.REMOVE_EDGE:
            before = len(self.graph.edges)
            self.graph.edges = [
                e for e in self.graph.edges
                if not (e.src.name == data["src"] and e.dst.name == data["dst"])]
            if len(self.graph.edges) == before:
                raise GrError("remove edge: no match")
            self._dirty = True
            self.bus.reply(msg, {})
        elif ep == Property.GRAPH_GRC:
            # ≈ kGraphGRC (Scheduler.hpp:233): Get returns the running graph
            # as GRC YAML; Set hot-swaps the WHOLE flowgraph from YAML (new
            # graph compiles at the next step boundary, fresh states)
            from .yaml_io import load_grc, save_grc
            if cmd is Command.Set:
                new_graph = load_grc(str(data["grc"]),
                                     registry=self.graph.registry)
                self.graph = new_graph
                self._states = {}
                self._abs_in.clear()
                self._abs_out.clear()
                self._finished_sources.clear()
                self._eos_announced.clear()
                self._inflight.clear()
                self._dirty = True
                self.bus.reply(msg, {"blocks": len(new_graph.blocks)})
            else:
                self.bus.reply(msg, {"grc": save_grc(
                    self.graph, sample_rate=self.sample_rate,
                    block_len=self.block_len)})
        else:
            self.bus.reply(msg, Error.here(f"unknown scheduler endpoint {ep!r}"))

    def _find_block(self, name: str) -> Block | None:
        for b in self.graph.blocks:
            if b.name == name or b.unique_name == name:
                return b
        if self.compiled:
            for b in self.compiled.order:
                if b.name == name or b.unique_name == name:
                    return b
        return None

    # -- watchdog (≈ Scheduler.hpp:845) ---------------------------------------
    def _start_watchdog(self) -> None:
        if self.watchdog_timeout is None or self._watchdog is not None:
            return

        def monitor():
            while self.fsm.state in (State.RUNNING, State.REQUESTED_PAUSE,
                                     State.PAUSED, State.INITIALISED):
                time.sleep(self.watchdog_timeout / 4)
                if (self.fsm.state is State.RUNNING
                        and time.monotonic() - self._last_progress > self.watchdog_timeout
                        and not self._stall_flagged):
                    self._stall_flagged = True
                    stalled_s = time.monotonic() - self._last_progress
                    self.bus.notify(self.name, "Watchdog",
                                    {"stalled_for_s": stalled_s,
                                     "step": self._step})
                    if self.watchdog_action == "stop":
                        # ≈ the reference watchdog escalating on
                        # non-responsive blocks: wind the graph down
                        self.request_stop()
                    elif self.watchdog_action == "error":
                        # collective-timeout escalation: a pump wedged inside
                        # a collective cannot be unwound from Python — a dead
                        # peer process can leave the survivor blocked in the
                        # process group until its timeout. Mark the run
                        # failed NOW so waiters fail fast and diagnosably;
                        # the wedged pump thread is abandoned (daemon)
                        msg = (f"watchdog: no progress for {stalled_s:.1f}s "
                               f"at step {self._step}"
                               + (" — collective timeout: a peer process "
                                  "has likely died or partitioned "
                                  f"(process {self.mesh.process_index} of "
                                  f"{self.mesh.process_count})"
                                  if self._multihost else
                                  " — pump stalled (device hang or wedged "
                                  "host feeder)"))
                        self.error = Error.here(msg, block=self.name)
                        self.bus.notify(self.name, "Error", {"message": msg})
                        self.fsm.force_error()
                        return

        self._watchdog = thread_pool.spawn(monitor, name=f"{self.name}-watchdog")

    def _call_hooks(self, which: str) -> None:
        if self.compiled is None:
            return
        for b in self.compiled.order:
            try:
                getattr(b, which)()
            except Exception as e:
                self.error = Error.here(f"{b.name}.{which}(): {e}", block=b.name)
                self.bus.notify(b.name, "Error", {"message": str(e)})


def _remove_deep(g: Graph, block: Block) -> bool:
    """Remove a block from ``g`` or any nested subgraph (+ dangling exports)."""
    if block in g.blocks:
        g.remove(block)
        g._exports_in = {k: v for k, v in g._exports_in.items()
                         if v[0] is not block}
        g._exports_out = {k: v for k, v in g._exports_out.items()
                          if v[0] is not block}
        return True
    for b in g.blocks:
        if isinstance(b, Graph) and _remove_deep(b, block):
            return True
    return False


def _pad_to(a: np.ndarray, shape: tuple[int, ...], dtype) -> np.ndarray:
    """Zero-pad a host-fed array up to the static per-step shape (partial final block)."""
    a = np.asarray(a, dtype=dtype)
    if a.shape == tuple(shape):
        return a
    out = np.zeros(shape, dtype=dtype)
    sl = tuple(slice(0, min(s, t)) for s, t in zip(a.shape, shape))
    out[sl] = a[sl]
    return out


def _refit_feeds(feeds: dict, zero: dict) -> dict:
    """Planned feeds → the feed signature of a recompiled graph: entries of
    pruned blocks dropped, arrays cut or zero-padded to the new step shape."""
    return {uname: {p: _pad_to(np.asarray(a)[..., :zero[uname][p].shape[-1]],
                               zero[uname][p].shape, zero[uname][p].dtype)
                    for p, a in fd.items() if p in zero[uname]}
            for uname, fd in feeds.items() if uname in zero}


def _stack_feeds(feeds_list: list[dict], zero: dict) -> dict:
    """S sub-steps' feeds → ``{uname: {port: [S, ...]}}``; a port missing in
    some sub-steps is zero-filled there."""
    if not feeds_list or not feeds_list[0]:
        return {}
    out: dict[str, dict[str, np.ndarray]] = {}
    for uname in feeds_list[0]:
        ports = {p for fl in feeds_list for p in fl.get(uname, {})}
        out[uname] = {p: np.stack([fl.get(uname, {}).get(p, zero[uname][p])
                                   for fl in feeds_list])
                      for p in ports}
    return out


def _same_struct(a: Any, b: Any) -> bool:
    """Same nesting, and tensors of the same shape, dtype and device."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_struct(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_struct(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a) and torch.is_tensor(b):
        return a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
    return type(a) is type(b)


def _inspect_block(block: Block) -> dict[str, Any]:
    return {
        "name": block.name,
        "unique_name": block.unique_name,
        "type": type(block).__name__,
        "inputs": [p.name for p in block.in_ports],
        "outputs": [p.name for p in block.out_ports],
        "settings": block.settings.as_dict(),
        "ratio": [block.ratio.numerator, block.ratio.denominator],
    }


@register_scheduler("Simple")
class SimpleScheduler(Scheduler):
    """Insertion-order scheduling (≈ gr::scheduler::Simple, Scheduler.hpp:1514).
    With one device program per step, execution order is the topological
    order — the policy distinction only affects the host tag walk, which is
    already topological."""


@register_scheduler("BreadthFirst")
class BreadthFirstScheduler(Scheduler):
    """≈ gr::scheduler::BreadthFirst (Scheduler.hpp:1580); same execution."""


@register_scheduler("DepthFirst")
class DepthFirstScheduler(Scheduler):
    """≈ gr::scheduler::DepthFirst (Scheduler.hpp:1658); same execution,
    kept for API parity."""
