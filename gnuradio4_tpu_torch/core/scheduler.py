"""Host streaming scheduler (≈ reference Scheduler.hpp, gr::scheduler::Simple).

The device does the stream compute in one step of the compiled graph
(compiler.py); the scheduler is a host pump that per step

  1. applies staged settings (a static change recompiles at the step boundary),
  2. works out how many samples of this step are valid (sources may end),
  3. runs the step on the graph's device,
  4. hands each sink its input tensors, synchronously: sinks that want host
     data get NumPy arrays (a device→host copy), metrics-only sinks get the
     device tensors.

This slice keeps the lifecycle FSM, ``run_and_wait``/``step_once`` and EOS by
source exhaustion. Messages, the tag walk, async delivery, the watchdog and
batched pumping come with later slices.
"""

from __future__ import annotations

from typing import Any

import torch

from .block import SinkBlock
from .compiler import CompiledGraph, compile_graph, default_device
from .errors import Error, GrError
from .graph import Graph
from .lifecycle import State, StateMachine


class Scheduler:
    """Single-device streaming scheduler."""

    def __init__(self, graph: Graph, *, block_len: int = 1 << 16,
                 sample_rate: float = 1.0,
                 device: torch.device | str | None = None,
                 name: str = "scheduler"):
        self.name = name
        self.graph = graph
        self.block_len = block_len
        self.sample_rate = sample_rate
        self.device = default_device() if device is None else torch.device(device)
        self.fsm = StateMachine()
        self.compiled: CompiledGraph | None = None
        self.states: dict[str, Any] = {}
        self._dirty = True
        self._step = 0
        self._abs_in: dict[str, int] = {}
        self._abs_out: dict[str, int] = {}
        self._finished_sources: set[str] = set()
        self.error: Error | None = None

    @property
    def state(self) -> State:
        return self.fsm.state

    @property
    def steps(self) -> int:
        return self._step

    def init(self) -> None:
        """Compile the graph and create its states (≈ changeStateTo(INITIALISED))."""
        if self.fsm.state is State.IDLE:
            self._recompile(reset_state=True)
            self.fsm.transition_to(State.INITIALISED)

    def run_and_wait(self, n_steps: int | None = None) -> None:
        """Run the pump on the calling thread for ``n_steps`` steps, or until
        every source has ended (≈ runAndWait, Scheduler.hpp:515)."""
        self.init()
        self.fsm.transition_to(State.RUNNING)
        try:
            while n_steps is None or self._step < n_steps:
                if not self._pump_once():
                    break
        except Exception as e:
            self.error = Error.here(str(e))
            self.fsm.force_error()
            raise
        self.fsm.transition_to(State.REQUESTED_STOP)
        self.fsm.transition_to(State.STOPPED)

    def step_once(self) -> bool:
        """Advance the graph by exactly one step under external control
        (≈ ExecutionPolicy::externalStep). Returns False once the stream ended."""
        if self.fsm.state is State.IDLE:
            self.init()
        if self.fsm.state is State.INITIALISED:
            self.fsm.transition_to(State.RUNNING)
        if self.fsm.state is not State.RUNNING:
            raise GrError(f"step_once in state {self.fsm.state.name}")
        more = self._pump_once()
        if not more:
            self.fsm.transition_to(State.REQUESTED_STOP)
            self.fsm.transition_to(State.STOPPED)
        return more

    def _recompile(self, *, reset_state: bool) -> None:
        old = None if reset_state else self.states
        self.compiled = compile_graph(self.graph, block_len=self.block_len,
                                      sample_rate=self.sample_rate,
                                      device=self.device)
        self.states = self.compiled.init_states()
        for k, v in (old or {}).items():
            if k in self.states:
                self.states[k] = v
        for b in self.compiled.order:
            self._abs_in.setdefault(b.unique_name, 0)
            self._abs_out.setdefault(b.unique_name, 0)
        self._dirty = False

    def _apply_staged_settings(self) -> None:
        for b in self.compiled.order:
            if not b.settings.changed():
                continue
            res = b.settings.apply_staged()
            self.compiled.invalidate_params()
            if res.static_changed:
                self._dirty = True

    def _valid_counts(self, c: CompiledGraph) -> dict[str, int]:
        """This step's valid sample count per block: sources may end
        (host_done); every other block sees the least of its inputs, mapped
        through its rate ratio."""
        n_valid: dict[str, int] = {}
        for b in c.order:
            uname = b.unique_name
            srcs = c.in_edges[uname]
            if not srcs:
                if uname in self._finished_sources:
                    n_valid[uname] = 0
                    continue
                done = b.host_done(self._abs_out[uname], c.out_len[uname])
                if done is not None and done <= c.out_len[uname]:
                    n_valid[uname] = max(0, done)
                    self._finished_sources.add(uname)
                else:
                    n_valid[uname] = c.out_len[uname]
                continue
            nv_in = min(n_valid[e.src.unique_name] for e in srcs)
            r = b.ratio
            n_valid[uname] = nv_in if r == 1 else nv_in * r.numerator // r.denominator
        return n_valid

    def _pump_once(self) -> bool:
        """One scheduler step. Returns False on EOS completion."""
        self._apply_staged_settings()
        if self._dirty:
            self._recompile(reset_state=False)
        c = self.compiled
        n_valid = self._valid_counts(c)
        sources = [b.unique_name for b in c.order if not c.in_edges[b.unique_name]]
        if sources and all(n_valid[u] == 0 for u in sources):
            return False
        self.states, sink_ins = c.step(self.states, c.gather_params())
        for b in c.order:
            uname = b.unique_name
            if uname not in sink_ins or not isinstance(b, SinkBlock):
                continue
            ins = sink_ins[uname]
            if b.WANTS_HOST_DATA:
                arrays = {p: t.detach().cpu().numpy() for p, t in ins.items()}
            else:
                arrays = dict(ins)
            # valid counts are block-output counts; a sink receives its
            # upstream's output, whose count is the sink's (ratio-1) input count
            b.consume(arrays, {}, n_valid[uname], self._abs_in[uname])
        for b in c.order:
            self._abs_in[b.unique_name] += c.in_len[b.unique_name]
            self._abs_out[b.unique_name] += c.out_len[b.unique_name]
        self._step += 1
        return not (sources and all(u in self._finished_sources for u in sources))
