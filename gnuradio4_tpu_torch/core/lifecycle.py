"""Lifecycle finite-state machine.

Same state set and transition table as the reference scheduler/block lifecycle
(reference: core/include/gnuradio-4.0/LifeCycle.hpp:74 ``State`` enum, :108
``isValidTransition``), re-expressed as a small host-side Python FSM. The FSM
governs the *host streaming runtime* (graph compile, step pump); the device work
of a step is stateless apart from the block states the scheduler threads through.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable

from .errors import LifecycleError


class State(enum.Enum):
    IDLE = "IDLE"
    INITIALISED = "INITIALISED"
    RUNNING = "RUNNING"
    REQUESTED_PAUSE = "REQUESTED_PAUSE"
    PAUSED = "PAUSED"
    REQUESTED_STOP = "REQUESTED_STOP"
    STOPPED = "STOPPED"
    ERROR = "ERROR"


# transition table mirrors LifeCycle.hpp:108 isValidTransition
_VALID: dict[State, frozenset[State]] = {
    State.IDLE: frozenset({State.INITIALISED, State.ERROR}),
    State.INITIALISED: frozenset({State.RUNNING, State.REQUESTED_STOP, State.STOPPED, State.ERROR}),
    State.RUNNING: frozenset({State.REQUESTED_PAUSE, State.REQUESTED_STOP, State.ERROR}),
    State.REQUESTED_PAUSE: frozenset({State.PAUSED, State.REQUESTED_STOP, State.ERROR}),
    State.PAUSED: frozenset({State.RUNNING, State.REQUESTED_STOP, State.ERROR}),
    State.REQUESTED_STOP: frozenset({State.STOPPED, State.ERROR}),
    State.STOPPED: frozenset({State.INITIALISED, State.ERROR}),
    # ERROR is recoverable via reset → IDLE (LifeCycle.hpp:41-74)
    State.ERROR: frozenset({State.IDLE}),
}


def is_valid_transition(src: State, dst: State) -> bool:
    if src is dst:
        return True
    return dst in _VALID[src]


class StateMachine:
    """Thread-safe lifecycle FSM with user hooks.

    Hooks mirror the reference's CRTP ``start/stop/pause/resume/reset`` user methods
    (LifeCycle.hpp:143 ``StateMachine<Derived>``): register callables keyed by the
    *destination* state; they run inside the transition under the lock.
    """

    def __init__(self, initial: State = State.IDLE):
        self._state = initial
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._hooks: dict[State, list[Callable[[], None]]] = {}

    @property
    def state(self) -> State:
        with self._lock:
            return self._state

    def on(self, state: State, hook: Callable[[], None]) -> None:
        self._hooks.setdefault(state, []).append(hook)

    def transition_to(self, dst: State) -> State:
        with self._cv:
            src = self._state
            if src is dst:
                return dst
            if not is_valid_transition(src, dst):
                raise LifecycleError(f"invalid lifecycle transition {src.value} → {dst.value}")
            self._state = dst
            for hook in self._hooks.get(dst, ()):
                hook()
            self._cv.notify_all()
            return dst

    def force_error(self) -> None:
        with self._cv:
            self._state = State.ERROR
            self._cv.notify_all()

    def wait_for(self, *states: State, timeout: float | None = None) -> State:
        deadline_states = set(states)
        with self._cv:
            ok = self._cv.wait_for(lambda: self._state in deadline_states, timeout=timeout)
            if not ok:
                raise TimeoutError(f"timed out waiting for {deadline_states}, still {self._state}")
            return self._state
