"""Message / property control plane.

Reference: Majordomo-shaped ``gr::Message`` records flowing over message ports
(core/include/gnuradio-4.0/Message.hpp:53), with ``Command`` verbs (:24) and 13
standard per-block property endpoints (Block.hpp:520-576); the scheduler pumps
messages between stream work (Scheduler.hpp:471).

Design: messages are host-side dataclasses on a thread-safe queue the scheduler
drains between steps (the device step never sees them — settings changes land as
new step parameters or a recompile at the step boundary). The same endpoints exist so external
code / UIs can Get/Set/Subscribe exactly like against the reference.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import queue
import threading
from typing import Any, Callable

from .errors import Error


class Command(enum.Enum):
    """≈ gr::message::Command (Message.hpp:24)."""

    Invalid = "Invalid"
    Get = "Get"
    Set = "Set"
    Subscribe = "Subscribe"
    Unsubscribe = "Unsubscribe"
    Notify = "Notify"
    Ready = "Ready"
    Disconnect = "Disconnect"
    Heartbeat = "Heartbeat"
    Partial = "Partial"
    Final = "Final"


# standard property endpoints (≈ Block.hpp:520-576 / Scheduler.hpp:223-238)
class Property:
    HEARTBEAT = "Heartbeat"
    ECHO = "Echo"
    LIFECYCLE_STATE = "LifecycleState"
    SETTING = "Setting"
    STAGED_SETTING = "StagedSetting"
    STORE_DEFAULTS = "StoreDefaults"
    RESET_DEFAULTS = "ResetDefaults"
    ACTIVE_CONTEXT = "ActiveContext"
    SETTINGS_CONTEXTS = "SettingsContexts"
    META_INFORMATION = "MetaInformation"
    INSPECT_BLOCK = "InspectBlock"
    INSPECT_GRAPH = "InspectGraph"
    REGISTRY_BLOCK_TYPES = "RegistryBlockTypes"  # (Graph.hpp:51)
    EMPLACE_BLOCK = "EmplaceBlock"
    REMOVE_BLOCK = "RemoveBlock"
    REPLACE_BLOCK = "ReplaceBlock"
    EMPLACE_EDGE = "EmplaceEdge"
    REMOVE_EDGE = "RemoveEdge"
    GRAPH_GRC = "GraphGRC"          # whole-graph YAML get/swap (kGraphGRC)


_msg_ids = itertools.count(1)


@dataclasses.dataclass
class Message:
    """≈ gr::Message (Message.hpp:53). ``data`` is a property map or an Error."""

    command: Command = Command.Invalid
    service_name: str = ""       # target block name ("" = scheduler itself)
    endpoint: str = ""           # property name
    data: dict[str, Any] | Error | None = None
    client_request_id: str = ""
    protocol: str = "mdp/0.1"
    rbac: str = ""

    def __post_init__(self):
        if not self.client_request_id:
            self.client_request_id = f"req-{next(_msg_ids)}"

    @property
    def is_error(self) -> bool:
        return isinstance(self.data, Error)


class MessageBus:
    """Thread-safe in/out message queues + subscription fan-out."""

    def __init__(self):
        self.inbox: "queue.Queue[Message]" = queue.Queue()
        self.outbox: "queue.Queue[Message]" = queue.Queue()
        self._subs: dict[str, list[Callable[[Message], None]]] = {}
        self._lock = threading.Lock()

    # client-facing ------------------------------------------------------------
    def send(self, msg: Message) -> str:
        self.inbox.put(msg)
        return msg.client_request_id

    def send_command(self, command: Command, service: str = "", endpoint: str = "",
                     data: dict[str, Any] | None = None) -> str:
        return self.send(Message(command=command, service_name=service,
                                 endpoint=endpoint, data=data or {}))

    def receive(self, timeout: float | None = None) -> Message | None:
        try:
            return self.outbox.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain_replies(self) -> list[Message]:
        out = []
        while True:
            try:
                out.append(self.outbox.get_nowait())
            except queue.Empty:
                return out

    def subscribe(self, endpoint: str, cb: Callable[[Message], None]) -> None:
        with self._lock:
            self._subs.setdefault(endpoint, []).append(cb)

    def unsubscribe(self, endpoint: str, cb: Callable[[Message], None]) -> None:
        with self._lock:
            if cb in self._subs.get(endpoint, []):
                self._subs[endpoint].remove(cb)

    # scheduler-facing ---------------------------------------------------------
    def pending(self) -> bool:
        return not self.inbox.empty()

    def drain_inbox(self) -> list[Message]:
        out = []
        while True:
            try:
                out.append(self.inbox.get_nowait())
            except queue.Empty:
                return out

    def reply(self, request: Message, data: dict[str, Any] | Error,
              command: Command = Command.Final) -> None:
        msg = Message(command=command, service_name=request.service_name,
                      endpoint=request.endpoint, data=data,
                      client_request_id=request.client_request_id)
        self.outbox.put(msg)
        self._notify(msg)

    def notify(self, service: str, endpoint: str, data: dict[str, Any]) -> None:
        msg = Message(command=Command.Notify, service_name=service,
                      endpoint=endpoint, data=data)
        self.outbox.put(msg)
        self._notify(msg)

    def _notify(self, msg: Message) -> None:
        with self._lock:
            subs = list(self._subs.get(msg.endpoint, ()))
        for cb in subs:
            cb(msg)
