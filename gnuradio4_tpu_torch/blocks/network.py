"""TCP stream transport blocks: raw sample streams over sockets.

Beyond the reference's blocklib (its cross-machine IO is HTTP/file only,
SURVEY §2.6) — the classic gr-zeromq/gr-network capability, dependency-free:
TCP is a byte pipe; samples travel as raw little-endian arrays of the
configured dtype. ``TcpSource``/``TcpSink`` can each either listen or connect,
so either end of a link may be the server. Two processes of this port or of
the JAX package (or any GNU Radio flowgraph with a TCP sink/source)
interconnect directly. The sources' socket reads run on an IO thread into the
native ring (``core/feeder.py``), which holds two of the scheduler's steps.
"""

from __future__ import annotations

import socket
import threading

import numpy as np

from ..core.block import Block, Port, SinkBlock, SourceBlock
from ..core.errors import GrError
from ..core.feeder import ThreadedFeeder, read_exact
from ..core.registry import register_block
from ..core.settings import Setting


class _Listener:
    """Bind+listen eagerly (at block start, before the pump), accept lazily —
    so a connecting peer that starts first just lands in the backlog."""

    def __init__(self, host: str, port: int):
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind((host or "127.0.0.1", port))
        self.srv.listen(1)

    def accept(self, timeout: float) -> socket.socket:
        self.srv.settimeout(timeout)
        try:
            conn, _ = self.srv.accept()
        finally:
            self.srv.close()
        return conn


def _ring_items(n: int) -> int:
    """Items of a source's ring: two steps of ``n``, at least 2^20, so that a
    step longer than the ring never waits for data it cannot hold."""
    return max(1 << 20, 2 * n)


def _connect_retry(host: str, port: int, timeout: float) -> socket.socket:
    """Connect with retries — the peer's listener may not be up yet."""
    import time
    deadline = time.monotonic() + timeout
    while True:
        try:
            return socket.create_connection((host or "127.0.0.1", port),
                                            timeout=1.0)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


@register_block("TcpSource")
class TcpSource(SourceBlock):
    """Receives a raw sample stream from a TCP peer (listen or connect);
    socket reads run on the IO thread into the host ring."""

    OUT = (Port("out"),)
    FEED = True
    host = Setting(default="127.0.0.1", kind="static")
    port = Setting(default=52001, kind="static")
    listen = Setting(default=True, kind="static",
                     description="True: accept one inbound connection; "
                                 "False: connect out")
    dtype = Setting(default="float32", kind="static",
                    choices=("float32", "complex64", "int16", "int32"))
    connect_timeout = Setting(default=30.0, kind="static")
    n_samples = Setting(default=0, kind="static", description="0 = until EOF")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._feeder: ThreadedFeeder | None = None
        self._sock: socket.socket | None = None
        self._listener: _Listener | None = None

    def out_dtype(self, port, in_dtypes):
        return np.dtype(str(self.settings.get("dtype")))

    def start(self):
        if bool(self.settings.get("listen")) and self._listener is None \
                and self._sock is None:
            self._listener = _Listener(str(self.settings.get("host")),
                                       int(self.settings.get("port")))

    def _ensure_feeder(self, n: int):
        if self._feeder is not None:
            return
        dt = np.dtype(str(self.settings.get("dtype")))
        to = float(self.settings.get("connect_timeout"))
        if bool(self.settings.get("listen")):
            self.start()
            self._sock = self._listener.accept(to)
        else:
            self._sock = _connect_retry(str(self.settings.get("host")),
                                        int(self.settings.get("port")), to)
        sock, itemsize = self._sock, dt.itemsize
        limit = int(self.settings.get("n_samples"))

        def frames():
            carry = b""
            served = 0
            while not limit or served < limit:
                try:
                    chunk = sock.recv(1 << 16)
                except OSError:
                    break
                if not chunk:
                    break
                buf = carry + chunk
                n_items = len(buf) // itemsize
                if n_items:
                    take = n_items * itemsize
                    arr = np.frombuffer(buf[:take], dtype=dt)
                    if limit:
                        arr = arr[: limit - served]
                    served += len(arr)
                    carry = buf[take:]
                    yield arr
                else:
                    carry = buf

        self._feeder = ThreadedFeeder(frames(), dt, capacity_items=_ring_items(n),
                                      name=f"{self.name}.tcp").start()

    def stop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._feeder is not None:
            self._feeder.stop()

    def host_feed(self, n, abs_index):
        if self._feeder is None:
            self._ensure_feeder(n)
        got = read_exact(self._feeder.ring, self._feeder.reader, n)
        if self._feeder.error is not None:
            raise GrError(f"{self.name}: TCP thread failed: "
                          f"{self._feeder.error}")
        if got is None:
            return None
        return {"out": got}, len(got)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("TcpSink")
class TcpSink(SinkBlock):
    """Sends the sample stream to a TCP peer as raw little-endian arrays."""

    IN = (Port("in"),)
    host = Setting(default="127.0.0.1", kind="static")
    port = Setting(default=52001, kind="static")
    listen = Setting(default=False, kind="static")
    connect_timeout = Setting(default=30.0, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._sock: socket.socket | None = None
        self._listener: _Listener | None = None
        self._lock = threading.Lock()

    def start(self):
        if bool(self.settings.get("listen")) and self._listener is None \
                and self._sock is None:
            self._listener = _Listener(str(self.settings.get("host")),
                                       int(self.settings.get("port")))

    def _ensure_sock(self):
        if self._sock is not None:
            return
        to = float(self.settings.get("connect_timeout"))
        if bool(self.settings.get("listen")):
            self.start()
            self._sock = self._listener.accept(to)
        else:
            self._sock = _connect_retry(str(self.settings.get("host")),
                                        int(self.settings.get("port")), to)

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        self._ensure_sock()
        data = np.ascontiguousarray(arrays["in"][..., :n_valid])
        with self._lock:
            try:
                self._sock.sendall(data.tobytes())
            except OSError as e:
                raise GrError(f"{self.name}: TCP send failed: {e}")

    def stop(self):
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


@register_block("UdpSource")
class UdpSource(SourceBlock):
    """Receives raw sample datagrams on a UDP port (lossy transport: dropped
    datagrams are simply absent from the stream — no reordering buffer)."""

    OUT = (Port("out"),)
    FEED = True
    host = Setting(default="127.0.0.1", kind="static")
    port = Setting(default=52002, kind="static")
    dtype = Setting(default="float32", kind="static",
                    choices=("float32", "complex64", "int16", "int32"))
    n_samples = Setting(default=0, kind="static", description="0 = endless")
    idle_timeout = Setting(default=30.0, kind="static",
                           description="stop after this long with no data")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._feeder: ThreadedFeeder | None = None
        self._sock: socket.socket | None = None

    def out_dtype(self, port, in_dtypes):
        return np.dtype(str(self.settings.get("dtype")))

    def start(self):
        if self._sock is None:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            # a small default kernel buffer drops datagrams whenever the host
            # pauses (GC, a kernel build); ask for 4 MB (kernel clamps to rmem_max)
            try:
                self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                      4 << 20)
            except OSError:
                pass
            self._sock.bind((str(self.settings.get("host")) or "127.0.0.1",
                             int(self.settings.get("port"))))
            self._sock.settimeout(float(self.settings.get("idle_timeout")))

    def _ensure_feeder(self, n: int):
        if self._feeder is not None:
            return
        self.start()
        dt = np.dtype(str(self.settings.get("dtype")))
        sock = self._sock
        limit = int(self.settings.get("n_samples"))

        def frames():
            served = 0
            while not limit or served < limit:
                try:
                    pkt = sock.recv(1 << 16)
                except (socket.timeout, OSError):
                    break
                n_items = len(pkt) // dt.itemsize
                if not n_items:
                    continue
                arr = np.frombuffer(pkt[: n_items * dt.itemsize], dtype=dt)
                if limit:
                    arr = arr[: limit - served]
                served += len(arr)
                yield arr

        self._feeder = ThreadedFeeder(frames(), dt, capacity_items=_ring_items(n),
                                      name=f"{self.name}.udp").start()

    def stop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._feeder is not None:
            self._feeder.stop()

    def host_feed(self, n, abs_index):
        if self._feeder is None:
            self._ensure_feeder(n)
        got = read_exact(self._feeder.ring, self._feeder.reader, n)
        if self._feeder.error is not None:
            raise GrError(f"{self.name}: UDP thread failed: "
                          f"{self._feeder.error}")
        if got is None:
            return None
        return {"out": got}, len(got)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("UdpSink")
class UdpSink(SinkBlock):
    """Sends the stream as UDP datagrams of ``payload_items`` samples."""

    IN = (Port("in"),)
    host = Setting(default="127.0.0.1", kind="static")
    port = Setting(default=52002, kind="static")
    payload_items = Setting(default=1024, kind="static", limits=(1, 8192))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._addr = None

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        if self._addr is None:
            self._addr = (str(self.settings.get("host")) or "127.0.0.1",
                          int(self.settings.get("port")))
        data = np.ascontiguousarray(arrays["in"][..., :n_valid])
        step = int(self.settings.get("payload_items"))
        flat = data.reshape(-1)
        for i in range(0, len(flat), step):
            try:
                self._sock.sendto(flat[i:i + step].tobytes(), self._addr)
            except OSError as e:
                raise GrError(f"{self.name}: UDP send failed: {e}")

    def stop(self):
        try:
            self._sock.close()
        except OSError:
            pass
