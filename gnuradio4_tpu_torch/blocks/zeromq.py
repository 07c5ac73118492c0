"""ZeroMQ stream transports (≈ gr-zeromq, which GNU Radio users lean on
for inter-process flowgraph plumbing; absent from the reference blocklib).

Wire format matches gr-zeromq's default: each ZMQ message is a raw
little-endian sample buffer (no header). PUSH/PULL gives load-balanced
point-to-point pipes; PUB/SUB gives fan-out (subscribers joining late miss
earlier messages, as ZMQ defines). Receive sides are live sources
(``ALLOW_UNDERRUN``): an empty poll yields a zero-padded partial block
rather than EOS, and ``n_samples`` (0 = forever) bounds test runs.
"""

from __future__ import annotations

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting

try:
    import zmq
    _HAVE_ZMQ = True
except Exception:                                 # pragma: no cover
    zmq = None
    _HAVE_ZMQ = False

_CTX = None


def _ctx():
    global _CTX
    if not _HAVE_ZMQ:
        raise GrError("pyzmq is not available in this environment")
    if _CTX is None:
        _CTX = zmq.Context.instance()
    return _CTX


class _ZmqSinkBase(SinkBlock):
    SOCK_TYPE: int = 0

    IN = (Port("in"),)
    address = Setting(default="tcp://127.0.0.1:52101", kind="static")
    bind = Setting(default=True, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._sock = None

    def start(self):
        if self._sock is not None:
            return
        self._sock = _ctx().socket(self.SOCK_TYPE)
        self._sock.setsockopt(zmq.LINGER, 500)
        addr = str(self.settings.get("address"))
        if bool(self.settings.get("bind")):
            self._sock.bind(addr)
        else:
            self._sock.connect(addr)

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid <= 0:
            return
        if self._sock is None:
            self.start()
        data = np.ascontiguousarray(arrays["in"][..., :n_valid])
        self._sock.send(data.tobytes())

    def stop(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class _ZmqSourceBase(SourceBlock):
    SOCK_TYPE: int = 0

    OUT = (Port("out"),)
    FEED = True
    ALLOW_UNDERRUN = True
    address = Setting(default="tcp://127.0.0.1:52101", kind="static")
    bind = Setting(default=False, kind="static")
    dtype = Setting(default="float32", kind="static",
                    choices=("float32", "complex64", "int16", "int32"))
    timeout_ms = Setting(default=100, kind="static",
                         description="per-step poll timeout")
    n_samples = Setting(default=0, kind="static",
                        description="stop after this many (0 = forever)")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._sock = None
        self._carry = b""
        self._served = 0

    def out_dtype(self, port, in_dtypes):
        return np.dtype(str(self.settings.get("dtype")))

    def start(self):
        if self._sock is not None:
            return
        self._sock = _ctx().socket(self.SOCK_TYPE)
        self._sock.setsockopt(zmq.LINGER, 0)
        if self.SOCK_TYPE == getattr(zmq, "SUB", -1):
            self._sock.setsockopt(zmq.SUBSCRIBE, b"")
        addr = str(self.settings.get("address"))
        if bool(self.settings.get("bind")):
            self._sock.bind(addr)
        else:
            self._sock.connect(addr)

    def host_feed(self, n, abs_index):
        if self._sock is None:
            self.start()
        limit = int(self.settings.get("n_samples"))
        if limit and self._served >= limit:
            return None
        dt = np.dtype(str(self.settings.get("dtype")))
        want = n * dt.itemsize
        to_ms = int(self.settings.get("timeout_ms"))
        buf = self._carry
        # drain whatever arrives inside the poll budget
        while len(buf) < want and self._sock.poll(to_ms):
            buf += self._sock.recv()
            to_ms = 0                              # rest non-blocking
        take = (len(buf) // dt.itemsize) * dt.itemsize
        take = min(take, want)
        self._carry = buf[take:]
        got = np.frombuffer(buf[:take], dt).copy()    # writable, owned
        if limit:
            got = got[: limit - self._served]
        self._served += len(got)
        return {"out": got}, len(got)

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}

    def stop(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None


if _HAVE_ZMQ:
    @register_block("ZmqPushSink")
    class ZmqPushSink(_ZmqSinkBase):
        """PUSH side of a point-to-point pipe (≈ zeromq_push_sink)."""
        SOCK_TYPE = zmq.PUSH

    @register_block("ZmqPullSource")
    class ZmqPullSource(_ZmqSourceBase):
        """PULL side of a point-to-point pipe (≈ zeromq_pull_source)."""
        SOCK_TYPE = zmq.PULL

    @register_block("ZmqPubSink")
    class ZmqPubSink(_ZmqSinkBase):
        """PUB fan-out (≈ zeromq_pub_sink); late subscribers miss history."""
        SOCK_TYPE = zmq.PUB

    @register_block("ZmqSubSource")
    class ZmqSubSource(_ZmqSourceBase):
        """SUB receive (≈ zeromq_sub_source), subscribed to everything."""
        SOCK_TYPE = zmq.SUB
