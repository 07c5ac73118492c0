"""HTTP blocks (≈ reference blocks/http/HttpBlock.hpp:36: HttpSource GET/
SUBSCRIBE long-poll, HttpSink POST).

stdlib urllib on IO threads → native ring → scheduler feed; the response payload
(raw bytes or numeric text) becomes the sample stream.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.request
from typing import Any

import numpy as np

from ..core.block import Port, SinkBlock, SourceBlock
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.stream import canonical_dtype


@register_block("HttpSource")
class HttpSource(SourceBlock):
    """Polls (GET) or long-polls (SUBSCRIBE) a URL; payload → sample stream.

    ``parse``: 'bytes' (raw body as dtype), 'json' (list/number payloads),
    'text' (whitespace-separated numbers).
    """

    OUT = (Port("out"),)
    FEED = True
    url = Setting(default="", kind="static")
    mode = Setting(default="GET", kind="static", choices=("GET", "SUBSCRIBE"))
    parse = Setting(default="bytes", kind="static",
                    choices=("bytes", "json", "text"))
    dtype = Setting(default="float32", kind="static")
    period_s = Setting(default=0.1, description="poll period for GET mode")
    timeout_s = Setting(default=5.0, kind="static")
    max_requests = Setting(default=0, kind="static", description="0 = unbounded")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._q: "queue.Queue[np.ndarray | None]" = queue.Queue(maxsize=64)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._buf = np.zeros(0, np.float32)
        self.error: str | None = None

    def out_dtype(self, port, in_dtypes):
        return self.settings.get("dtype")

    def start(self):
        self._stop.clear()
        from ..utils import thread_pool
        self._thread = thread_pool.spawn(self._run, name=f"{self.name}.http")

    def stop(self):
        self._stop.set()

    def _fetch_once(self) -> np.ndarray | None:
        dt = np.dtype(canonical_dtype(self.settings.get("dtype")))
        url = str(self.settings.get("url"))
        req = urllib.request.Request(url, headers={"User-Agent": "gr4-tpu"})
        with urllib.request.urlopen(
                req, timeout=float(self.settings.get("timeout_s"))) as resp:
            body = resp.read()
        parse = self.settings.get("parse")
        if parse == "bytes":
            return np.frombuffer(body[: len(body) // dt.itemsize * dt.itemsize],
                                 dtype=dt)
        if parse == "json":
            payload = json.loads(body)
            if isinstance(payload, dict):
                payload = payload.get("data", [])
            return np.asarray(payload, dtype=dt).ravel()
        return np.asarray([float(v) for v in body.split()], dtype=dt)

    def _run(self):
        n_req = 0
        limit = int(self.settings.get("max_requests"))
        mode = self.settings.get("mode")
        try:
            while not self._stop.is_set():
                chunk = self._fetch_once()
                n_req += 1
                if chunk is not None and len(chunk):
                    self._q.put(chunk)
                if limit and n_req >= limit:
                    break
                if mode == "GET":
                    self._stop.wait(float(self.settings.get("period_s")))
        except Exception as e:
            self.error = f"{type(e).__name__}: {e}"
        finally:
            self._q.put(None)

    def host_feed(self, n, abs_index):
        while len(self._buf) < n:
            try:
                item = self._q.get(timeout=30.0)
            except queue.Empty:
                raise GrError(f"{self.name}: HTTP feed starved")
            if item is None:
                if self.error:
                    raise GrError(f"{self.name}: {self.error}")
                if len(self._buf) == 0:
                    return None
                out = self._buf
                self._buf = self._buf[:0]
                return {"out": out}, len(out)
            self._buf = np.concatenate([self._buf.astype(item.dtype), item])
        out, self._buf = self._buf[:n], self._buf[n:]
        return {"out": out}, n

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}


@register_block("HttpSink")
class HttpSink(SinkBlock):
    """POSTs each delivered block to a URL (raw bytes or JSON)."""

    IN = (Port("in"),)
    url = Setting(default="", kind="static")
    parse = Setting(default="bytes", kind="static", choices=("bytes", "json"))
    timeout_s = Setting(default=5.0, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.n_posted = 0
        self.errors: list[str] = []

    def consume(self, arrays, tags, n_valid, abs_index):
        if n_valid == 0:
            return
        data = np.ascontiguousarray(arrays["in"][..., :n_valid])
        if self.settings.get("parse") == "json":
            body = json.dumps({"abs_index": abs_index,
                               "data": data.ravel().tolist()}).encode()
            ctype = "application/json"
        else:
            body = data.tobytes()
            ctype = "application/octet-stream"
        req = urllib.request.Request(str(self.settings.get("url")), data=body,
                                     headers={"Content-Type": ctype},
                                     method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=float(self.settings.get("timeout_s"))):
                pass
            self.n_posted += n_valid
        except Exception as e:
            self.errors.append(f"{type(e).__name__}: {e}")
