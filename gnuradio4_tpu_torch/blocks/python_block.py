"""User-function blocks (≈ reference blocks/basic PythonBlock.hpp:22 — embedded
CPython user blocks) and the host-push source.

In a Python-first framework the "PythonBlock" wraps a user callable. Two
flavors:

- :class:`LambdaBlock` — a function of torch tensors, run inside the eager step
  on the graph's device (the fast path);
- :class:`HostBlock` — an arbitrary host NumPy function, run inside the step
  through :func:`~..core.host_call.host_call` (the JAX package's
  ``jax.pure_callback``): one device↔host round trip and one stream
  synchronisation a step, the same caveat as the reference's embedded
  interpreter.

:class:`StreamSource` feeds a graph from the user's own threads through a
host ring.
"""

from __future__ import annotations

import ast
import inspect
import threading
from typing import Any, Callable

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.errors import GrError
from ..core.feeder import read_exact
from ..core.host_call import host_call, numpy_dtype
from ..core.registry import register_block
from ..core.settings import Setting
from ..native.ring import HostRing


@register_block("LambdaBlock")
class LambdaBlock(Block):
    """Wrap a function of torch tensors ``fn(x, ctx) -> y`` (or ``fn(x) -> y``),
    run in the step on the graph's device."""

    IN = (Port("in"),)
    OUT = (Port("out"),)

    def __init__(self, fn: Callable = None, name=None, n_inputs: int = 1,
                 **settings):
        super().__init__(name=name, **settings)
        if fn is None:
            fn = lambda x: x  # noqa: E731
        self.fn = fn
        if n_inputs != 1:
            self.in_ports = tuple(Port(f"in{i}") for i in range(n_inputs))

    def apply(self, state, ins, ctx):
        args = [ins[p.name] for p in self.in_ports]
        try:
            y = self.fn(*args, ctx=ctx)
        except TypeError:
            y = self.fn(*args)
        return state, {"out": y}


def _declared(spec) -> tuple[tuple[int, ...], np.dtype]:
    return tuple(spec.shape), numpy_dtype(spec.dtype)


@register_block("HostBlock")
class HostBlock(Block):
    """Run a host NumPy function inside the step.

    ``fn(np.ndarray) -> np.ndarray`` must keep the input's shape and dtype,
    or the block declares its result with ``out_shape_fn(x)``: called with the
    step's input tensor, it returns any object with ``.shape`` and ``.dtype``
    (a NumPy array, a torch tensor — a ``device="meta"`` one costs nothing —,
    or a ``types.SimpleNamespace``); ``.dtype`` is a NumPy dtype-like or a
    ``torch.dtype``. A result of another shape or dtype raises ``GrError``.
    Every step pays a device↔host round trip: use for prototyping (same
    caveat as the reference's PythonBlock).
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray] = None,
                 name=None, out_shape_fn: Callable | None = None, **settings):
        super().__init__(name=name, **settings)
        self.fn = fn or (lambda x: x)
        self.out_shape_fn = out_shape_fn

    def apply(self, state, ins, ctx):
        x = ins["in"]
        shape, dtype = _declared(x if self.out_shape_fn is None
                                 else self.out_shape_fn(x))
        return state, {"out": host_call(self.fn, x, shape, dtype)}


# what the port offers instead of the JAX package's namespace
_JAX_NAMES = {"jnp": "torch (tensor ops) or np (mode='host')",
              "jax": "torch (tensor ops) or np (mode='host')"}


def _names_jax(code: str) -> str | None:
    """The first JAX name ``code`` uses (a bare name or an import), if any."""
    for node in ast.walk(ast.parse(code)):
        if isinstance(node, ast.Name) and node.id in _JAX_NAMES:
            return node.id
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
                else [node.module or ""]
            for m in mods:
                if m.split(".")[0] == "jax":
                    return "jax"
    return None


@register_block("PythonBlock")
class PythonBlock(Block):
    """Reference-parity user-source-code block (≈ blocks/basic PythonBlock.hpp:22,
    which embeds CPython+NumPy to run a user script per work() call).

    The ``code`` setting is Python source that must define ``process(x)``
    (single in/out) or ``process(ins, ctx)`` (dict of tensors → dict of
    tensors). It executes with ``np`` and ``torch`` in scope (the JAX
    package's has ``np``, ``jnp`` and ``jax``; code that names ``jnp`` or
    ``jax`` raises ``GrError`` here). Like the reference, this runs
    *arbitrary user code* — it is a programming surface, not an isolation
    boundary.

    ``mode='jax'`` (the default; the name is kept so that one graph file
    loads in both packages) means torch ops: ``process`` runs inside the
    eager step on torch tensors on the graph's device, the fast path.
    ``mode='host'`` runs ``process`` on NumPy arrays through the host call,
    its result cast to the input's dtype at the input's shape (the slow path:
    one device↔host round trip a step).
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    code = Setting(default="def process(x):\n    return x", kind="static")
    mode = Setting(default="jax", kind="static", choices=("jax", "host"))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        code = str(self.settings.get("code"))
        jax_name = _names_jax(code)
        if jax_name is not None:
            raise GrError(f"{self.name}: code uses {jax_name!r}, which this "
                          f"package does not provide; use "
                          f"{_JAX_NAMES[jax_name]}")
        ns: dict[str, Any] = {"np": np, "torch": torch}
        exec(code, ns)          # noqa: S102 — the point
        fn = ns.get("process")
        if not callable(fn):
            raise GrError(f"{self.name}: code must define a callable "
                          f"'process(x)' or 'process(ins, ctx)'")
        self._fn = fn
        self._two_arg = len(inspect.signature(fn).parameters) >= 2

    def _call(self, ins, ctx):
        if self._two_arg:
            out = self._fn(dict(ins), ctx)
            return out if isinstance(out, dict) else {"out": out}
        return {"out": self._fn(ins["in"])}

    def apply(self, state, ins, ctx):
        if str(self.settings.get("mode")) == "jax":
            return state, self._call(ins, ctx)
        if self._two_arg:
            raise GrError(f"{self.name}: mode='host' supports the single-arg "
                          f"'process(x)' form only")
        x = ins["in"]
        dt = numpy_dtype(x.dtype)
        y = host_call(lambda a: np.asarray(self._fn(a)).astype(dt), x,
                      tuple(x.shape), dt)
        return state, {"out": y}


@register_block("StreamSource")
class StreamSource(Block):
    """Generic host-push streaming source: any thread calls :meth:`push` with
    sample arrays; the scheduler drains them through the native host ring
    (:class:`~..native.ring.HostRing` ≈ reference CircularBuffer.hpp), made
    for several producers: pushes from several threads claim disjoint
    ranges. Call :meth:`close` to signal end-of-stream.

    This is the programmatic twin of FileSource/SdrSource for data that
    originates in the user's own Python code (network handlers, simulators,
    test harnesses)::

        src = g.emplace("StreamSource", dtype="complex64")
        ...
        src.push(samples)        # from any thread, before or during run
        src.close()              # flowgraph drains remaining data, then stops

    ``wait`` is how the feed waits for data (``core/feeder.read_exact``);
    ``timeout`` is how long it waits before the run fails as starved.
    """

    IN = ()
    OUT = (Port("out"),)
    FEED = True
    dtype = Setting(default="float32", kind="static",
                    choices=("float32", "complex64", "int32", "int16", "uint8"))
    capacity = Setting(default=1 << 20, kind="static")   # ring items
    timeout = Setting(default=30.0, kind="static")       # starvation limit (s)
    wait = Setting(default="sleep", kind="static",
                   choices=("spin", "yield", "sleep", "block"))

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._ring = None
        self._reader = None
        self._ring_lock = threading.Lock()

    def _ensure_ring(self) -> HostRing:
        # user threads (push/close) race the scheduler thread (host_feed) for
        # first touch — without the lock each side can build its own ring and
        # the producer's data lands in an orphan
        with self._ring_lock:
            if self._ring is None:
                ring = HostRing(int(self.settings.get("capacity")),
                                np.dtype(str(self.settings.get("dtype"))),
                                producers="multi")
                self._reader = ring.add_reader()
                self._ring = ring
        return self._ring

    # -- producer side (user threads) ------------------------------------------
    def push(self, data, *, block: bool = True, timeout: float = 10.0) -> int:
        """Queue samples for the flowgraph (copied into the ring). Returns
        items accepted (short only when ``block=False`` or on timeout against
        a stalled graph)."""
        ring = self._ensure_ring()
        if ring.eos:
            raise GrError(f"{self.name}: push() after close()")
        return ring.write(np.asarray(data), block=block, timeout=timeout)

    def close(self) -> None:
        """Mark end-of-stream; the graph stops once the ring drains."""
        self._ensure_ring().set_eos()

    # -- scheduler side --------------------------------------------------------
    def host_feed(self, n, abs_index):
        ring = self._ensure_ring()
        if n > ring.capacity:
            raise GrError(
                f"{self.name}: ring capacity {ring.capacity} < scheduler "
                f"block_len {n}; raise the 'capacity' setting")
        got = read_exact(ring, self._reader, n,
                         timeout=float(self.settings.get("timeout")),
                         wait=str(self.settings.get("wait")))
        if got is None:
            return None
        return {"out": got}, len(got)

    def out_dtype(self, port, in_dtypes):
        return np.dtype(str(self.settings.get("dtype")))

    def apply(self, state, ins, ctx):
        return state, {"out": ins["out"]}
