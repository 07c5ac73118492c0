"""Block scaffolding (≈ gr_modtool add): writes a ready-to-run block module
of the PyTorch port and a matching pytest file that runs it on the CPU. The generated block registers itself with the
global registry on import (`gr_register` plugin convention), so
``PluginLoader(global_registry).load(path)`` picks it up directly.
"""

from __future__ import annotations

import re
from pathlib import Path

from ..core.errors import GrError

_DEVICE = '''"""{name}: generated device block — edit apply() (torch ops)."""

from gnuradio4_tpu_torch.core.block import Block, Port
from gnuradio4_tpu_torch.core.settings import Setting


class {name}(Block):
    """One-line description shown by `describe {name}`."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("out", dtype="float32"),)
    gain = Setting(default=1.0, description="example dynamic setting")

    def init_state(self, ctx):
        """Per-run carried state (filter tails, phases, PRNG keys) as
        tensors on ``ctx.device``, threaded through apply()."""
        return None

    def apply(self, state, ins, ctx):
        """Runs each step on the graph's device (``ctx.device``): torch
        ops on the input tensors; avoid host reads of tensor values."""
        y = ins["in"] * float(ctx.p("gain", 1.0))
        return state, {{"out": y}}


def gr_register(registry):
    registry.add("{name}", {name})
'''

_SINK = '''"""{name}: generated host sink — edit consume()."""

import numpy as np

from gnuradio4_tpu_torch.core.block import Port, SinkBlock
from gnuradio4_tpu_torch.core.settings import Setting


class {name}(SinkBlock):
    """One-line description shown by `describe {name}`."""

    IN = (Port("in", dtype="float32"),)

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self.received = []

    def consume(self, arrays, tags, n_valid, abs_index):
        """Host-side delivery: arrays are numpy, ``n_valid`` bounds the
        valid samples, ``abs_index`` is the absolute stream position."""
        if n_valid > 0:
            self.received.append(
                np.asarray(arrays["in"][..., :n_valid]).copy())


def gr_register(registry):
    registry.add("{name}", {name})
'''

_SOURCE = '''"""{name}: generated host-fed source — edit host_feed()."""

import numpy as np

from gnuradio4_tpu_torch.core.block import Port, SourceBlock
from gnuradio4_tpu_torch.core.settings import Setting


class {name}(SourceBlock):
    """One-line description shown by `describe {name}`."""

    OUT = (Port("out", dtype="float32"),)
    FEED = True
    n_samples = Setting(default=4096, kind="static")

    def host_feed(self, n, abs_index):
        """Return ({{port: array}}, n_valid) or None at end of stream."""
        total = int(self.settings.get("n_samples"))
        if abs_index >= total:
            return None
        count = min(n, total - abs_index)
        chunk = np.arange(abs_index, abs_index + count, dtype=np.float32)
        return {{"out": chunk}}, count

    def apply(self, state, ins, ctx):
        return state, {{"out": ins["out"]}}


def gr_register(registry):
    registry.add("{name}", {name})
'''

_TEST = '''"""Generated test for {name} — extend with real expectations."""

import numpy as np

import gnuradio4_tpu_torch as gt
from gnuradio4_tpu_torch.blocks.testing import VectorSink, VectorSource
from gnuradio4_tpu_torch.core.registry import PluginLoader, global_registry


def _load():
    if not global_registry.contains("{name}"):
        PluginLoader(global_registry).load("{module_path}")


def test_{snake}_runs():
    _load()
    g = gt.Graph()
{body}
    gt.Scheduler(g, block_len=256, sample_rate=1e6,
                 device="cpu").run_and_wait()
{check}
'''

_TEST_DEVICE_BODY = '''    src = g.add(VectorSource(np.arange(512, dtype=np.float32)))
    blk = g.emplace("{name}", gain=2.0)
    snk = g.add(VectorSink())
    g.connect_chain(src, blk, snk)'''
_TEST_DEVICE_CHECK = '''    np.testing.assert_allclose(np.asarray(snk.data()),
                               2.0 * np.arange(512))'''

_TEST_SINK_BODY = '''    src = g.add(VectorSource(np.arange(512, dtype=np.float32)))
    blk = g.emplace("{name}")
    g.connect(src, blk)'''
_TEST_SINK_CHECK = '''    got = np.concatenate(blk.received)
    np.testing.assert_array_equal(got, np.arange(512))'''

_TEST_SOURCE_BODY = '''    blk = g.emplace("{name}", n_samples=512)
    snk = g.add(VectorSink())
    g.connect(blk, snk)'''
_TEST_SOURCE_CHECK = '''    np.testing.assert_array_equal(np.asarray(snk.data()),
                                  np.arange(512))'''


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


def new_block(name: str, *, kind: str = "device", out_dir: str = "."
              ) -> list[str]:
    """Write ``<snake>.py`` + ``test_<snake>.py``; returns the paths."""
    if not re.fullmatch(r"[A-Z][A-Za-z0-9]*", name):
        raise GrError(f"block name must be CamelCase (got {name!r})")
    if kind not in ("device", "sink", "source"):
        raise GrError(f"unknown kind {kind!r}")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    snake = _snake(name)
    mod_path = out / f"{snake}.py"
    test_path = out / f"test_{snake}.py"
    for p in (mod_path, test_path):
        if p.exists():
            raise GrError(f"refusing to overwrite {p}")
    tmpl = {"device": _DEVICE, "sink": _SINK, "source": _SOURCE}[kind]
    mod_path.write_text(tmpl.format(name=name))
    body = {"device": _TEST_DEVICE_BODY, "sink": _TEST_SINK_BODY,
            "source": _TEST_SOURCE_BODY}[kind].format(name=name)
    check = {"device": _TEST_DEVICE_CHECK, "sink": _TEST_SINK_CHECK,
             "source": _TEST_SOURCE_CHECK}[kind]
    test_path.write_text(_TEST.format(name=name, snake=snake,
                                      module_path=str(mod_path.resolve()),
                                      body=body, check=check))
    return [str(mod_path), str(test_path)]
