"""PFB channelizer / synthesizer blocks (suite configs 4 and 5) and the
channel-axis plumbing (``ChannelSelect``, ``StreamToChannels``,
``ChannelsToStream``).

The analysis block turns a 1-D wideband complex stream ``[T]`` into an M-channel
stream ``[M, T/M]`` (rate fs/M per channel), or with ``oversample_rate`` O
into ``[M, T·O/M]`` (rate O·fs/M); the synthesis block inverts.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.channelizer import (design_pfb_taps, pfb_analyze_oversampled,
                               pfb_history, pfb_hop, pfb_init_state,
                               pfb_os_init_state, pfb_state, pfb_synthesize)


class _PfbBank(Block):
    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    n_channels = Setting(default=4, kind="static", limits=(2, 1 << 16))
    taps_per_phase = Setting(default=8, kind="static", limits=(1, 64))
    taps = Setting(default=(), kind="static",
                   description="prototype LP taps (empty → auto Kaiser design)")

    def _taps(self) -> np.ndarray:
        t = self.settings.get("taps")
        m = int(self.settings.get("n_channels"))
        p = int(self.settings.get("taps_per_phase"))
        if t is None or len(t) == 0:
            return design_pfb_taps(m, p).astype(np.float32)
        t = np.asarray(t, dtype=np.float32)
        return np.pad(t, (0, m * p - len(t)))[: m * p]

    def _device_taps(self, device: torch.device) -> torch.Tensor:
        """The prototype on ``device``, uploaded once per compile."""
        t = getattr(self, "_taps_dev", None)
        if t is None or t.device != device:
            t = self._taps_dev = torch.from_numpy(self._taps()).to(device)
        return t

    def init_state(self, ctx):
        self._taps_dev = None        # a recompile may bring new taps
        return pfb_init_state(int(self.settings.get("n_channels")),
                              int(self.settings.get("taps_per_phase")),
                              ctx.device)


@register_block("PFBChannelizer")
class PFBChannelizer(_PfbBank):
    """M-channel polyphase analysis bank: [T] → [M, T/M] (critically
    sampled), or [M, T/D] with ``oversample_rate`` O and hop D = M/O
    (``ops/channelizer.py``, which also sets the state's layout)."""

    oversample_rate = Setting(
        default=1, kind="static", limits=(1, 1 << 16),
        description="output rate over fs/M (GNU Radio's oversample_rate); "
                    "M/oversample_rate must be a whole number")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._hop()           # refused here, as GNU Radio's constructor does

    def _hop(self) -> int:
        return pfb_hop(int(self.settings.get("n_channels")),
                       self.settings.get("oversample_rate"))

    @property
    def ratio(self):
        return Fraction(1, self._hop())

    @property
    def alignment(self):
        return self._hop()

    def out_channels(self, port, in_channels):
        return int(self.settings.get("n_channels"))

    def init_state(self, ctx):
        super().init_state(ctx)             # drops the uploaded taps
        return pfb_os_init_state(int(self.settings.get("n_channels")),
                                 int(self.settings.get("taps_per_phase")),
                                 self._hop(), ctx.device)

    def apply(self, state, ins, ctx):
        x = ins["in"].to(torch.complex64)
        y, new_state = pfb_analyze_oversampled(
            x, self._device_taps(x.device), state,
            int(self.settings.get("n_channels")), self._hop())
        return new_state, {"out": y}

    # time sharding: the branch FIRs' history is the last P·M − D inputs
    def sp_halo(self, ctx):
        m = int(self.settings.get("n_channels"))
        p = int(self.settings.get("taps_per_phase"))
        return p * m - self._hop()

    def lower_sp(self, h, state, ins, ctx, local_ctx, axis):
        """The halo lowering, each shard's first frame at its global
        position (every frame's index is 0 at O = 1)."""
        from ..parallel.halo import halo_left, last_shard_tail
        m, d = int(self.settings.get("n_channels")), self._hop()
        xs = [s["in"] for s in ins]
        per = xs[0].shape[-1] // d              # frames a shard
        hist, frame = pfb_history(state)

        def at(tail, i):                        # shard i's state
            return pfb_state(tail.to(torch.complex64), frame + i * per, m, d)
        halos = halo_left(xs, h, hist, axis)
        outs = [self.apply(at(halo, i), x, lctx)[1]
                for i, (x, halo, lctx) in enumerate(zip(ins, halos, local_ctx),
                                                    start=axis.first)]
        return at(last_shard_tail(xs, h, axis), axis.size), outs


@register_block("PFBSynthesizer")
class PFBSynthesizer(_PfbBank):
    """M-channel synthesis bank: [M, T] → [M·T] wideband (inverse of analysis)."""

    @property
    def ratio(self):
        return Fraction(int(self.settings.get("n_channels")), 1)

    def out_channels(self, port, in_channels):
        return 0

    def apply(self, state, ins, ctx):
        x = ins["in"].to(torch.complex64)
        y, new_state = pfb_synthesize(x, self._device_taps(x.device), state)
        return new_state, {"out": y}


@register_block("ChannelSelect")
class ChannelSelect(Block):
    """Pick one channel of a multi-channel stream: [C, T] → [T]."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    channel = Setting(default=0, kind="static", limits=(0, 1 << 20))

    def out_channels(self, port, in_channels):
        return 0

    def apply(self, state, ins, ctx):
        c = int(self.settings.get("channel"))
        n_ch = ins["in"].shape[0] if ins["in"].ndim > 1 else 0
        if c >= n_ch:
            raise GrError(f"{self.name}: channel {c} out of range "
                          f"(input has {n_ch} channels)")
        return state, {"out": ins["in"][c]}


@register_block("StreamToChannels")
class StreamToChannels(Block):
    """Deinterleave [T] → [C, T/C] (≈ stream-to-streams corner turn)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    n_channels = Setting(default=2, kind="static", limits=(1, 1 << 16))

    @property
    def ratio(self):
        return Fraction(1, int(self.settings.get("n_channels")))

    @property
    def alignment(self):
        return int(self.settings.get("n_channels"))

    def out_channels(self, port, in_channels):
        return int(self.settings.get("n_channels"))

    def apply(self, state, ins, ctx):
        c = int(self.settings.get("n_channels"))
        return state, {"out": ins["in"].reshape(-1, c).t().contiguous()}


@register_block("ChannelsToStream")
class ChannelsToStream(Block):
    """Interleave [C, T] → [T·C] (inverse corner turn)."""

    IN = (Port("in"),)
    OUT = (Port("out"),)
    n_channels = Setting(default=2, kind="static", limits=(1, 1 << 16))

    @property
    def ratio(self):
        return Fraction(int(self.settings.get("n_channels")), 1)

    def out_channels(self, port, in_channels):
        return 0

    def apply(self, state, ins, ctx):
        return state, {"out": ins["in"].t().reshape(-1)}
