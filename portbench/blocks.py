"""The benchmark's own source and sink blocks.

``ReplaySource`` hands each step a contiguous slice of a replay buffer that
already lies in card memory, without a copy: it stands for samples that an
SDR's DMA has landed there. ``KeepSink`` makes no device-to-host copy: it
holds on to the device tensors of the steps that the comparison will read
(a sample of the window's steps drawn from the seed, and the last one).
Both subclass the port's block bases and run under its ``Scheduler``.
"""

from __future__ import annotations

import numpy as np
import torch

from gnuradio4_tpu_torch.core.block import Port, SinkBlock, SourceBlock


class ReplaySource(SourceBlock):
    """``out`` of step i is ``replay[(i·T) mod L : … + T]``, a view. The
    replay's length ``L`` is a whole number of steps."""

    OUT = (Port("out", dtype="complex64"),)

    def __init__(self, replay: torch.Tensor, name: str | None = None):
        super().__init__(name=name)
        self.replay = replay

    def init_state(self, ctx):
        n = ctx.out_len["out"]
        if self.replay.shape[-1] % n:
            raise ValueError(f"replay of {self.replay.shape[-1]} samples is "
                             f"not a whole number of {n}-sample steps")
        return torch.tensor(0, dtype=torch.int64)    # host offset, no sync

    def apply(self, state, ins, ctx):
        n = ctx.out_len["out"]
        off = int(state)
        nxt = (off + n) % self.replay.shape[-1]
        return torch.tensor(nxt, dtype=torch.int64), {"out": self.replay[off:off + n]}


class StepSampler:
    """Which steps the comparison reads: reservoir sampling of ``k`` steps
    from those at or after ``first`` (decisions drawn from ``seed``), shared
    by every sink of a graph so that they keep the same steps."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.first: int | None = None      # set when the window opens
        self.slots: list[int] = []
        self._seen: dict[int, int | None] = {}

    def decide(self, step: int) -> int | None:
        """The slot that ``step`` takes (memoised per step), or None."""
        if step in self._seen:
            return self._seen[step]
        slot = None
        if self.first is not None and step >= self.first:
            i = step - self.first
            if i < self.k:
                slot = i
                self.slots.append(step)
            else:
                j = int(self.rng.integers(0, i + 1))
                if j < self.k:
                    slot = j
                    self.slots[j] = step
        self._seen = {step: slot}
        return slot


class KeepSink(SinkBlock):
    """Keeps the device tensors of the sampled steps and of the last one."""

    IN = (Port("in"),)
    WANTS_HOST_DATA = False            # device tensors, no copy

    def __init__(self, sampler: StepSampler, name: str | None = None):
        super().__init__(name=name)
        self.sampler = sampler
        self.kept: dict[int, torch.Tensor] = {}     # slot → tensor
        self.kept_step: dict[int, int] = {}         # slot → step
        self.last: tuple[int, torch.Tensor] | None = None

    def consume(self, arrays, tags, n_valid, abs_index):
        if not n_valid:
            return
        x = arrays["in"]
        step = abs_index // n_valid
        slot = self.sampler.decide(step)
        if slot is not None:
            self.kept[slot] = x
            self.kept_step[slot] = step
        if self.sampler.first is not None and step >= self.sampler.first:
            self.last = (step, x)

    def outputs(self) -> dict[int, torch.Tensor]:
        """step → the tensor this sink received at that step, for every
        kept step."""
        out = {self.kept_step[s]: t for s, t in self.kept.items()}
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out
