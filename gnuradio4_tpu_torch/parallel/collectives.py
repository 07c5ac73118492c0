"""Collectives over shard lists.

A sharded value is a Python list with one tensor per shard, each on its
shard's device, in shard order. The collectives the JAX package runs inside
``shard_map`` (``ppermute``, ``all_gather``, ``all_to_all``, ``psum``,
``pmean``) are plain functions over such lists here: they move data with
``.to(device)`` (a no-op where shards share a device) and return lists, so
every operand a collective needs is in hand when it runs, and no shard waits
on another. The device each result lands on is the device of the shard that
receives it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..core.errors import GrError


@dataclasses.dataclass(frozen=True)
class ShardAxis:
    """The mesh axis a value is sharded over: its name and the device of
    each shard (``devices[0]`` is the mesh's home)."""

    name: str
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def split(x: torch.Tensor, axis: ShardAxis, dim: int = -1
          ) -> list[torch.Tensor]:
    """``x`` cut into ``axis.size`` equal parts along ``dim``, part ``i`` on
    shard ``i``'s device."""
    n = x.shape[dim]
    if n % axis.size:
        raise GrError(f"length {n} does not split into {axis.size} shards "
                      f"over {axis.name!r}")
    return [p.to(d) for p, d in zip(torch.chunk(x, axis.size, dim=dim),
                                    axis.devices)]


def gather(xs: Sequence[torch.Tensor], device: torch.device, dim: int = -1
           ) -> torch.Tensor:
    """The shards joined along ``dim`` into one tensor on ``device``."""
    return torch.cat([x.to(device) for x in xs], dim=dim)


def all_gather(xs: Sequence[torch.Tensor], dim: int = -1
               ) -> list[torch.Tensor]:
    """Every shard receives the whole value (tiled along ``dim``): one join
    per distinct device, shared by the shards that live there."""
    by_dev: dict[torch.device, torch.Tensor] = {}
    out = []
    for x in xs:
        if x.device not in by_dev:
            by_dev[x.device] = gather(xs, x.device, dim)
        out.append(by_dev[x.device])
    return out


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[tuple[int, int]]
             ) -> list[torch.Tensor]:
    """Shard ``dst`` receives shard ``src``'s value for each ``(src, dst)``
    of ``perm``; a shard that receives nothing gets zeros."""
    out: list[torch.Tensor | None] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [torch.zeros_like(x) if o is None else o for o, x in zip(out, xs)]


def psum(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Every shard receives the sum over shards (summed on the first shard's
    device, in shard order)."""
    home = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(home)
    return [total.to(x.device) for x in xs]


def pmean(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Every shard receives the mean over shards."""
    return [s / len(xs) for s in psum(xs)]


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int, concat_dim: int
               ) -> list[torch.Tensor]:
    """Tiled all-to-all: shard ``i`` cuts its value into ``n`` equal parts
    along ``split_dim``, and shard ``j`` receives part ``j`` of every shard,
    joined along ``concat_dim`` in shard order."""
    n = len(xs)
    parts = [torch.chunk(x, n, dim=split_dim) for x in xs]
    if any(len(p) != n or p[0].shape[split_dim] * n != x.shape[split_dim]
           for p, x in zip(parts, xs)):
        raise GrError(f"all_to_all: dimension {split_dim} does not split "
                      f"into {n} shards")
    return [torch.cat([parts[i][j].to(xs[j].device) for i in range(n)],
                      dim=concat_dim) for j in range(n)]
