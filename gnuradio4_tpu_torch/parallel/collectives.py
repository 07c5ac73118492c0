"""Collectives over shard lists.

A sharded value is a Python list with one tensor per shard, each on its
shard's device, in shard order. The collectives the JAX package runs inside
``shard_map`` (``ppermute``, ``all_gather``, ``all_to_all``, ``psum``,
``pmean``) are plain functions over such lists here: they move data with
``.to(device)`` (a no-op where shards share a device) and return lists, so
every operand a collective needs is in hand when it runs, and no shard waits
on another. The device each result lands on is the device of the shard that
receives it.

Across processes (``parallel/multihost.py``) each process holds only its own
shards, and the list is that process's part of the value. A
:class:`ShardAxis` with ``world > 1`` says so: the collectives given such an
axis (``axis=``) move what crosses the process boundary through the default
``torch.distributed`` process group — NCCL on CUDA tensors when every process
has its own card, else Gloo with CUDA tensors staged through host memory —
and count its bytes and host time in :data:`transport`. Every process calls
the same collectives in the same order (each runs the same step).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from ..core.errors import GrError


@dataclasses.dataclass(frozen=True)
class ShardAxis:
    """The mesh axis a value is sharded over: its name and the device of
    each of this process's shards (``devices[0]`` is the process's home).

    An axis spanning ``world`` processes gives each the same number of
    shards, process-major: process ``rank`` holds the global shards
    ``first … first + len(devices) − 1``."""

    name: str
    devices: tuple[torch.device, ...]
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """The global shard count."""
        return len(self.devices) * self.world

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def spans_processes(self) -> bool:
        return self.world > 1

    @property
    def home(self) -> torch.device:
        return self.devices[0]


@dataclasses.dataclass
class TransportStats:
    """What the process-group collectives moved: calls, bytes this process
    sent plus bytes it received (one copy a peer: an all-gather moves
    ``2·(world − 1)`` slices, a broadcast ``world − 1`` from its source and
    one to every other process), and the host seconds spent in them
    (staging included)."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


transport = TransportStats()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _via_host(t: torch.Tensor) -> bool:
    """Gloo moves host tensors: a CUDA tensor goes through host memory."""
    import torch.distributed as dist
    return t.is_cuda and dist.get_backend() == "gloo"


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the process group's backend takes it (staged to the host
    under Gloo)."""
    t = t.contiguous()
    return t.cpu() if _via_host(t) else t


def _buffer(like: torch.Tensor) -> torch.Tensor:
    """An empty tensor to receive ``like``'s shape and dtype into, where the
    backend takes it (on the host under Gloo: nothing to copy there)."""
    if _via_host(like):
        return torch.empty(like.shape, dtype=like.dtype)
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _pg_all_gather(t: torch.Tensor, axis: ShardAxis) -> list[torch.Tensor]:
    """Every process's ``t`` (same shape), in rank order, on ``t``'s device."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    s = _staged(t)
    out = [torch.empty_like(s) for _ in range(axis.world)]
    dist.all_gather(out, s)
    out = [o.to(t.device) for o in out]
    transport.calls += 1
    transport.bytes += 2 * _nbytes(s) * (axis.world - 1)
    transport.seconds += time.perf_counter() - t0
    return out


def _pg_broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """Process ``src``'s ``t`` on every process (same shape everywhere)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    mine = dist.get_rank() == src
    s = _staged(t).clone() if mine else _buffer(t)
    dist.broadcast(s, src)
    out = s.to(t.device)
    transport.calls += 1
    transport.bytes += _nbytes(s) * (dist.get_world_size() - 1 if mine else 1)
    transport.seconds += time.perf_counter() - t0
    return out


def _pg_exchange(sends: Sequence[tuple[int, int, torch.Tensor]],
                 recvs: Sequence[tuple[int, int, torch.Tensor]]
                 ) -> list[torch.Tensor]:
    """Point-to-point messages: ``sends`` as ``(peer, tag, tensor)`` and
    ``recvs`` as ``(peer, tag, like)`` (a tensor of the shape, dtype and
    device to receive into). Both sides list the messages between two
    processes in the same order. Returns the received tensors."""
    import torch.distributed as dist
    if not sends and not recvs:
        return []
    t0 = time.perf_counter()
    ops, bufs = [], []
    for peer, tag, t in sends:
        s = _staged(t)
        ops.append(dist.P2POp(dist.isend, s, peer, tag=tag))
        transport.bytes += _nbytes(s)
    for peer, tag, like in recvs:
        b = _buffer(like)
        bufs.append(b)
        ops.append(dist.P2POp(dist.irecv, b, peer, tag=tag))
        transport.bytes += _nbytes(b)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = [b.to(like.device) for b, (_, _, like) in zip(bufs, recvs)]
    transport.calls += 1
    transport.seconds += time.perf_counter() - t0
    return out


def _local(axis: ShardAxis | None) -> bool:
    return axis is None or not axis.spans_processes


def split(x: torch.Tensor, axis: ShardAxis, dim: int = -1
          ) -> list[torch.Tensor]:
    """``x`` cut into ``axis.size`` equal parts along ``dim``, this process's
    part ``i`` on its shard ``i``'s device. ``x`` is the whole value: across
    processes each keeps its own parts (``first …``)."""
    n = x.shape[dim]
    if n % axis.size:
        raise GrError(f"length {n} does not split into {axis.size} shards "
                      f"over {axis.name!r}")
    parts = torch.chunk(x, axis.size, dim=dim)[
        axis.first:axis.first + axis.local_size]
    return [p.to(d) for p, d in zip(parts, axis.devices)]


def split_local(x: torch.Tensor, axis: ShardAxis, dim: int = -1
                ) -> list[torch.Tensor]:
    """``x``, this process's part of a value (its contiguous slice along
    ``dim``), cut into its ``axis.local_size`` shards. On one process the
    same as :func:`split`."""
    return split(x, dataclasses.replace(axis, rank=0, world=1), dim)


def gather(xs: Sequence[torch.Tensor], device: torch.device, dim: int = -1
           ) -> torch.Tensor:
    """The shards joined along ``dim`` into one tensor on ``device`` (this
    process's shards only: across processes, its slice of the value)."""
    return torch.cat([x.to(device) for x in xs], dim=dim)


def gather_global(xs: Sequence[torch.Tensor], axis: ShardAxis | None,
                  device: torch.device, dim: int = -1) -> torch.Tensor:
    """The whole value on ``device``: this process's shards joined, and
    across processes every process's slice, in process order."""
    local = gather(xs, device, dim)
    if _local(axis):
        return local
    return torch.cat(_pg_all_gather(local, axis), dim=dim)


def all_gather(xs: Sequence[torch.Tensor], dim: int = -1,
               axis: ShardAxis | None = None) -> list[torch.Tensor]:
    """Every shard receives the whole value (tiled along ``dim``): one join
    per distinct device, shared by the shards that live there."""
    full = None if _local(axis) else gather_global(xs, axis, xs[0].device, dim)
    by_dev: dict[torch.device, torch.Tensor] = {}
    out = []
    for x in xs:
        if x.device not in by_dev:
            by_dev[x.device] = gather(xs, x.device, dim) if full is None \
                else full.to(x.device)
        out.append(by_dev[x.device])
    return out


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[tuple[int, int]],
             axis: ShardAxis | None = None) -> list[torch.Tensor]:
    """Shard ``dst`` receives shard ``src``'s value for each ``(src, dst)``
    of ``perm``; a shard that receives nothing gets zeros. Across processes
    ``perm`` names global shards, and a pair whose ends live in two
    processes is a message between them."""
    out: list[torch.Tensor | None] = [None] * len(xs)
    lo, n_l = (0, len(xs)) if axis is None else (axis.first, axis.local_size)
    n = n_l if axis is None else axis.size
    mine = range(lo, lo + n_l)
    sends, recvs, into = [], [], []
    for src, dst in perm:
        if src in mine and dst in mine:
            out[dst - lo] = xs[src - lo].to(xs[dst - lo].device)
        elif src in mine:
            sends.append((dst // n_l, src * n + dst, xs[src - lo]))
        elif dst in mine:
            recvs.append((src // n_l, src * n + dst, xs[dst - lo]))
            into.append(dst - lo)
    for i, t in zip(into, _pg_exchange(sends, recvs)):
        out[i] = t
    return [torch.zeros_like(x) if o is None else o for o, x in zip(out, xs)]


def psum(xs: Sequence[torch.Tensor], axis: ShardAxis | None = None
         ) -> list[torch.Tensor]:
    """Every shard receives the sum over shards (summed on the first shard's
    device, in shard order). Across processes every process gathers every
    shard and sums them in global shard order, so all processes, and the
    single-process form, agree bit for bit."""
    home = xs[0].device
    terms = list(xs)
    if not _local(axis):
        every = _pg_all_gather(torch.stack([x.to(home) for x in xs]), axis)
        terms = [x for part in every for x in part]
    total = terms[0]
    for x in terms[1:]:
        total = total + x.to(home)
    return [total.to(x.device) for x in xs]


def pmean(xs: Sequence[torch.Tensor], axis: ShardAxis | None = None
          ) -> list[torch.Tensor]:
    """Every shard receives the mean over shards."""
    n = len(xs) if _local(axis) else axis.size
    return [s / n for s in psum(xs, axis)]


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int, concat_dim: int,
               axis: ShardAxis | None = None) -> list[torch.Tensor]:
    """Tiled all-to-all: shard ``i`` cuts its value into ``n`` equal parts
    along ``split_dim``, and shard ``j`` receives part ``j`` of every shard,
    joined along ``concat_dim`` in shard order (``n``: the global shard
    count)."""
    n = len(xs) if _local(axis) else axis.size
    parts = [torch.chunk(x, n, dim=split_dim) for x in xs]
    if any(len(p) != n or p[0].shape[split_dim] * n != x.shape[split_dim]
           for p, x in zip(parts, xs)):
        raise GrError(f"all_to_all: dimension {split_dim} does not split "
                      f"into {n} shards")
    lo, n_l = (0, len(xs)) if axis is None else (axis.first, axis.local_size)
    mine = range(lo, lo + n_l)
    # every (src, dst) pair in one global order, on both sides of a message
    sends, recvs, slots = [], [], []
    got: dict[tuple[int, int], torch.Tensor] = {}
    for i in range(n):
        for j in range(n):
            if i in mine and j in mine:
                got[(i, j)] = parts[i - lo][j].to(xs[j - lo].device)
            elif i in mine:
                sends.append((j // n_l, i * n + j, parts[i - lo][j]))
            elif j in mine:
                like = parts[0][0].to(xs[j - lo].device)
                recvs.append((i // n_l, i * n + j, like))
                slots.append((i, j))
    for key, t in zip(slots, _pg_exchange(sends, recvs)):
        got[key] = t
    return [torch.cat([got[(i, j)] for i in range(n)], dim=concat_dim)
            for j in mine]
