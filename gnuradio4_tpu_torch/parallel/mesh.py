"""Device mesh construction helpers.

A :class:`Mesh` is an ndarray of ``torch.device`` with named axes, the
counterpart of ``jax.sharding.Mesh``. A device may repeat:
``make_mesh((8,), ("sp",), devices=[torch.device("cuda")] * 8)`` is eight
time shards on one card, and ``[torch.device("cpu")] * 8`` stands in for the
JAX package's eight forced host devices in the tests. On one device such a
mesh is a test and single-card form: it runs every shard's work, one shard
after another, on that device — no speed-up.

The mesh's first device is its *home*: the scheduler's device, where block
states, sink inputs, gather islands and ``chan``-axis streams live.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..core.errors import GrError


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (or ``None``), as
    ``jax.sharding.PartitionSpec``: ``PartitionSpec("chan", None)`` shards a
    ``[C, T]`` stream's channel axis over the ``chan`` mesh axis."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def canonical_device(d: torch.device | str) -> torch.device:
    """``d`` with its index filled in (``cuda`` → ``cuda:<current>``), so
    equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        if not torch.cuda.is_available():
            raise GrError(f"mesh device {d}: no CUDA device is present "
                          f"(torch.cuda.is_available() is False)")
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Devices laid out on named axes (≈ ``jax.sharding.Mesh``)."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [canonical_device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise GrError(f"mesh of shape {self.devices.shape} needs "
                          f"{self.devices.ndim} axis names, got "
                          f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        """The first device: the scheduler's device under this mesh."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: where
        the shards of a stream split over ``axis`` alone live."""
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            idx[k] = i
            out.append(self.devices[tuple(idx)])
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout of a tensor over a mesh (≈ ``jax.sharding.NamedSharding``):
    dimension ``i`` splits over the mesh axis ``spec[i]`` (``None``:
    unsplit, missing trailing entries too)."""

    mesh: Mesh
    spec: PartitionSpec

    def split(self, x: torch.Tensor) -> np.ndarray:
        """``x`` cut into equal blocks, one per mesh position, each moved to
        its device: an object ndarray of the mesh's shape (positions along an
        axis that ``spec`` does not name hold the same block)."""
        mesh = self.mesh
        cuts = []
        for dim, name in enumerate(self.spec):
            if name is None:
                continue
            n = mesh.shape[name]
            if x.shape[dim] % n:
                raise GrError(f"dimension {dim} of size {x.shape[dim]} does "
                              f"not split over mesh axis {name!r} of {n}")
            cuts.append((dim, mesh.axis_names.index(name), x.shape[dim] // n))
        out = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(*mesh.devices.shape):
            part = x
            for dim, k, size in cuts:
                part = part.narrow(dim, pos[k] * size, size)
            out[pos] = part.to(mesh.devices[pos])
        return out

    def gather(self, parts: np.ndarray, device: torch.device | None = None
               ) -> torch.Tensor:
        """The inverse of :meth:`split`: one tensor on ``device`` (default:
        the mesh's home)."""
        mesh = self.mesh
        device = mesh.home if device is None else device
        named = {mesh.axis_names.index(n): dim
                 for dim, n in enumerate(self.spec) if n is not None}

        def join(k: int, pos: tuple) -> torch.Tensor:
            if k == mesh.devices.ndim:
                return parts[pos].to(device)
            if k not in named:                  # replicated along axis k
                return join(k + 1, pos + (0,))
            return torch.cat([join(k + 1, pos + (i,))
                              for i in range(mesh.devices.shape[k])],
                             dim=named[k])
        return join(0, ())


def make_mesh(shape: Sequence[int] | None = None,
              axes: Sequence[str] = ("dp", "sp"),
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """Create a Mesh over ``devices`` (default: every visible CUDA device).

    Default factorization: put as much as possible on the last axis
    (sequence/channel sharding), the remainder on the first (data parallel).
    A device may repeat (see the module docstring).
    """
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cuda == 0:
            raise GrError("make_mesh: no CUDA device is present; pass "
                          "devices= (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = list(devices)
    n = len(devices)
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        else:
            dp = 1
            # prefer a small power-of-two dp if n has one
            for cand in (2, 4):
                if n % cand == 0 and n // cand > 1:
                    dp = cand
                    break
            shape = (dp, n // dp) + (1,) * (len(axes) - 2)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} ≠ {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), tuple(axes))


def mesh_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def shard_over(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*spec))
