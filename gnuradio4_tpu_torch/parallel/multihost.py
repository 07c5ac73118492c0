"""Multi-process execution helpers over ``torch.distributed``.

The reference is single-process (SURVEY §2.6); the port scales a time-sharded
graph across processes the way the JAX package does across hosts:

- every process runs the SAME scheduler step over a global mesh
  (:func:`global_mesh`) whose one ``sp`` axis spans the processes, each
  process holding its own shards (process-major);
- every process's ``host_feed`` returns the full global block, and process
  ``p`` of ``n`` keeps ``[p·T/n, (p+1)·T/n)`` (the scheduler cuts it);
- halos, gather islands and carried states cross the process boundary
  through the process group (``parallel/collectives.py``), so carried states
  stay identical on every process;
- sinks receive only this process's time slice (:func:`drain_local`).

The backend is chosen up front from the devices: NCCL when every process
has a card of its own, otherwise Gloo, with CUDA tensors staged through host
memory (two processes sharing one card, or CPU processes).

Single-process fallback: without a coordinator or a process count,
:func:`init_distributed` does nothing, and :func:`global_mesh` is the local
mesh, so the same code runs on one process or on many.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Sequence

import numpy as np
import torch

from ..core.compiler import default_device
from ..core.errors import GrError
from .mesh import Mesh, PartitionSpec, canonical_device

# what init_distributed chose for this process
_chosen: dict[str, object] = {}


def _process_device(device, process_id: int) -> torch.device:
    """This process's device: ``device`` if given, else card ``LOCAL_RANK``
    (default: the process id) modulo the visible cards. Without a card the
    default raises ``GrError`` (``default_device``): the CPU is asked for
    with ``device="cpu"``, never chosen silently."""
    if device is not None:
        return canonical_device(device)
    default_device()
    local = int(os.environ.get("LOCAL_RANK", process_id))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(devices: Sequence[str]) -> str:
    """``"nccl"`` when every process's device is a card of its own
    (``host|cuda:i`` all distinct), else ``"gloo"``."""
    cards = [d for d in devices if d.split("|", 1)[1].startswith("cuda")]
    return "nccl" if len(cards) == len(devices) == len(set(cards)) else "gloo"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: torch.device | str | None = None,
                     timeout: float = 60.0) -> bool:
    """Join a ``torch.distributed`` process group from args or the
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

    ``coordinator`` is ``"host:port"``; process 0 serves it. Every process
    publishes its device (``device``, default its card, ``GrError``
    without one: pass ``device="cpu"`` for CPU processes) and
    the backend follows from all of them (:func:`choose_backend`). The group
    gets ``timeout`` seconds for its setup and for every collective.

    Returns True if a multi-process group was set up, False for
    single-process operation (nothing given: a no-op). A coordinator that
    cannot be reached raises ``GrError`` (the JAX package returns False on
    any failure, which turns a failed two-process start into two silent
    single-process runs)."""
    import torch.distributed as dist
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise GrError("init_distributed needs a coordinator, num_processes "
                      "and process_id (or MASTER_ADDR, WORLD_SIZE and RANK)")
    if dist.is_initialized():
        raise GrError("init_distributed: a process group is already set up")
    host, _, port = coordinator.rpartition(":")
    n, pid = int(num_processes), int(process_id)
    if not host or not port.isdigit() or not 0 <= pid < n:
        raise GrError(f"init_distributed: bad coordinator {coordinator!r} or "
                      f"process {pid} of {n}")
    dev = _process_device(device, pid)
    wait = datetime.timedelta(seconds=timeout)
    try:
        store = dist.TCPStore(host, int(port), n, is_master=(pid == 0),
                              timeout=wait)
        store.set(f"gr4tpu/device/{pid}", f"{socket.gethostname()}|{dev}")
        devices = [store.get(f"gr4tpu/device/{r}").decode()
                   for r in range(n)]
    except Exception as e:   # the store's own errors carry no common type
        raise GrError(f"init_distributed: coordinator {coordinator} not "
                      f"reachable from process {pid} of {n} within "
                      f"{timeout:g} s ({type(e).__name__}: {e})") from e
    backend = choose_backend(devices)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    elif host in ("localhost", "127.0.0.1", "::1"):
        # every process on this host: Gloo's own links over the loopback too
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, store=store, rank=pid, world_size=n,
                            timeout=wait)
    _chosen.update(backend=backend, device=dev, devices=devices)
    return n > 1


def backend() -> str | None:
    """The process group's backend (``"nccl"``/``"gloo"``), None without
    one."""
    return _chosen.get("backend")


def process_device() -> torch.device | None:
    """The device :func:`init_distributed` gave this process."""
    return _chosen.get("device")


def published_devices() -> list[str]:
    """Every process's ``host|device``, in rank order, as they published
    them to the coordinator (what :func:`choose_backend` read)."""
    return list(_chosen.get("devices", ()))


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _chosen.clear()


def global_mesh(axes: Sequence[str] = ("host", "chip"),
                local_devices: Sequence[torch.device | str] | None = None
                ) -> Mesh:
    """Mesh with processes on the first axis and each process's devices on
    the rest; with one axis name, one axis over all of them, process by
    process. ``local_devices``: this process's devices (default: the one
    :func:`init_distributed` chose, else this process's card; ``GrError``
    without one); a device may repeat. Every process passes as many; each
    holds only its own shards."""
    import torch.distributed as dist
    if local_devices is None:
        local_devices = [process_device() or _process_device(None,
                                                             process_index())]
    local = [str(canonical_device(d)) for d in local_devices]
    n_proc, pid = process_count(), process_index()
    every = [local]
    if n_proc > 1:
        every = [None] * n_proc
        dist.all_gather_object(every, local)
        if len({len(v) for v in every}) != 1:
            raise GrError(f"global_mesh: processes hold different numbers "
                          f"of devices: {[len(v) for v in every]}")
    devs = np.empty((n_proc, len(local)), dtype=object)
    for p, names in enumerate(every):
        devs[p, :] = [torch.device(d) for d in names]
    if len(axes) == 1:
        devs = devs.reshape(-1)
    return Mesh(devs, tuple(axes[: devs.ndim]), process_index=pid,
                process_count=n_proc)


def feed_global(x_local: torch.Tensor | np.ndarray, mesh: Mesh,
                spec: PartitionSpec | None = None) -> list[torch.Tensor]:
    """This process's part of a global value, as the shard list the
    collectives take: ``x_local`` (the block of the global array this
    process produces, e.g. its slice of the wideband stream) cut along the
    dimension ``spec`` names (default: the last) into this process's shards,
    each on its device."""
    x = torch.as_tensor(x_local)
    dim = -1
    if spec is not None:
        named = [i for i, a in enumerate(spec) if a is not None]
        if len(named) != 1:
            raise GrError(f"feed_global: spec {spec} must name one dimension")
        dim = named[0]
    local = mesh.local_devices
    if x.shape[dim] % len(local):
        raise GrError(f"feed_global: length {x.shape[dim]} does not split "
                      f"into {len(local)} local shards")
    return [p.to(d) for p, d in zip(torch.chunk(x, len(local), dim=dim),
                                    local)]


def drain_local(x: torch.Tensor | Sequence[torch.Tensor]) -> np.ndarray:
    """Fetch only this process's shards, concatenated in index order (a
    tensor is already one)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.concatenate([s.detach().cpu().numpy() for s in x], axis=-1)


def is_coordinator() -> bool:
    return process_index() == 0
