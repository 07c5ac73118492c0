"""ComputeDomain — device-placement descriptor (≈ reference core
ComputeDomain.hpp:16-60: {kind, access, backend, deviceIndex, tag}, parse
"kind:backend:idx"; consumed per-Edge/per-Port).

The port's domains:

- ``gpu`` (default, backend ``cuda``): the block's ``apply`` runs in the
  compiled step on the graph's device;
- ``host``: the block runs on the host (sinks/sources/HostBlock — anything with
  FEED/HOST_TAP/consume). An edge annotated ``host`` forces its destination's
  inputs through the host each step (the compiler marks it HOST_TAP).

``tpu`` and ``fpga`` parse, as in the JAX package, but a graph that asks for
them does not compile here.
"""

from __future__ import annotations

import dataclasses
import enum

from .errors import GrError


class DomainKind(enum.Enum):
    HOST = "host"
    TPU = "tpu"
    GPU = "gpu"
    FPGA = "fpga"


class Access(enum.Enum):
    HOST_ONLY = "HostOnly"
    SHARED = "Shared"
    DEVICE_ONLY = "DeviceOnly"


# the backend a bare kind stands for
_DEFAULT_BACKEND = {DomainKind.GPU: "cuda", DomainKind.TPU: "xla"}


@dataclasses.dataclass(frozen=True)
class ComputeDomain:
    kind: DomainKind = DomainKind.GPU
    backend: str = "cuda"
    device_index: int = 0
    access: Access = Access.SHARED
    tag: str = ""

    @classmethod
    def parse(cls, spec: str) -> "ComputeDomain":
        """Parse "kind[:backend[:idx]]" (≈ ComputeDomain.hpp:50)."""
        parts = str(spec).split(":")
        try:
            kind = DomainKind(parts[0].lower())
        except ValueError as e:
            raise GrError(f"unknown compute-domain kind {parts[0]!r}; "
                          f"known: {[k.value for k in DomainKind]}") from e
        backend = parts[1] if len(parts) > 1 and parts[1] else \
            _DEFAULT_BACKEND.get(kind, "")
        idx = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        return cls(kind=kind, backend=backend, device_index=idx)

    def __str__(self) -> str:
        return f"{self.kind.value}:{self.backend}:{self.device_index}"


DEFAULT_DEVICE = ComputeDomain()
HOST = ComputeDomain(kind=DomainKind.HOST, backend="", access=Access.HOST_ONLY)
