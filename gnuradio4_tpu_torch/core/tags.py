"""Tag (per-sample metadata) records (reference: core/include/gnuradio-4.0/Tag.hpp:98).

Tags ride a host-side sideband keyed by absolute sample index. This slice of the
port carries the records and the propagation policies blocks declare; the
scheduler's tag walk comes with a later slice.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any


@dataclasses.dataclass(frozen=True, order=True)
class Tag:
    """A tag at an absolute sample index with an arbitrary property map."""

    index: int
    map: dict[str, Any] = dataclasses.field(compare=False, default_factory=dict)

    def shifted(self, delta: int) -> "Tag":
        return Tag(self.index + delta, self.map)


class TagPropagation(enum.Enum):
    """≈ reference tag-propagation policies (annotated.hpp:79, Block.hpp:726-729)."""

    TPP_DONT = "dont"
    TPP_ALL_TO_ALL = "all_to_all"
    TPP_ONE_TO_ONE = "one_to_one"
    TPP_CUSTOM = "custom"
