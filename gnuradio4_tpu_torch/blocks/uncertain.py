"""UncertainValue as a stream sample type.

The reference templates math/filter/converter blocks on
``gr::UncertainValue<T>`` (meta/UncertainValue.hpp; registrations at
Math.hpp:25-28,68-71 and time_domain_filter.hpp:213), so a value±sigma pair
*is* the sample flowing through the graph. Here, as in the JAX package, an
uncertain stream is a **2-plane float32 stream** — ``channels == 2``, plane 0
the value, plane 1 the (non-negative) 1-sigma uncertainty. It is a plain
tensor, so every piece of runtime machinery (tags, checkpoints, YAML, file IO)
handles it untouched; blocks that compute opt in with ``uncertain=True`` and
run the first-order Gaussian algebra of :class:`utils.uncertain.
UncertainValue` on the planes.

Plane-agnostic blocks need no opt-in at all: ``Decimator``, ``Selector``,
``Delay``, file IO … treat the plane axis as channels and are automatically
uncertainty-correct (sample reordering touches both planes identically).

:class:`ToUncertain` / :class:`FromUncertain` are the boundary converters
(≈ the reference's value/uncertainty access, UncertainValue.hpp value()/
uncertainty()).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.errors import GrError
from ..core.registry import register_block
from ..core.settings import Setting
from ..utils.uncertain import UncertainValue


def uv_split(x: torch.Tensor) -> UncertainValue:
    """(…, 2, T) plane tensor → UncertainValue of the two planes."""
    return UncertainValue(x[..., 0, :], x[..., 1, :])


def uv_join(uv: UncertainValue) -> torch.Tensor:
    """UncertainValue → (…, 2, T) plane tensor (sigma clamped non-negative)."""
    v = uv.value.to(torch.float32)
    s = torch.as_tensor(uv.uncertainty, device=v.device).to(torch.float32).abs()
    return torch.stack([v, torch.broadcast_to(s, v.shape)], dim=-2)


def check_uncertain_channels(ctx, port: str, block_name: str) -> None:
    """An uncertain stream is exactly the 2-plane pair (scalar samples)."""
    ch = ctx.channels.get(port, 0)
    if ch != 2:
        raise GrError(
            f"{block_name}: uncertain=True expects a 2-plane (value, sigma) "
            f"stream on '{port}' (channels == 2), got channels={ch}; build "
            f"one with ToUncertain")


@register_block("ToUncertain")
class ToUncertain(Block):
    """Pair a value stream with its 1-sigma uncertainty → uncertain stream.

    ``sigma`` rides a second input port when connected; otherwise the constant
    ``sigma_const`` applies (e.g. a digitizer's fixed noise floor).
    """

    IN = (Port("in", dtype="float32"),
          Port("sigma", dtype="float32", optional=True))
    OUT = (Port("out", dtype="float32"),)
    sigma_const = Setting(default=0.0, limits=(0.0, None),
                          description="uncertainty when no sigma port is fed")

    def out_channels(self, port, in_channels):
        if in_channels.get("in", 0) != 0:
            raise GrError(f"{self.name}: ToUncertain expects scalar (1-D) "
                          f"inputs, got channels={in_channels.get('in')}")
        return 2

    def apply(self, state, ins, ctx):
        v = ins["in"].to(torch.float32)
        if "sigma" in ins:
            s = ins["sigma"].to(torch.float32).abs()
        else:
            s = torch.full_like(v, float(np.float32(ctx.p("sigma_const", 0.0))))
        return state, {"out": torch.stack([v, s], dim=-2)}


@register_block("FromUncertain")
class FromUncertain(Block):
    """Split an uncertain stream back into value and sigma streams."""

    IN = (Port("in", dtype="float32"),)
    OUT = (Port("value", dtype="float32"), Port("sigma", dtype="float32"))

    def out_channels(self, port, in_channels):
        if in_channels.get("in", 0) != 2:
            raise GrError(f"{self.name}: FromUncertain expects a 2-plane "
                          f"uncertain stream (channels == 2), got "
                          f"channels={in_channels.get('in')}")
        return 0

    def apply(self, state, ins, ctx):
        x = ins["in"]
        return state, {"value": x[..., 0, :], "sigma": x[..., 1, :]}
