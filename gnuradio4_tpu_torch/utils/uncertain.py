"""UncertainValue — value ± uncertainty arithmetic
(≈ reference meta/UncertainValue.hpp: a first-class sample type for math/filter/
electrical blocks).

Values and uncertainties are torch tensors (or host numbers); propagation
follows first-order (Gaussian, uncorrelated) rules, as in the JAX package's
``utils/uncertain.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def _tensor(v, like=None) -> torch.Tensor:
    """``v`` as a tensor: a host number becomes a float32 0-d tensor on the
    device of ``like`` (the other operand)."""
    if torch.is_tensor(v):
        return v
    dev = like.device if torch.is_tensor(like) else None
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def _hypot32(a, b) -> torch.Tensor:
    a = _tensor(a, b).to(torch.float32)
    return torch.hypot(a, _tensor(b, a).to(torch.float32))


@dataclasses.dataclass
class UncertainValue:
    value: Any
    uncertainty: Any = 0.0

    # -- arithmetic (uncorrelated first-order propagation) --------------------
    def _coerce(self, other) -> "UncertainValue":
        if isinstance(other, UncertainValue):
            return other
        return UncertainValue(other, 0.0)

    def __add__(self, other):
        o = self._coerce(other)
        return UncertainValue(self.value + o.value,
                              _hypot32(self.uncertainty, o.uncertainty))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        return UncertainValue(self.value - o.value,
                              _hypot32(self.uncertainty, o.uncertainty))

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    def __mul__(self, other):
        o = self._coerce(other)
        sv, ov = _tensor(self.value, o.value), _tensor(o.value, self.value)
        u = torch.hypot(_tensor(self.uncertainty, sv) * ov,
                        _tensor(o.uncertainty, sv) * sv)
        return UncertainValue(sv * ov, u.abs())

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        sv, ov = _tensor(self.value, o.value), _tensor(o.value, self.value)
        u = torch.hypot(_tensor(self.uncertainty, sv) / ov,
                        _tensor(o.uncertainty, sv) * sv / (ov * ov))
        return UncertainValue(sv / ov, u.abs())

    def __rtruediv__(self, other):
        return self._coerce(other).__truediv__(self)

    def __neg__(self):
        return UncertainValue(-self.value, self.uncertainty)

    def sqrt(self):
        v = torch.sqrt(_tensor(self.value))
        return UncertainValue(v, _tensor(self.uncertainty, v) / (2.0 * v))

    def __repr__(self):
        return f"UncertainValue({self.value!r} ± {self.uncertainty!r})"

    def nominal(self):
        return self.value

    def relative(self):
        v = _tensor(self.value)
        return (_tensor(self.uncertainty, v) / v).abs()
