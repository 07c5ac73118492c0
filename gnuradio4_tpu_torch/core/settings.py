"""Staged / contextual block settings.

Reference model (core/include/gnuradio-4.0/Settings.hpp): every block has reflected,
annotated settings members (``Annotated<T, description, Doc/Unit/Limits…>``,
annotated.hpp:1-80). Writes are *staged* and only *applied* at a safe point in the work
loop (Settings.hpp:371 ``stageParameters``/``applyStagedParameters``); time/named
**contexts** hold parameter presets switched by tags (Settings.hpp:215 ``SettingsCtx``);
tag keys matching setting names auto-update settings (Settings.hpp:329); applied changes
can auto-forward downstream as tags (ApplyStagedParametersResult.forwardParameters).

Settings split into two kinds —

- ``dynamic``: numeric leaves handed to every step as host *parameters* (the step's
  params dict), so a change needs no recompile;
- ``static``: values that shape the compiled graph (tap counts, FFT size, dtypes);
  changing one marks the graph dirty and triggers a recompile at the next step
  boundary — the analog of the reference renegotiating chunk sizes per work() call.

Application happens between scheduler steps, matching the reference's chunk-boundary
semantics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np

from .errors import SettingsError

_UNSET = object()


@dataclasses.dataclass
class Setting:
    """Declarative, self-documenting setting descriptor (≈ ``Annotated``)."""

    default: Any = None
    description: str = ""
    unit: str = ""
    limits: tuple[float, float] | None = None
    choices: tuple[Any, ...] | None = None
    visible: bool = True
    kind: str = "dynamic"  # 'dynamic' | 'static'
    dtype: Any = None      # numpy dtype for dynamic leaves (None → infer)
    validator: Callable[[Any], bool] | None = None
    name: str = ""         # filled by __set_name__

    def __set_name__(self, owner, name):
        self.name = name
        # register on the owning class
        reg = owner.__dict__.get("_settings_spec")
        if reg is None:
            reg = dict(getattr(owner, "_settings_spec", {}))  # inherit parent spec
            setattr(owner, "_settings_spec", reg)
        reg[name] = self

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.settings.get(self.name)

    def __set__(self, obj, value):
        obj.settings.set({self.name: value})

    def validate(self, value: Any) -> Any:
        # coerce numeric strings (YAML 1.1 parses "1.0e6" as a string) when the
        # default shows the setting is numeric
        if isinstance(value, str) and isinstance(self.default, (int, float)) \
                and not isinstance(self.default, bool):
            try:
                value = float(value)
                if isinstance(self.default, int) and float(value).is_integer():
                    value = int(value)
            except ValueError:
                pass
        if self.limits is not None:
            lo, hi = self.limits   # None = unbounded on that side
            v = np.asarray(value, dtype=float)
            if (lo is not None and np.any(v < lo)) \
                    or (hi is not None and np.any(v > hi)):
                raise SettingsError(f"setting {self.name!r}={value!r} outside limits [{lo}, {hi}]")
        if self.choices is not None and value not in self.choices:
            raise SettingsError(f"setting {self.name!r}={value!r} not in {self.choices}")
        if self.validator is not None and not self.validator(value):
            raise SettingsError(f"setting {self.name!r}={value!r} failed validation")
        return value


@dataclasses.dataclass(frozen=True, order=True)
class SettingsCtx:
    """Context key for parameter presets (≈ Settings.hpp:215)."""

    time: float = 0.0
    context: str = ""


@dataclasses.dataclass
class ApplyResult:
    """≈ ApplyStagedParametersResult (Settings.hpp:77)."""

    applied: dict[str, Any] = dataclasses.field(default_factory=dict)
    forward: dict[str, Any] = dataclasses.field(default_factory=dict)
    static_changed: bool = False


class Settings:
    """Per-block settings store with staged→applied lifecycle and contexts."""

    def __init__(self, spec: dict[str, Setting], init: dict[str, Any] | None = None):
        self._spec = spec
        self._applied: dict[str, Any] = {k: s.default for k, s in spec.items()}
        self._staged: dict[str, Any] = {}
        self._defaults: dict[str, Any] = dict(self._applied)
        self._contexts: dict[SettingsCtx, dict[str, Any]] = {}
        self._active_ctx = SettingsCtx()
        # stored presets older than now − expiry_time are pruned on the next
        # set() (≈ CtxSettings::expiry_time, Settings.hpp; seconds here —
        # the reference counts nanoseconds)
        self.expiry_time: float = float("inf")
        self._auto_update_keys = set(spec)  # tag keys that auto-stage (Settings.hpp:329)
        self._auto_forward_keys = {"sample_rate", "signal_name", "signal_unit"} & set(spec)
        if init:
            self.set(init)
            self.apply_staged()

    # -- introspection ---------------------------------------------------------
    @property
    def spec(self) -> dict[str, Setting]:
        return self._spec

    def keys(self):
        return self._spec.keys()

    def get(self, key: str, default: Any = _UNSET) -> Any:
        if key in self._applied:
            return self._applied[key]
        if default is not _UNSET:
            return default
        raise SettingsError(f"unknown setting {key!r}; known: {sorted(self._spec)}")

    def as_dict(self) -> dict[str, Any]:
        return dict(self._applied)

    def changed(self) -> bool:
        return bool(self._staged)

    # -- staging ---------------------------------------------------------------
    def set(self, values: dict[str, Any], ctx: SettingsCtx | None = None) -> dict[str, Any]:
        """Stage values; unknown keys are returned (reference returns unapplied map)."""
        unknown: dict[str, Any] = {}
        target = self._staged if ctx is None or ctx == self._active_ctx else self._contexts.setdefault(ctx, {})
        for k, v in values.items():
            s = self._spec.get(k)
            if s is None:
                unknown[k] = v
                continue
            target[k] = s.validate(v)
        if ctx is not None and ctx != self._active_ctx:
            self._prune_stored(now=None, context=ctx.context)
        return unknown

    def _prune_stored(self, now: float | None, context: str) -> None:
        """Drop superseded/expired time-multiplexed presets for ``context``
        (≈ CtxSettings auto-cleanup, qa_Settings.cpp:744 "Expired
        Parameters"): keep the LATEST past preset plus every future one,
        minus anything older than ``expiry_time``."""
        import time as _time
        now = _time.time() if now is None else now
        group = sorted((c for c in self._contexts if c.context == context),
                       key=lambda c: c.time)
        past = [c for c in group if c.time <= now]
        keep = set(group) - set(past[:-1])          # all futures + latest past
        if past and now - past[-1].time > self.expiry_time:
            keep.discard(past[-1])                  # even the latest expired
        for c in group:
            if c not in keep:
                del self._contexts[c]

    def get_stored(self, keys: str | list[str] | None = None,
                   ctx: SettingsCtx | None = None):
        """Time-resolved stored-preset query (≈ CtxSettings::getStored,
        qa_Settings.cpp:650 "CtxSettings Time"): among presets whose context
        string matches ``ctx.context``, pick the latest with time ≤
        ``ctx.time`` (now when ``ctx`` is None). Returns the value (single
        key), a dict (key list / None = all), or None when every stored
        preset lies in the future."""
        import time as _time
        if ctx is None:
            ctx = SettingsCtx(time=_time.time())
        elif ctx.time == 0.0 and not ctx.context:
            ctx = SettingsCtx(time=_time.time())
        candidates = [c for c in self._contexts
                      if c.context == ctx.context and c.time <= ctx.time]
        if not candidates:
            return None
        best = max(candidates, key=lambda c: c.time)
        params = self._contexts[best]
        if keys is None:
            return dict(params)
        if isinstance(keys, str):
            return params.get(keys)
        return {k: params[k] for k in keys if k in params}

    def auto_update(self, tag_map: dict[str, Any]) -> dict[str, Any]:
        """Stage settings from an incoming tag map (keys matching setting
        names). Returns the staged hits so the scheduler can build
        sample-accurate parameter ramps for them."""
        hits = {k: v for k, v in tag_map.items() if k in self._auto_update_keys}
        if hits:
            self.set(hits)
        return hits

    def apply_staged(self) -> ApplyResult:
        res = ApplyResult()
        for k, v in self._staged.items():
            if not _equal(self._applied.get(k), v):
                self._applied[k] = v
                res.applied[k] = v
                if self._spec[k].kind == "static":
                    res.static_changed = True
                if k in self._auto_forward_keys:
                    res.forward[k] = v
        self._staged.clear()
        return res

    # -- defaults (Settings.hpp:407-408) --------------------------------------
    def store_defaults(self) -> None:
        self._defaults = dict(self._applied)

    def reset_defaults(self) -> None:
        self._staged.update(self._defaults)

    # -- contexts --------------------------------------------------------------
    @property
    def active_context(self) -> SettingsCtx:
        return self._active_ctx

    def stored_contexts(self) -> list[SettingsCtx]:
        return sorted(self._contexts)

    def activate_context(self, ctx: SettingsCtx) -> None:
        if ctx != self._active_ctx and ctx in self._contexts:
            self._staged.update(self._contexts[ctx])
        self._active_ctx = ctx

    def activate_context_for_time(self, time: float) -> None:
        """Pick the latest stored context whose time ≤ time (time-multiplexed presets)."""
        candidates = [c for c in self._contexts if c.time <= time]
        if candidates:
            self.activate_context(max(candidates, key=lambda c: c.time))

    def remove_context(self, ctx: SettingsCtx) -> bool:
        return self._contexts.pop(ctx, None) is not None

    # -- param pytree splitting ------------------------------------------------
    def dynamic_params(self) -> dict[str, Any]:
        """Leaves handed to each step as parameters (change ⇒ no recompile)."""
        out = {}
        for k, s in self._spec.items():
            if s.kind != "dynamic":
                continue
            v = self._applied[k]
            if v is None:
                continue
            arr = np.asarray(v, dtype=s.dtype) if s.dtype is not None \
                else np.asarray(v)
            if arr.dtype.kind in "USO":
                # strings/objects are not numeric step parameters — fail
                # here with guidance instead of deep inside a block's apply
                raise SettingsError(
                    f"dynamic setting {k!r} has non-numeric value {v!r} "
                    f"(dtype {arr.dtype}); declare it kind='static' — "
                    f"string settings cannot be runtime parameters")
            out[k] = arr
        return out

    def static_params(self) -> dict[str, Any]:
        return {k: self._applied[k] for k, s in self._spec.items() if s.kind == "static"}


def _equal(a: Any, b: Any) -> bool:
    try:
        if isinstance(a, (float, int)) and isinstance(b, (float, int)):
            return a == b or (isinstance(a, float) and isinstance(b, float)
                              and math.isnan(a) and math.isnan(b))
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))
    except Exception:
        return a is b
