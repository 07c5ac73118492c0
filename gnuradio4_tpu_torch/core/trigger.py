"""Trigger predicate matching (≈ reference core TriggerMatcher.hpp:19-60).

The reference DSL matches trigger tags by ``"name[/ctx]"`` with optional
``[t_min, t_max]`` ranges and single-shot/repeat semantics. Here a matcher is a
predicate over a tag's property map; the string form supports:

    "CMD_BP_START"                    trigger_name equality
    "CMD_BP_START/FAIR.SELECTOR.C=1"  name + context equality
    "^CMD_"                           regex on trigger_name (leading ^ enables)
    "name_a|name_b"                   alternatives

Matchers return one of Matched / NotMatched / Ignore — the same tri-state the
reference uses to window multiplexed captures.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Callable

from .tags import Keys, Tag


class MatchResult(enum.Enum):
    MATCHED = "Matched"
    NOT_MATCHED = "NotMatched"
    IGNORE = "Ignore"


Matcher = Callable[[Tag], MatchResult]


def match_trigger(pattern: str) -> Matcher:
    """Build a matcher from the string DSL."""
    alternatives = [p.strip() for p in pattern.split("|") if p.strip()]

    def one(p: str) -> Callable[[Tag], bool]:
        if "/" in p:
            name, ctx = p.split("/", 1)
            def pred(tag: Tag, name=name, ctx=ctx) -> bool:
                return (str(tag.map.get(Keys.TRIGGER_NAME, "")) == name
                        and str(tag.map.get(Keys.CONTEXT, "")) == ctx)
            return pred
        if p.startswith("^"):
            rx = re.compile(p)
            return lambda tag, rx=rx: bool(
                rx.search(str(tag.map.get(Keys.TRIGGER_NAME, ""))))
        return lambda tag, p=p: str(tag.map.get(Keys.TRIGGER_NAME, "")) == p

    preds = [one(p) for p in alternatives]

    def matcher(tag: Tag) -> MatchResult:
        if Keys.TRIGGER_NAME not in tag.map:
            return MatchResult.IGNORE
        return (MatchResult.MATCHED if any(p(tag) for p in preds)
                else MatchResult.NOT_MATCHED)

    return matcher


def start_stop_matchers(start: str, stop: str) -> tuple[Matcher, Matcher]:
    return match_trigger(start), match_trigger(stop)


@dataclasses.dataclass
class TriggerWindow:
    """An open capture window (multiplexed / triggered acquisition)."""

    start_index: int
    stop_index: int | None = None
    trigger: Tag | None = None


# -- reference-fidelity stateful matcher ---------------------------------------

def _parse_part(part: str) -> tuple[str, str, bool, bool]:
    """Parse one ``name[/ctx]`` filter part with optional ``^`` "ends" prefixes
    (≈ TriggerMatcher.hpp:79 detail::parse)."""
    part = part.strip()
    if "/" in part:
        name, _, ctx = part.partition("/")
        if "/" in ctx:
            from .errors import GrError
            raise GrError(f"invalid trigger input: multiple '/' separators "
                          f"found: {part!r}")
        name, ctx = name.strip(), ctx.strip()
    else:
        name, ctx = part, ""
    name_ends = name.startswith("^")
    if name_ends:
        name = name[1:].strip()
    ctx_ends = ctx.startswith("^")
    if ctx_ends:
        ctx = ctx[1:].strip()
    return name, ctx, name_ends, ctx_ends


class BasicTriggerNameCtxMatcher:
    """Stateful start/stop/single trigger matcher — exact behavioral twin of the
    reference's ``BasicTriggerNameCtxMatcher`` (TriggerMatcher.hpp:104-343).

    Filter syntax: ``"[<start name>/<ctx1>, <stop name>/<ctx2>]"`` or a bare
    ``"name[/ctx]"`` (single trigger). A ``^`` prefix on a name/ctx marks an
    "ends" matcher: the window boundary lands at the first subsequent tag that
    *stops* matching that part (TriggerMatcher.hpp:88-93).

    The match state lives in an explicit dict (``new_state()``) so callers can
    keep several concurrent window states (StreamToDataSet overlapping windows,
    StreamToDataSet.hpp:276-286) and probe with throwaway copies.
    """

    def __init__(self, filter_str: str):
        from .errors import GrError
        self.filter = filter_str
        s = filter_str.strip()
        if s.startswith("[") and s.endswith("]"):
            s = s[1:-1]
        elif s.startswith("[") != s.endswith("]"):
            raise GrError(f"unmatched bracket pair: {filter_str!r}")
        start_part, _, stop_part = s.partition(",")
        start_part, stop_part = start_part.strip(), stop_part.strip()

        self.start_name = self.start_ctx = ""
        self.stop_name = self.stop_ctx = ""
        self.start_name_ends = self.start_ctx_ends = False
        self.stop_name_ends = self.stop_ctx_ends = False
        self.start_defined = bool(start_part)
        self.stop_defined = bool(stop_part)
        if start_part:
            (self.start_name, self.start_ctx,
             self.start_name_ends, self.start_ctx_ends) = _parse_part(start_part)
        if stop_part:
            (self.stop_name, self.stop_ctx,
             self.stop_name_ends, self.stop_ctx_ends) = _parse_part(stop_part)

        # a lone stop acts as the start (TriggerMatcher.hpp:220-232; only the
        # name/ctx strings move — the "ends" flags stay put, as in the reference)
        if (self.start_defined != self.stop_defined) and self.stop_defined:
            self.start_name, self.start_ctx = self.stop_name, self.stop_ctx
            self.stop_name = self.stop_ctx = ""
        # identical start/stop degenerates to a single trigger (hpp:240-245)
        if (self.start_name == self.stop_name
                and self.start_ctx == self.stop_ctx):
            self.start_defined, self.stop_defined = True, False
            self.stop_name = self.stop_ctx = ""
        self.is_single = self.start_defined != self.stop_defined

    @staticmethod
    def new_state() -> dict:
        return {"active": False, "wait_start": False, "wait_stop": False}

    @staticmethod
    def reset(state: dict) -> None:
        state["active"] = state["wait_start"] = state["wait_stop"] = False

    def __call__(self, tag: Tag | None, state: dict) -> MatchResult:
        if tag is None or not tag.map or not (self.start_defined
                                              or self.stop_defined):
            return MatchResult.IGNORE
        name = str(tag.map.get(Keys.TRIGGER_NAME, ""))
        ctx = str(tag.map.get(Keys.CONTEXT, ""))

        if self.is_single:
            # note the containment direction: the tag ctx must be contained IN
            # the filter ctx for single triggers (TriggerMatcher.hpp:286)
            if ((not self.start_name or name == self.start_name)
                    and (not self.start_ctx or ctx in self.start_ctx)):
                state["wait_start"] = (self.start_name_ends
                                       or self.start_ctx_ends)
                return MatchResult.MATCHED
            return MatchResult.IGNORE

        if not state["active"] or state["wait_start"]:
            match = ((not self.start_name or name == self.start_name)
                     and (not self.start_ctx or self.start_ctx in ctx))
            if match:
                state["active"] = True
                state["wait_start"] = (self.start_name_ends
                                       or self.start_ctx_ends)
                return (MatchResult.IGNORE if state["wait_start"]
                        else MatchResult.MATCHED)
            if state["wait_start"]:
                state["wait_start"] = False
                return MatchResult.MATCHED
        else:
            match = ((not self.stop_name or name == self.stop_name)
                     and (not self.stop_ctx or self.stop_ctx in ctx))
            if match or state["wait_stop"]:
                state["wait_stop"] = (self.stop_name_ends
                                      or self.stop_ctx_ends)
                if not state["wait_stop"] or not match:
                    self.reset(state)
                    return MatchResult.NOT_MATCHED
                return MatchResult.IGNORE
        return MatchResult.IGNORE
