"""Host ms a step of the scheduler's pump: the port Profiler's
``scheduler.step`` spans over the traced steps."""


def read(run):
    t = run.trace
    if t is None or "scheduler.step" not in t.spans_s:
        return None
    return t.spans_s["scheduler.step"] / t.steps * 1e3
