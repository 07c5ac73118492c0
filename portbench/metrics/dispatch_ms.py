"""Host ms a step of the compiled graph's eager dispatch
(``CompiledGraph.step``): the ``scheduler.dispatch`` spans over the traced
steps."""


def read(run):
    t = run.trace
    if t is None or "scheduler.dispatch" not in t.spans_s:
        return None
    return t.spans_s["scheduler.dispatch"] / t.steps * 1e3
