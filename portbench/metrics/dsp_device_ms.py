"""Device ms a step of the DSP layer: every kernel and copy of the traced
window, a step (the harness's source and sinks launch none). The breakdown
splits it by block's range, and names the part that no block's range
holds."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0.0:
        return None
    return t.busy_s / t.steps * 1e3
