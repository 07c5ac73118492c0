"""1 − the union of kernel and memory-copy intervals over the traced
window, in %."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
