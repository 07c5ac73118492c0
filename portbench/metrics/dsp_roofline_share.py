"""The configuration's least time a step (its ``least_work`` through the
yardstick's ``bound_ms``: FLOPs over 67 TFLOP/s or bytes over 3.35 TB/s,
the larger) over the DSP layer's device time a step (``dsp_device_ms``:
all the window's device time), in %."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0.0:
        return None
    return 100.0 * run.least_ms / (t.busy_s / t.steps * 1e3)
