"""The bank's least time a step (the configuration's ``bank_least_work``
through the yardstick's ``bound_ms``: FLOPs over 67 TFLOP/s or bytes over
3.35 TB/s, the larger) over ``pfb_device_ms``, in %."""

from portbench.yardstick import bound_ms


def read(run):
    t = run.trace
    work = getattr(run.cell.cfg_mod, "bank_least_work", None)
    if t is None or work is None or t.block_device_s.get("pfb", 0.0) <= 0.0:
        return None
    least_ms, _by = bound_ms(*work(run.cell.cfg, run.block_len))
    return 100.0 * least_ms / (t.block_device_s["pfb"] / t.steps * 1e3)
