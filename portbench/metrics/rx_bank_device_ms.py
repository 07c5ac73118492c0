"""Device ms a step inside the ranges of the receivers that run on every
channel (``portbench.block.demod``, ``.audio_fir`` and ``.deemph``,
together): the code that fm_monitor's receiver shares, on [M, T] streams."""

BLOCKS = ("demod", "audio_fir", "deemph")


def read(run):
    t = run.trace
    if t is None or not any(b in t.block_device_s for b in BLOCKS):
        return None
    return sum(t.block_device_s.get(b, 0.0) for b in BLOCKS) / t.steps * 1e3
