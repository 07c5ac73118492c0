"""Device ms a step inside the channelizer block's range (the harness's
``portbench.block.pfb``): the oversampled bank's branch FIRs, FFT and
phase-and-transpose pass."""


def read(run):
    t = run.trace
    if t is None or t.block_device_s.get("pfb", 0.0) <= 0.0:
        return None
    return t.block_device_s["pfb"] / t.steps * 1e3
