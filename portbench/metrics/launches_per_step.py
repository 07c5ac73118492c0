"""CUDA kernels in the torch.profiler trace of the traced window, a step."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return t.kernels / t.steps
