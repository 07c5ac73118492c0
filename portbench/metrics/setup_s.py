"""From process start to the first timed step: import, CUDA context, kernel
load or build, the replay buffer, the graph's compile and the warm-up
steps."""


def read(run):
    return run.setup_s
