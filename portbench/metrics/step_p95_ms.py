"""The 95th percentile, over every step of the window, of the interval
between consecutive steps' completion on the card (a CUDA event recorded
after each step's dispatch; the first interval from the window's start)."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.window["intervals_ms"]), 95))
