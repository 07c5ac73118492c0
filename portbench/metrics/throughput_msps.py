"""Input samples of every step completed in the window, over the window's
seconds (host clock, the window closed by a synchronize), in Msps."""


def read(run):
    w = run.window
    return w["steps"] * run.block_len / w["seconds"] / 1e6
