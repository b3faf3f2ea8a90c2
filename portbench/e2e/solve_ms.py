"""The whole window over the solves it completed."""


def value(run):
    return 1e3 * run.window_s / len(run.units)
