"""HPCG's official operations of every set the window completed, over the
whole window (device synchronised at both ends)."""


def value(run):
    return len(run.units) * run.facts["flops_per_unit"] / run.window_s / 1e9
