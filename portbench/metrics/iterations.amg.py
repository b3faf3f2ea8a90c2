"""The mean of ``info.iterations`` over the window's solves."""


def read(run):
    its = [run.facts["iterations"][i] for i in run.units]
    return sum(its) / len(its)
