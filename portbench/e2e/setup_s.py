"""Process start to the first timed unit: imports, the kernels' load (or
build, in a checkout's first run), the problem's build, the port's set-up,
the right-hand sides and one warm unit."""


def value(run):
    return run.setup_s
