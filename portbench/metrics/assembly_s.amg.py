"""Host seconds of the assembly in set-up (``linear_elasticity_fem`` and
``psparse``, frozen on the device), device synchronised at both ends."""


def read(run):
    return run.host_times.get("assembly_s")
