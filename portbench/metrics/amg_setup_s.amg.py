"""Host seconds of ``AMGPreconditioner``'s constructor in set-up, device
synchronised at both ends."""


def read(run):
    return run.host_times.get("amg_setup_s")
