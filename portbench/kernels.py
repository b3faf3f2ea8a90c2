"""The port's compiled libraries, loaded in set-up on a clock of their own
(``kernels_s``).  In a checkout's first run they are built there (``nvcc``
into ``build/torch_kernels/``, ``g++`` into ``build/torch_native/``), so the
run that compiles says so apart from the rest of ``setup_s``; every later
run finds them built and only loads them."""
from __future__ import annotations


def load(clock, device, native: bool = False) -> None:
    """Load the CUDA kernels (on a card) and, with ``native``, the host
    setup library; note in ``clock.notes`` whether this run built them."""
    from partitionedarrays_tpu_torch import _build
    from partitionedarrays_tpu_torch.ops import native as host

    libs = []
    if device.type == "cuda":
        libs.append((_build.library_path(), _build.library))
    if native:
        libs.append((host.library_path(), host.library))
    built_before = all(path.exists() for path, _ in libs)
    with clock("kernels_s"):
        for _, load_lib in libs:
            load_lib()
    clock.notes["kernels"] = "loaded, built before" if built_before else "built in this run"
