"""partitionedarrays_tpu_torch: the PyTorch and CUDA port of
partitionedarrays_tpu, for one NVIDIA H100.

The JAX package ``partitionedarrays_tpu`` is the reference; this package
mirrors its layout module by module and imports torch, never jax.  Tensors
carry the part axis first (``[P, ...]``), every constructor takes a
``device`` that defaults to the card (``"cuda"``, no fallback), and the
TPU kernels on the ported path are CUDA kernels written for Hopper
(``csrc/``), built with ``nvcc`` on first use.  A CPU tensor runs each
kernel's plain PyTorch version instead.

So far the port covers the HPCG benchmark on one part and on many parts
stacked on one device (ghost exchange, own-ghost block) in float32,
float64 and df64, the Krylov solvers of ``solvers/krylov.py``, and on one
part the COO assembly of ``models/gallery.py``'s problems with
smoothed-aggregation AMG (``solvers/amg.py``); see ROADMAP.md.
"""
from . import config
from .backends import SerialBackend
from .models.hpcg import HPCGMGPreconditioner, build_hpcg_problem, hpcg_benchmark
from .psparse import PSparseMatrix, spmv
from .pvector import PVector, axpy, pdot, pnorm, pones, pvector_from_own, pzeros

__all__ = [
    "config",
    "SerialBackend",
    "HPCGMGPreconditioner",
    "build_hpcg_problem",
    "hpcg_benchmark",
    "PSparseMatrix",
    "spmv",
    "PVector",
    "axpy",
    "pdot",
    "pnorm",
    "pones",
    "pvector_from_own",
    "pzeros",
]
