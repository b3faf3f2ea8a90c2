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
float64 and df64, the Krylov solvers of ``solvers/krylov.py``, the COO
assembly of ``models/gallery.py``'s problems and smoothed-aggregation AMG
(``solvers/amg.py``) on one part and on many parts of the serial backend,
the fixed-sparsity reuse tier (``psparse_refill``, ``psystem_refill``,
the ``_into`` products, ``AMGPreconditioner.update``) and the Newton and
backward-Euler layers (``solvers/nonlinear.py``, ``solvers/ode.py``), and
additive Schwarz (``AdditiveSchwarz``: dense LU or ILU(0) local solves, the
latter as exact triangular solves on the tile kernel; also as AMG level
smoothers) with the native host setup library (``ops/native.py``); see
ROADMAP.md.
"""
from . import config
from .backends import SerialBackend
from .models.hpcg import HPCGMGPreconditioner, build_hpcg_problem, hpcg_benchmark
from .psparse import PSparseMatrix, psparse_refill, psystem, psystem_refill, spmv
from .pvector import PVector, axpy, pdot, pnorm, pones, pvector_from_own, pzeros
from .solvers.amg import AMGParams, AMGPreconditioner
from .solvers.interfaces import additive_schwarz_solver
from .solvers.nonlinear import newton_raphson
from .solvers.ode import backward_euler
from .solvers.smoothers import AdditiveSchwarz, additive_schwarz

__all__ = [
    "config",
    "SerialBackend",
    "HPCGMGPreconditioner",
    "build_hpcg_problem",
    "hpcg_benchmark",
    "PSparseMatrix",
    "psparse_refill",
    "psystem",
    "psystem_refill",
    "spmv",
    "newton_raphson",
    "backward_euler",
    "AMGParams",
    "AMGPreconditioner",
    "AdditiveSchwarz",
    "additive_schwarz",
    "additive_schwarz_solver",
    "PVector",
    "axpy",
    "pdot",
    "pnorm",
    "pones",
    "pvector_from_own",
    "pzeros",
]
