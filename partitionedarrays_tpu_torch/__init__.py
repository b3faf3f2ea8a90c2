"""partitionedarrays_tpu_torch: the PyTorch and CUDA port of
partitionedarrays_tpu, for one NVIDIA H100.

The JAX package ``partitionedarrays_tpu`` is the reference; this package
mirrors its layout module by module and imports torch, never jax.  Tensors
carry the part axis first (``[P, ...]``), every constructor takes an
explicit ``device``, and the TPU kernels on the ported path are CUDA
kernels written for Hopper (``csrc/``), built with ``nvcc`` on first use.
A CPU tensor runs each kernel's plain PyTorch version instead.

So far the port covers the HPCG benchmark on one part; see ROADMAP.md.
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
