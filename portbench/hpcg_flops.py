"""HPCG's official FLOP model, frozen here so that the yardstick of
``hpcg_gflops`` cannot move with the program.

Copied from ``partitionedarrays_tpu_torch/models/hpcg/report.py``
(``HPCGReport.flops``, itself HPCG/src/report_results.jl:27-40): the
official float64 + CSR accounting, whatever the implementation stores.
"""
from __future__ import annotations

from typing import Dict, Sequence


def flops(nrow: int, nnz: int, nnz_per_level: Sequence[int], iterations: int,
          n_sets: int) -> Dict[str, float]:
    """Operations of ``n_sets`` sets of ``iterations`` PCG iterations on the
    fine operator (``nrow`` rows, ``nnz`` entries) with a V-cycle over
    ``nnz_per_level`` (coarsest first)."""
    it = iterations * n_sets
    sets = n_sets
    f_ddot = (3.0 * it + sets) * 2.0 * nrow
    f_waxpby = (3.0 * it + sets) * 2.0 * nrow
    f_spmv = (it + sets) * 2.0 * nnz
    f_mg = 0.0
    levels = list(nnz_per_level)
    # fine levels: pre-smooth (sym GS ~ 4 nnz) + residual SpMV (2 nnz)
    # + post-smooth (4 nnz); coarsest: smooth-only (4 nnz)
    for nnz_l in levels[1:]:
        f_mg += it * (4.0 + 2.0 + 4.0) * nnz_l
    if levels:
        f_mg += it * 4.0 * levels[0]
    total = f_ddot + f_waxpby + f_spmv + f_mg
    return {"ddot": f_ddot, "waxpby": f_waxpby, "spmv": f_spmv, "mg": f_mg, "total": total}


def stencil27_nnz(shape: Sequence[int]) -> int:
    """Entries of the 27-point operator on a box with zero Dirichlet
    truncation: each axis of n points has 3n - 2 in-range (point, leg)
    pairs."""
    out = 1
    for n in shape:
        out *= 3 * int(n) - 2
    return out
