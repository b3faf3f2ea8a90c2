"""HPCG benchmark driver: the official three-phase protocol.

Counterpart of ``partitionedarrays_tpu/models/hpcg/driver.py``
(``hpcg_benchmark`` :26-315): phase 1 runs reference CG sets that fix the
tolerance, phase 2 validates that the optimized CG reaches it, phase 3
times whole sets; then the rating report.

Timing: the reference's slope/min protocol and its scale-chained window
existed for a remote TPU and for XLA, which could merge repeated sets.  In
eager PyTorch each set is enqueued as it runs, so the timed sets are timed
directly: on a CUDA device with events around all of them after a
``torch.cuda.synchronize()``, on the CPU with the host clock.  The timed
sets' residual histories are compared with the validation set's
(``chain_consistent``).

Each set runs the CG that the reference's dispatch picks (``driver.py:
119-144``, see ``cg_route``): the flat CG without ghost columns (one
part), the ghosted flat CG with them, the generic standard-order CG for a
one-level ghosted preconditioner, and with ``precision="df64"`` the
official-precision df64 CG (``driver.py:60-136``) with a float32 MG.
``precond_dtype`` stores the MG smoothers' values narrower on every route
(the df64 route's float32 MG takes bfloat16, as the reference's does).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...backends import SerialBackend
from ...config import numpy_dtype
from ...ops.stencil import stencil_psparse, stencil_rhs_counts
from ...psparse import device_df64
from ...pvector import pvector_df64
from .cg import hpcg_cg, hpcg_cg_df64, hpcg_cg_flat, hpcg_cg_flat_g
from .mg import HPCGMGPreconditioner
from .opt3d import compute_optimal_shape_xyz
from .problem import STENCIL_27PT
from .report import HPCGReport


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_sets(one_set, n_sets: int, device: torch.device):
    """Run ``n_sets`` sets back to back; return (seconds, [norms, ...])."""
    _sync(device)
    norms: List[torch.Tensor] = []
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_sets):
            norms.append(one_set()[1])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, norms
    t0 = time.perf_counter()
    for _ in range(n_sets):
        norms.append(one_set()[1])
    return time.perf_counter() - t0, norms


def cg_route(mg: HPCGMGPreconditioner, precision: Optional[str] = None) -> str:
    """The CG a set runs: "df64" (the df64 CG, for ``precision="df64"``),
    "flat" (no ghost exchange on the finest level), "flat_g" (ghosted flat
    pipeline) or "generic" (standard order)."""
    if precision == "df64":
        return "df64"
    if mg.flat_viable():
        return "flat"
    if mg.flat_viable_ghosted():
        return "flat_g"
    return "generic"


def df64_problem(local_shape, parts_per_dir, backend, device):
    """The df64 fine problem: the exact float64 27-point operator in closed
    form with its (hi, lo) pair frozen (setup work), and the rhs
    ``b = 26 - counts`` split into a pair.  The reference builds float64
    host blocks because its TPU has no float64 (``driver.py:93-117``); the
    card has, so the split runs on the device."""
    nx, ny, nz = (int(v) for v in local_shape)
    px, py, pz = (int(v) for v in parts_per_dir)
    gshape = (px * nx, py * ny, pz * nz)
    A = stencil_psparse(
        (px, py, pz), gshape, STENCIL_27PT, backend, dtype=np.float64, device=device
    )
    device_df64(A)
    offdiag = [d for d, _ in STENCIL_27PT if d != (0, 0, 0)]
    counts = stencil_rhs_counts((px, py, pz), gshape, offdiag)
    b = pvector_df64([26.0 - c for c in counts], A.row_prange, backend, device=device)
    return A, b


def hpcg_benchmark(
    backend,
    local_shape: Sequence[int] = (32, 32, 32),
    parts_per_dir: Optional[Sequence[int]] = None,
    n_levels: int = 4,
    iterations: int = 50,
    ref_sets: int = 2,
    timed_sets: int = 3,
    total_runtime: Optional[float] = None,
    dtype=np.float32,
    precond_dtype=None,
    verbose: bool = False,
    mg: Optional[HPCGMGPreconditioner] = None,
    setup_time: Optional[float] = None,
    precision: Optional[str] = None,
    device="cuda",
) -> HPCGReport:
    """Run the benchmark on ``device`` (the card unless the caller asks for
    the CPU) and return its report.

    ``setup_time``: seconds of preconditioner setup to account when a
    pre-built ``mg`` is passed (otherwise it is measured here).
    ``total_runtime``: run timed sets for at least this many seconds.
    ``precision="df64"``: the official-precision configuration; the fine
    operator, the CG vectors, updates and dots run in df64 (~49 bits), the
    MG preconditioner in float32, and ``dtype`` is ignored.  The fine
    problem lives on the device of ``mg``.  ``precond_dtype``: the storage
    of the MG smoothers' values (``HPCGMGPreconditioner``: bfloat16, or
    float32 under float64 vectors); a passed ``mg`` keeps its own, which
    the report gives."""
    if precision not in (None, "df64"):
        raise ValueError(f"unknown precision {precision!r}")
    df64_mode = precision == "df64"
    if df64_mode:
        dtype = np.float32  # the preconditioner's dtype
    dtype = numpy_dtype(dtype)
    if backend is None and mg is None:
        backend = SerialBackend(
            int(np.prod(parts_per_dir)) if parts_per_dir is not None else 1
        )
    if parts_per_dir is None:
        parts_per_dir = compute_optimal_shape_xyz(backend.n_parts)
    t0 = time.perf_counter()
    if mg is None:
        mg = HPCGMGPreconditioner(
            local_shape, parts_per_dir, backend, n_levels=n_levels,
            dtype=dtype, precond_dtype=precond_dtype, device=device,
        )
    A, b = mg.A, mg.b
    dev = b.own.device
    if df64_mode:
        A, b = df64_problem(local_shape, parts_per_dir, mg.backend, dev)
    _sync(dev)
    route = cg_route(mg, precision)

    def one_set():
        if route == "df64":
            (x, _), norms = hpcg_cg_df64(A, b, M=mg, iterations=iterations)
            return x, norms
        if route == "flat":
            x, norms = hpcg_cg_flat(mg, b, iterations=iterations)
        elif route == "flat_g":
            x, norms = hpcg_cg_flat_g(mg, b, iterations=iterations)
        else:
            x, norms = hpcg_cg(A, b, M=mg, iterations=iterations)
        return x.own, norms

    # a first set warms allocator and kernel library (the optimization phase)
    t_c0 = time.perf_counter()
    one_set()[1].cpu()
    time_setup = (t_c0 - t0) if setup_time is None else float(setup_time)
    time_optimization = time.perf_counter() - t_c0

    # phase 1: reference sets -> tolerance
    ref_norms = None
    for _ in range(ref_sets):
        ref_norms = one_set()[1].cpu().numpy()
    tolerance = ref_norms[-1] / ref_norms[0]
    if verbose:
        print(f"[hpcg] ref relres after {iterations} iters: {tolerance:.3e}")

    # phase 2: validation, recorded and not asserted (as the reference)
    opt_norms = one_set()[1].cpu().numpy()
    opt_rel = opt_norms / opt_norms[0]
    validation_passed = bool(opt_rel[-1] <= tolerance * (1 + 1e-6))
    if verbose and not validation_passed:
        print(
            f"[hpcg] VALIDATION FAILED: achieved {opt_rel[-1]:.3e} vs"
            f" reference tolerance {tolerance:.3e}"
        )

    # phase 3: timed sets
    n_sets = timed_sets
    time_solve, timed_norms = _timed_sets(one_set, n_sets, dev)
    window = "measured_sets"
    if total_runtime is not None:
        per_set = time_solve / n_sets
        n_sets = max(int(np.ceil(total_runtime / max(per_set, 1e-9))), timed_sets)
        time_solve, timed_norms = _timed_sets(one_set, n_sets, dev)
        window = "executed"
    chain_consistent = all(
        np.allclose(n.cpu().numpy(), opt_norms, rtol=1e-4) for n in timed_norms
    )
    if verbose and not chain_consistent:
        print("[hpcg] INVALID: a timed set's residual history diverged (rtol 1e-4)")

    return HPCGReport(
        nrow=A.shape[0],
        nnz=A.nnz(),
        nnz_per_level=list(mg.nnz_per_level()),  # coarsest first
        iterations=iterations,
        ref_iterations=iterations,
        n_sets=n_sets,
        time_solve=time_solve,
        time_setup=time_setup,
        time_optimization=time_optimization,
        extra={
            "local_shape": list(local_shape),
            "parts_per_dir": list(parts_per_dir),
            "levels": mg.n_levels,
            "final_relres": float(opt_rel[-1]),
            # df64 carries ~49 significand bits (two float32 words), not
            # IEEE float64's 53
            "dtype": "float64-df64" if df64_mode else dtype.name,
            "precision_bits": 49 if df64_mode else (53 if dtype == np.float64 else 24),
            "validation_passed": validation_passed,
            "chain_consistent": chain_consistent,
            "validation_tolerance": float(tolerance),
            "validation_achieved": float(opt_rel[-1]),
            "phase3_window": window,
            # as the reference: None unless the values are stored apart
            # from the vectors' dtype or a dtype was asked for
            "precond_values_dtype": (
                str(mg.values_dtype).replace("torch.", "")
                if precond_dtype is not None or mg.values_dtype != mg.A.dtype else None
            ),
        },
    )
