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

A one-part operator has no ghost columns, so every set runs the flat CG
(``hpcg_cg_flat``), as the reference does at ``driver.py:119``.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...backends import GHOSTED_PARTS, SerialBackend
from ...config import numpy_dtype
from .cg import hpcg_cg_flat
from .mg import HPCGMGPreconditioner
from .opt3d import compute_optimal_shape_xyz
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
    device="cpu",
) -> HPCGReport:
    """Run the benchmark on ``device`` and return its report.

    ``setup_time``: seconds of preconditioner setup to account when a
    pre-built ``mg`` is passed (otherwise it is measured here).
    ``total_runtime``: run timed sets for at least this many seconds.
    ``precision="df64"`` and ``precond_dtype`` are not ported yet."""
    if precision == "df64":
        raise NotImplementedError("df64 HPCG: ROADMAP Queue 1 item 9 (slice B)")
    if precision is not None:
        raise ValueError(f"unknown precision {precision!r}")
    if precond_dtype is not None:
        raise NotImplementedError("reduced-precision preconditioner values: ROADMAP")
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
            dtype=dtype, device=device,
        )
    A, b = mg.A, mg.b
    dev = b.own.device
    _sync(dev)
    if not mg.flat_viable():
        raise NotImplementedError(GHOSTED_PARTS)

    def one_set():
        x, norms = hpcg_cg_flat(mg, b, iterations=iterations)
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
            "dtype": dtype.name,
            "precision_bits": 53 if dtype == np.float64 else 24,
            "validation_passed": validation_passed,
            "chain_consistent": chain_consistent,
            "validation_tolerance": float(tolerance),
            "validation_achieved": float(opt_rel[-1]),
            "phase3_window": window,
            "precond_values_dtype": None,
        },
    )
