"""HPCG result rating: the official FLOP / byte / GFLOP-s model.

Copied unchanged from ``partitionedarrays_tpu/models/hpcg/report.py``
(numpy and json only): the port must not import the JAX package, whose
``__init__`` loads jax.

Capability parity: HPCG/src/report_results.jl — FLOP model (:27-40), byte
model (:43-50), GFLOP/s and GB/s summaries with setup/convergence overhead
accounting (tail).  The models use the official f64+CSR accounting
regardless of the implementation's actual storage, exactly like every HPCG
submission, so ratings are comparable.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class HPCGReport:
    nrow: int  # fine-level global rows
    nnz: int  # fine-level global nonzeros
    nnz_per_level: List[int]  # fine -> coarse
    iterations: int  # optimized CG iterations per set
    ref_iterations: int  # reference iterations per set (50)
    n_sets: int
    time_solve: float  # total optimized solve wall time (all sets)
    time_setup: float = 0.0
    time_optimization: float = 0.0
    extra: Dict = field(default_factory=dict)

    # -- FLOP model (report_results.jl:27-40) -------------------------
    def flops(self) -> Dict[str, float]:
        it = self.iterations * self.n_sets
        sets = self.n_sets
        f_ddot = (3.0 * it + sets) * 2.0 * self.nrow
        f_waxpby = (3.0 * it + sets) * 2.0 * self.nrow
        f_spmv = (it + sets) * 2.0 * self.nnz
        f_mg = 0.0
        levels = self.nnz_per_level
        # fine levels: pre-smooth (sym GS ~ 4 nnz) + residual SpMV (2 nnz)
        # + post-smooth (4 nnz); coarsest: smooth-only (4 nnz)
        for nnz_l in levels[1:]:
            f_mg += it * (4.0 + 2.0 + 4.0) * nnz_l
        if levels:
            f_mg += it * 4.0 * levels[0]
        total = f_ddot + f_waxpby + f_spmv + f_mg
        return {
            "ddot": f_ddot,
            "waxpby": f_waxpby,
            "spmv": f_spmv,
            "mg": f_mg,
            "total": total,
        }

    # -- byte model (report_results.jl:43-50), official f64+CSR terms --
    def bytes_model(self) -> Dict[str, float]:
        it = self.iterations * self.n_sets
        sets = self.n_sets
        fnbytes = 8.0  # f64 values
        fnbytes_int = 8.0  # int64 indices
        r_ddot = (3.0 * it + sets) * 2.0 * self.nrow * fnbytes
        w_ddot = (3.0 * it + sets) * 2.0 * fnbytes
        r_waxpby = (3.0 * it + sets) * 2.0 * self.nrow * fnbytes
        w_waxpby = (3.0 * it + sets) * self.nrow * fnbytes
        r_spmv = (it + sets) * (
            self.nnz * (fnbytes + fnbytes_int) + self.nrow * fnbytes
        )
        w_spmv = (it + sets) * self.nrow * fnbytes
        r_mg = 0.0
        w_mg = 0.0
        for nnz_l in self.nnz_per_level[1:]:
            r_mg += it * 10.0 * (nnz_l * (fnbytes + fnbytes_int))
            w_mg += it * 10.0 * (nnz_l / 27.0) * fnbytes
        if self.nnz_per_level:
            r_mg += it * 4.0 * self.nnz_per_level[0] * (fnbytes + fnbytes_int)
            w_mg += it * 4.0 * (self.nnz_per_level[0] / 27.0) * fnbytes
        return {
            "read": r_ddot + r_waxpby + r_spmv + r_mg,
            "write": w_ddot + w_waxpby + w_spmv + w_mg,
            "total": r_ddot + r_waxpby + r_spmv + r_mg + w_ddot + w_waxpby + w_spmv + w_mg,
        }

    # -- ratings ------------------------------------------------------
    def gflops(self) -> Dict[str, float]:
        f = self.flops()
        t = max(self.time_solve, 1e-12)
        raw = f["total"] / t / 1e9
        # official penalty: amortize setup/optimization and convergence
        # overhead (extra iterations vs the reference count)
        conv_penalty = self.ref_iterations / max(self.iterations, 1)
        oh = self.time_setup + self.time_optimization
        t_total = t + oh
        rated = f["total"] * min(conv_penalty, 1.0) / t_total / 1e9
        # the official benchmark amortizes the SAME one-time overhead over
        # a >= 1800 s run window (HPCG/src/hpcg_benchmark.jl:81-88); our
        # drivable window is shorter, which magnifies the overhead term by
        # 1800/t.  Project the rating onto the official window at the
        # measured throughput — a clearly-labeled derived figure, NOT a
        # measurement (the executed-window `rated` stays the headline).
        t_off = max(1800.0, t)
        rated_off = (
            f["total"] * min(conv_penalty, 1.0) * (t_off / t) / (t_off + oh) / 1e9
        )
        return {"raw": raw, "rated": rated, "rated_1800s_projection": rated_off}

    def gbs(self) -> float:
        return self.bytes_model()["total"] / max(self.time_solve, 1e-12) / 1e9

    def summary(self) -> Dict:
        return {
            "nrow": self.nrow,
            "nnz": self.nnz,
            "sets": self.n_sets,
            "iterations_per_set": self.iterations,
            "time_solve_s": round(self.time_solve, 4),
            "GFLOPs": {k: round(v, 3) for k, v in self.gflops().items()},
            "GBs_model": round(self.gbs(), 2),
            **self.extra,
        }

    def to_json(self) -> str:
        return json.dumps(self.summary())

    def to_txt(self) -> str:
        """Official-HPCG-style text report (parity: report_results,
        HPCG/src/report_results.jl:200-262; per-kernel wall buckets are
        replaced by the analytical model — per-op timers are meaningless
        under XLA fusion)."""
        f = self.flops()
        by = self.bytes_model()
        g = self.gflops()
        t = max(self.time_solve, 1e-12)
        dtype = self.extra.get("dtype", "unspecified")
        window = self.extra.get("phase3_window", "measured_sets")
        if dtype == "float64":
            official = " (OFFICIAL-RULES precision)"
        elif dtype == "float64-df64":
            official = (
                " (official-precision configuration: two-float df64 ~49-bit"
                " arithmetic, validated vs true f64 — TPU has no native f64;"
                " IEEE-f64 purists should read this as f64-equivalent, not"
                " bitwise IEEE)"
            )
        else:
            official = " (NOT official-rules precision: official HPCG is f64)"
        lines = [
            "HPCG-Benchmark (TPU-native partitionedarrays)",
            "",
            "Problem Summary:",
            f"Global number of rows = {self.nrow}",
            f"Global number of nonzeros = {self.nnz}",
            f"Multigrid levels = {len(self.nnz_per_level)}",
            f"Compute dtype = {dtype}{official}",
            f"Phase-3 window = {window}",
            "",
            "Iteration Summary:",
            f"CG sets = {self.n_sets}",
            f"Iterations per set = {self.iterations}",
            f"Reference iterations per set = {self.ref_iterations}",
            "",
            "Validation Summary (phase 2):",
            (
                "Optimized CG reached the reference tolerance: "
                + (
                    "PASSED"
                    if self.extra.get("validation_passed", True)
                    else "FAILED"
                )
            ),
            (
                f"Achieved relres = {self.extra.get('validation_achieved', float('nan')):.3e}"
                f" vs reference tolerance = {self.extra.get('validation_tolerance', float('nan')):.3e}"
            ),
            "",
            "Benchmark Time Summary:",
            f"Setup = {self.time_setup:.4f}",
            f"Optimization phase = {self.time_optimization:.4f}",
            f"Total = {self.time_solve:.4f}",
            "",
            "Floating Point Operations:",
            f"Raw DDOT = {f['ddot']:.4e}",
            f"Raw WAXPBY = {f['waxpby']:.4e}",
            f"Raw SpMV = {f['spmv']:.4e}",
            f"Raw MG = {f['mg']:.4e}",
            f"Total = {f['total']:.4e}",
            "",
            "GB/s Summary (analytical f64+CSR byte model):",
            f"Raw Read B/W = {by['read'] / t / 1e9:.2f}",
            f"Raw Write B/W = {by['write'] / t / 1e9:.2f}",
            f"Raw Total B/W = {by['total'] / t / 1e9:.2f}",
            "",
            "GFLOP/s Summary:",
            f"Raw Total = {g['raw']:.3f}",
            f"Total with convergence and optimization phase overhead = {g['rated']:.3f}",
            "Projection onto the official >=1800 s window (derived, not "
            f"measured) = {g['rated_1800s_projection']:.3f}",
            "",
            (
                f"HPCG result is VALID with a GFLOP/s rating of: {g['rated']:.3f}"
                if self.extra.get("validation_passed", True)
                else "HPCG result is INVALID: phase-2 validation failed"
                f" (unrated GFLOP/s would have been {g['rated']:.3f})"
            ),
            f"Results are valid but execution time (sec) is {self.time_solve:.4f}",
        ]
        return "\n".join(lines)

    def write(self, path_prefix: str) -> None:
        """Write <prefix>.txt and <prefix>.json like the reference."""
        with open(path_prefix + ".txt", "w") as fh:
            fh.write(self.to_txt() + "\n")
        with open(path_prefix + ".json", "w") as fh:
            fh.write(self.to_json() + "\n")
