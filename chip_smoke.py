#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``partitionedarrays_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each:

1. toolchain: torch, CUDA, nvcc, triton, and the card's name and power limit;
2. build of the hand-written CUDA kernels from ``partitionedarrays_tpu_torch/
   csrc`` (nvcc, sm_90a), with its time;
3. each kernel (K1 dia_spmv, K4 ax_core, K3 gs_sweeps) against its plain
   PyTorch version on the card, at the shapes of the 128^3 fine level, in
   float32 and float64: largest difference, tolerance, and the time of each
   (CUDA events);
4. the HPCG benchmark through the port on one part, 4 MG levels, 50 CG
   iterations: at 128^3 in float32 and float64, and at 64^3 in float64;
   each also checks the standard-order operator (K1) against the
   de-interleaved one (K4) and runs the generic CG, which applies A through
   K1.  The relative residuals are held to the limits of ``HPCG_RUNS``;
5. the kernels' launch counts over phase 4, each required > 0;
6. the whole port on the card against the whole port on the CPU (plain
   versions) at 32^3, 3 levels, float64: residual histories to rtol 1e-10.

Then the card's name and power limit, a JSON line of per-kernel results,
and last a JSON line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that last line; so does a machine without a CUDA device,
and a directory that does not hold the port.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time

LOCAL = (128, 128, 128)
LEVELS = 4
ITERATIONS = 50
# (local shape, dtype, limit on the final relative residual).  At 128^3,
# 4 levels and 50 iterations the solve is limited by the MG-CG convergence
# rate, not by precision: the JAX reference reaches 7.45e-7 in float32 and
# the port 7.44e-7 in float64, so both are held to 2e-6 (margin for another
# summation order).  At 64^3, the configuration of the reference's
# official-precision run (bench.py:464-481, relres 7.5e-10 in df64 with a
# float32 preconditioner), float64 is held to 1e-8.
HPCG_RUNS = (
    (LOCAL, "float32", 2e-6),
    (LOCAL, "float64", 2e-6),
    ((64, 64, 64), "float64", 1e-8),
)
CROSS_SHAPE = (32, 32, 32)
CROSS_LEVELS = 3
CROSS_ITERATIONS = 10
CROSS_RTOL = 1e-10
# kernel against plain version, relative to the largest plain entry: only
# FMA contraction and the order of the sums differ
KERNEL_RTOL = {"float32": 1e-5, "float64": 1e-12}
KERNELS = {
    "dia_spmv": (
        "partitionedarrays_tpu_torch/csrc/dia_spmv.cu",
        "partitionedarrays_tpu/ops/spmv_pallas.py:148",
    ),
    "ax_core": (
        "partitionedarrays_tpu_torch/csrc/gs_dia.cu",
        "partitionedarrays_tpu/ops/gs_pallas.py:189",
    ),
    "gs_sweeps": (
        "partitionedarrays_tpu_torch/csrc/gs_dia.cu",
        "partitionedarrays_tpu/ops/gs_pallas.py:244",
    ),
}


def emit(phase: str, payload) -> None:
    print(f"[{phase}] {json.dumps(payload)}", flush=True)


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (proc.stdout + proc.stderr).strip()


def card_line() -> str:
    return run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    ).splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_toolchain():
    import torch

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    try:
        import triton  # noqa: F401

        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    nvcc_v = run([nvcc, "--version"]).splitlines()
    emit("1 toolchain", {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc_v[-1] if nvcc_v else None,
        "triton": triton_v,
        "card": card_line(),
    })


def phase_build():
    from partitionedarrays_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    regs = []
    name = None
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs.append(f"{name}:{m.group(1)}")
    emit("2 build", {"seconds": round(seconds, 3), "library": path.name, "registers": regs})


def phase_kernels(device):
    """Each kernel against its plain version at the 128^3 fine-level shapes."""
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
    from partitionedarrays_tpu_torch.ops.dia import dia_spmv_plain
    from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv
    from partitionedarrays_tpu_torch.ops.gs_dia_kernels import (
        ax_core, ax_core_plain, gs_sweeps, gs_sweeps_plain,
    )
    from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

    results = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        A, b = build_hpcg_problem(LOCAL, (1, 1, 1), SerialBackend(1), dtype=dtype, device=device)
        gs = GaussSeidel(A)
        col = gs.colored
        oo = A.device().oo
        g = torch.Generator().manual_seed(1234)
        x_std = torch.randn(oo.vals.shape[0], oo.n_cols_pad, generator=g, dtype=dtype).to(device)
        x_core = torch.randn(1, col.m, col.Lq, generator=g, dtype=dtype).to(device)
        bd = gs.make_bd(b)
        order = gs._order_seq()
        cases = {
            "dia_spmv": (
                lambda: dia_spmv(oo.offsets, oo.vals, x_std),
                lambda: dia_spmv_plain(oo.offsets, oo.vals, x_std),
            ),
            "ax_core": (
                lambda: ax_core(col.vals_d, x_core, col.taps),
                lambda: ax_core_plain(col.vals_d, x_core, col.taps),
            ),
            "gs_sweeps": (
                lambda: gs_sweeps(col.vals_d, bd, col.invd_d, x_core, col.taps, order),
                lambda: gs_sweeps_plain(col.vals_d, bd, col.invd_d, x_core, col.taps, order),
            ),
        }
        for kname, (kernel, plain) in cases.items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            max_abs = (got - want).abs().max().item()
            scale = want.abs().max().item()
            tol = KERNEL_RTOL[name] * scale
            if not (max_abs <= tol):
                raise AssertionError(f"{kname} {name}: max |kernel - plain| {max_abs} > {tol}")
            results.append({
                "kernel": kname, "dtype": name, "max_abs_err": max_abs,
                "max_rel_err": max_abs / scale, "tol_rel": KERNEL_RTOL[name],
                "ms": time_ms(kernel, 20), "plain_ms": time_ms(plain, 5),
            })
        del A, b, gs, col, oo, x_std, x_core, bd, cases
        torch.cuda.empty_cache()
    emit("3 kernels", results)
    return results


def phase_hpcg(device):
    """The benchmark through the port, plus the standard-order operator (K1)
    against the de-interleaved one (K4) and in the generic CG."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg
    from partitionedarrays_tpu_torch.models.hpcg.driver import hpcg_benchmark
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
    from partitionedarrays_tpu_torch.psparse import spmv
    from partitionedarrays_tpu_torch.pvector import PVector

    out, failures = {}, []
    for shape, dtype, limit in HPCG_RUNS:
        name = np.dtype(dtype).name
        key = f"{name}@{shape[0]}^3"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mg = HPCGMGPreconditioner(
            shape, (1, 1, 1), SerialBackend(1), n_levels=LEVELS, dtype=dtype, device=device
        )
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        report = hpcg_benchmark(
            None, local_shape=shape, parts_per_dir=(1, 1, 1), n_levels=LEVELS,
            iterations=ITERATIONS, ref_sets=1, timed_sets=3, dtype=dtype,
            mg=mg, setup_time=setup, device=device,
        )
        s = report.summary()
        # K1: the operator in standard order against the de-interleaved one
        A, gs = mg.A, mg.gss[-1]
        lay = A.col_layout()
        g = torch.Generator().manual_seed(99)
        x = torch.zeros(1, lay.n_own_pad, dtype=A.dtype)
        x[0, : lay.n_own[0]] = torch.randn(int(lay.n_own[0]), generator=g, dtype=A.dtype)
        x = x.to(device)
        y_std = spmv(A, PVector(x, x.new_zeros(1, lay.n_ghost_pad), lay, A.backend)).own
        y_core = gs.flat_interleave(gs.flat_ax(gs.flat_deinterleave(x)))
        op_err = (y_std - y_core).abs().max().item() / y_std.abs().max().item()
        # the generic CG: standard-order vectors, A-apply through K1
        _, norms = hpcg_cg(A, mg.b, M=mg, iterations=ITERATIONS)
        generic_relres = (norms[-1] / norms[0]).item()
        gf = report.gflops()  # unrounded, unlike the summary
        out[key] = {
            "raw_gflops": gf["raw"],
            "rated_gflops": gf["rated"],
            "final_relres": s["final_relres"],
            "relres_limit": limit,
            "generic_cg_relres": generic_relres,
            "validation_passed": s["validation_passed"],
            "chain_consistent": s["chain_consistent"],
            "seconds_per_set": report.time_solve / report.n_sets,
            "setup_s": setup,
            "operator_rel_err": op_err,
            "nrow": s["nrow"],
            "nnz": s["nnz"],
        }
        if not op_err <= KERNEL_RTOL[name]:
            failures.append(f"{key}: standard vs de-interleaved operator differ by {op_err}")
        if not (s["final_relres"] <= limit and generic_relres <= limit):
            failures.append(f"{key}: relres {s['final_relres']} / {generic_relres} > {limit}")
        if not s["validation_passed"]:
            failures.append(f"{key}: HPCG validation failed")
        del mg, report, A, gs, x, y_std, y_core, norms
        torch.cuda.empty_cache()
    emit("4 hpcg", out)
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def phase_cross(device):
    """The whole port on the card against the whole port on the CPU."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg, hpcg_cg_flat
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner

    hist = {}
    for dev in (device, torch.device("cpu")):
        mg = HPCGMGPreconditioner(
            CROSS_SHAPE, (1, 1, 1), SerialBackend(1), n_levels=CROSS_LEVELS,
            dtype=np.float64, device=dev,
        )
        _, flat = hpcg_cg_flat(mg, mg.b, iterations=CROSS_ITERATIONS)
        _, generic = hpcg_cg(mg.A, mg.b, M=mg, iterations=CROSS_ITERATIONS)
        hist[dev.type] = (flat.cpu().numpy(), generic.cpu().numpy())
    errs = {}
    for i, kind in enumerate(("flat", "generic")):
        a, b = hist["cuda"][i], hist["cpu"][i]
        errs[kind] = float(np.max(np.abs(a - b) / np.abs(b)))
        if not errs[kind] <= CROSS_RTOL:
            raise AssertionError(f"{kind} CG: cuda vs cpu histories differ by {errs[kind]}")
    emit("6 cuda-vs-cpu", {
        "shape": list(CROSS_SHAPE), "levels": CROSS_LEVELS, "iterations": CROSS_ITERATIONS,
        "max_rel_diff": errs, "rtol": CROSS_RTOL,
        "final_relres": float(hist["cpu"][0][-1] / hist["cpu"][0][0]),
    })


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv
        from partitionedarrays_tpu_torch.ops.gs_dia_kernels import ax_core, gs_sweeps
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable from here: {exc}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    phase_toolchain()
    phase_build()
    kernel_results = phase_kernels(device)

    counters = {"dia_spmv": dia_spmv, "ax_core": ax_core, "gs_sweeps": gs_sweeps}
    for fn in counters.values():
        fn.launches = 0
    phase_hpcg(device)
    launches = {k: fn.launches for k, fn in counters.items()}
    emit("5 launches", launches)
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    phase_cross(device)

    rows = []
    for kname, (source, replaces) in KERNELS.items():
        r = next(r for r in kernel_results if r["kernel"] == kname and r["dtype"] == "float32")
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
