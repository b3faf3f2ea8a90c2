#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``partitionedarrays_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each:

1. toolchain: torch, CUDA, nvcc, triton, and the card's name and power limit;
2. build of the hand-written CUDA kernels from ``partitionedarrays_tpu_torch/
   csrc`` (nvcc, sm_90a), with its time;
3. each kernel against its plain PyTorch version on the card, in float32
   and float64: K1 dia_spmv, K4 ax_core and K3 gs_sweeps at the shapes of
   the 128^3 one-part fine level, K5 ghost_spmv and K2 dia_spmv_strided at
   those of the (2,2,2) x 64^3 fine level; largest difference, tolerance,
   the time of each (CUDA events), its bound (the larger of its bytes over
   the card's memory rate and its operations over its float32 rate) and,
   for K1, K2, K4 and K5, the time of the same product as one
   ``torch.sparse`` CSR call (K2 and K5 also with the L2 flushed before
   each call, K5 under every warps-per-group count); then K7 dia_spmv_df
   (df64 pairs) at both fine
   shapes, held to 1e-13 of sum |A||x| per row against its plain version
   and, with it, against K1 in float64 on the same values; then K3 (one
   launch per color sequence) on every level of the one-part 128^3
   hierarchy (128^3, 64^3, 32^3, 16^3), float32 and float64, symmetric
   order from a guess and from a zero guess: m, Lq, launches per call, the
   bound (each input read once), the streaming floor (each color's values
   read once per step), the plain version's time, the device time of a
   launch of no step and of one step, and the time under every other
   lane count; then K4 (one launch over every color and part) on every
   level of the one-part 128^3 hierarchy, in float32, float64 and each
   narrow pair, on random values of the level's pattern: against its plain
   version under its plan (``ops/dia_rows.py::ax_plan``) and under every
   other lane count, its time, device time, bound and plain time, the
   ``torch.sparse`` CSR call at the fine level, the device time under
   every other lane count, and on HPCG's own values (exact in bfloat16)
   each narrow pair against the full-value kernel, bit for bit;
4. thirty paths through the port, each with its kernels' launch counts
   set to 0 just before it and read just after (a-c: the HPCG benchmark, 4
   MG levels, 50 CG iterations; d-f and j: the AMG paths, counted over
   their solves):
   a. one part: 128^3 in float32 and float64, 64^3 in float64; each also
      checks the standard-order operator (K1) against the de-interleaved
      one (K4) and runs the generic CG, which applies A through K1; one
      float32 set at 128^3 is profiled (launches and device time per
      kernel and per set);
   b. (2,2,2) parts of 64^3 (the same 128^3 global problem) in float32 and
      float64 through the ghosted flat CG; each also checks the
      standard-order ``spmv`` (exchange, K1, K5) against the core product
      (K4) plus the ghost contribution, runs the generic CG, and holds the
      standalone colored sweep (K2 per color) against the smoother's sweep
      sequence (K3) with a real ghost contribution;
   c. ``precision="df64"`` (the df64 CG through K7, the float32 MG through
      K3, K4 and K5): 64^3 and 128^3 on one part and (2,2,2) parts of 64^3;
      each profiles one set (kernel launches and device time), and the 64^3
      one also runs ``cg_df64`` with no preconditioner and with the float32
      GaussSeidel on the same operator to rtol 1e-10;
   the relative residuals are held to the limits of ``HPCG_RUNS``,
   ``GHOSTED_RUNS`` and ``DF64_RUNS``;
   d. ``amg_elasticity``: 3-D Q1 linear elasticity through the port's
      entry points (``linear_elasticity_fem`` -> ``psparse`` ->
      ``nullspace_linear_elasticity`` -> ``AMGPreconditioner`` -> ``cg`` to
      rtol 1e-8): 16^3 nodes in float32 (the reference's anchor, 9 +- 1
      iterations) and 40^3 nodes (192,000 rows) in float32 and float64;
      host seconds of assembly and setup, the hierarchy, iterations, the
      true float64 residual and the solve time (CUDA events), and at 40^3
      a profiled solve with K3's, K6's and K5's shares of its device time;
      then, on the 40^3 hierarchy's operators: K6 (one launch per sweep
      sequence) on levels 1 and 2, forward, backward and symmetric from a
      zero and a nonzero guess, and its symmetric sweep timed (CUDA events,
      device time, plain version, bound, launches of 0 and 1 wave step,
      and with x read from L2 instead of shared memory); K5 on every
      compressed-row block of the V-cycle (P_l, P_l^T, A_l), with the L2
      flushed before each call, beside its bound, the ``torch.sparse``
      CSR ``addmv`` of the same matrix and its time under every
      warps-per-group count; K1 (99 diagonals) and K3 (27 colors, 99
      diagonals, as in phase 3); and K6 on the forced tile tier of the 20^3
      elasticity block;
   e. ``amg_box`` and ``amg_box_df64``: the box-stencil SA-AMG
      (``laplacian_fdm`` -> ``psparse`` -> ``AMGPreconditioner`` with its
      box aggregation and flat cycle): the 64^3 7-point Laplacian in
      float32 and float64 under ``cg`` to rtol 1e-8 (float32 held to the
      reference's 10 +- 1 iterations), and ``cg_df64`` on the float64 48^3
      Laplacian preconditioned by the AMG of its ``astype`` float32 copy
      (13 +- 1 iterations, true residual <= 1e-9); host seconds of
      assembly and setup, the hierarchy, cold and warm solve seconds, the
      launches of a solve and of a V-cycle, a profiled solve with K3's,
      K4's and K1's shares; then K3 and K4 against their plain versions on
      every colored level of the 64^3 hierarchies (float32, float64) and
      of the 48^3 float32 one (time, bound, launches per V-cycle), K1 on
      the 7-point 64^3 operator in both dtypes and K7 on the (hi, lo) split
      of the 48^3 one (as in phase 3b);
   f. ``amg_elasticity_parts`` and ``amg_box_parts``: the two AMG paths on
      (2,2,2) parts of the serial backend (P = 8 on the card), uncut: the
      40^3-node elasticity from disassembled triplets (192,000 rows) and the
      64^3 ``laplacian_fdm`` (262,144 rows, the ghosted flat cycle), float32
      and float64, iterations held to the JAX package's own on the CPU
      (``AMG_PARTS_RUNS``, ``BOX_PARTS_RUNS``); host seconds of assembly
      and setup, the hierarchy (rows, nnz, smoother tier), the true float64
      residual, cold and warm solve seconds, the launches of a solve and of
      a V-cycle, the exchanges of a V-cycle, a profiled warm float32 solve;
      then K1 on both fine own-own blocks, K3 (and on the box levels K4) on
      every colored level, K5 on every compressed-row block (the own-ghost
      blocks and their transposes included), K6 with P = 8 on every tile
      level, each against its plain version;
   g. the reuse tier, through the user code of ``examples/implicit_reuse.py``
      (the same code runs the JAX package): ``reaction_diffusion_parts``
      (backward Euler over Newton over ``psparse_refill`` and
      ``AMGPreconditioner.update`` over the AMG-CG, 64^3 on (2,2,2) parts,
      float64; Newton and CG iterations held to the JAX package's),
      ``newton_reuse`` (bench.py:547-580: the 64^3 float32 Laplacian
      refilled with 1.1 V and updated, 10 +- 1 CG iterations; and
      ``DeviceRefill`` against the host refill, bit for bit) and
      ``elasticity_update`` (32^3 float32 elasticity refilled with a
      mass-like shift, within one CG iteration of a fresh setup): host
      seconds of refill and update, CUDA-event seconds of each solve, the
      true residuals, a V-cycle's launches and device time; every
      refreshed operand (smoother arrays, D^-1, A, P, P^T, the coarse
      factors) against a fresh build; then K1, K3, K4, K5 and K6 against
      their plain versions on the refreshed operands (``REFRESH_RTOL``);
      and ``elasticity_update`` at 24^3 float32 (``RESETUP_NODES``), whose
      refilled products are real where the build's cancelled exactly:
      ``update`` sets up anew (``n_resetups`` >= 1), within one CG
      iteration of a fresh setup; K5 and K6 on that hierarchy;
   h. the Schwarz tier (``AdditiveSchwarz``, its ILU(0) factors applied as
      two K6 launches of one direction each on the level schedule):
      ``schwarz_ilu0`` (bench.py:580-617: the 27-point operator at 32^3 on
      one part, CG to 1e-6, float32 and float64, 20 iterations, the JAX
      package's count on the CPU), ``schwarz_ilu0_parts`` (64^3 on (2,2,2)
      parts, K6 with P = 8; the JAX package's count) and
      ``amg_schwarz_elasticity`` (phase 4d's elasticity with Schwarz level
      smoothers: 16^3 float32 held to the JAX package's count, 40^3 float32
      and float64 to phase 4d's residual limits, both Schwarz tiers): the
      factors' W and B, setup seconds, iterations, true residual, solve
      seconds, an apply's time and launches; then K6's triangular solves
      against their plain version (``TRI_RTOL``) and, in float64, against
      scipy's ``spsolve_triangular``, timed beside their bound, their
      latency floor (W wave steps) and PyTorch's sparse triangular solve
      where the card's PyTorch has one; K1 and K5 on those paths' operands;
   i. ``precond_values``: the HPCG benchmark with ``precond_dtype``, the
      MG smoothers' values stored narrower than the vectors
      (``PRECOND_RUNS``): 128^3 on one part in float32 with bfloat16 values
      (raw and rated GF/s, s/set, a profiled set beside a float32-valued
      one, the history within rtol 1e-4 of the float32-valued run's),
      (2,2,2) parts of 64^3 on ``flat_g`` (with the standalone sweep, K2
      per color, against K3 on the narrow values), df64 at 64^3 with the
      bfloat16-valued float32 MG, float64 at 64^3 with float32 and with
      bfloat16 values; then K2, K3 and K4 for every narrow pair (bfloat16
      values under float32 and float64 vectors, float32 under float64) on
      random values of the 27-point pattern against their plain versions
      (``KERNEL_RTOL`` of the vector dtype), timed at the 128^3 level (K3,
      K4) and at one color of the (2,2,2) x 64^3 level with the L2 flushed
      (K2) beside the full-value kernels on the same operators, and on
      HPCG's own values (exact in bfloat16) against the full-value kernels
      (``NARROW_HPCG_RTOL``);
   j. the partition, vector and matrix utilities (``UNEQUAL_RUNS``):
      ``amg_unequal_parts`` (``plaplacian_fdm`` at 65^3 on (2,2,2) parts of
      unequal box shape, 274,625 rows, the own-own block DIA on the union
      of the parts' 13 offsets; phase 4f's box AMG-CG, where the box
      aggregation declines, so the generic aggregation) and
      ``repartitioned`` (``repartition_system`` onto eight contiguous
      blocks of ids, held equal to the original; the AMG-CG again; the
      solution moved back by ``repartition`` and held to the first
      path's), float32 and float64, iterations held to the JAX package's
      own on the CPU, with phase 4f's record for each; then K1 on both
      fine own-own blocks, K3 on every colored level, K5 on every
      compressed-row block and K6 with P = 8 on every tile level, each
      against its plain version;
   k. float16 preconditioner values and the remaining layers:
      ``hpcg_float16`` (``F16_RUNS``: ``hpcg_benchmark(precond_dtype=
      "float16")`` at 128^3 float32 and 64^3 float64 on one part, the
      standalone sweep (K2 per color) against K3 on the fine level's
      float16 values in the same window; profiled sets of the float16-,
      bfloat16- and full-valued MGs, whose histories must be equal, HPCG's
      values being exact in both), then K2, K3 and K4 with random float16
      values (``F16_PAIRS``) against their plain versions beside the
      bfloat16 instance on the same operator, and on HPCG's values against
      the full-value kernels; ``block_cg`` (``BLOCK_RUNS``: ``b_cg`` to
      rtol 1e-8 on the coupled two-field system [[A, C], [C, S]], A =
      ``plaplacian_fdm((64,)*3, (2,2,2))``, S = A + 0.5 I, C = 0.1 I, in
      float32 and float64: iterations held to the JAX package's on the
      CPU, the true relres of a float64 product, cold and warm seconds by
      the port's ``PTimer`` and by CUDA events, a profiled warm solve),
      then K1 on the three DIA blocks and K5 on the ghost blocks; and the
      utilities on the card, one line each (``PTimer`` fencing a region the
      card runs after the host queued it, a checkpoint round trip,
      ``gather``/``scatter``/``multicast`` of CUDA tensors);
   l. ``newton_krylov`` (``NK_RUNS``): the reference's matrix-free Newton
      test problem on ``plaplacian_fdm((64,)*3, (2,2,2))`` in float64, the
      exact (forward AD through K1 and K5) and the finite-difference
      products, without and with a symmetric Gauss-Seidel preconditioner:
      outer iterations and |F| against the JAX package's on the CPU, max |x
      - x*|, seconds, a profiled run; then the tangent products of K1 and
      K5 against the plain products of the tangent;
   m. the multi-process tier (``MP_RUNS``): groups of ranks, each a process
      of ``tests/torch_multiprocess_driver.py`` on the card, over gloo on
      localhost (host-staged messages; the ranks share the card, so these
      are not multi-GPU figures): the reference driver's main mode at
      (2,2,2) x 64^3 in float64 on 2 and on 4 ranks, ``hpcg_benchmark_mpi``,
      the per-process FEM construction, the per-process AMG setup with
      AMG-CG and ``update``, and the agreed-dims wave GS; every rank held to
      the single-process run on the card, each mode's launches summed over
      the ranks; ``hpcg_benchmark_mpi(precision="df64")``, every set's
      residual history bit-equal to the single-process run's; and the folds
      over all parts (``pdot_df64``, ``collect_df64``,
      ``find_local_indices``, ``sparse_diag_matrix``, ``renumber_pvector``,
      the COO ``pvector``, ``cg_df64``, a sorted-tier GS sweep) bit-equal
      to the serial backend's;
   n. (run after d, on its 40^3 operators) the sorted-by-color Gauss-Seidel
      tier (``SORTED_NODES``), forced by ``GaussSeidel(..., _sorted=True)``
      in float32 and float64: the colors and K5 launches of a symmetric
      sweep of the fine level, the sweep against the plain tier-2 sweep
      (``ell_spmv``) on the card, its time and device time, K5 on every
      color slice against its plain version (flushed time, bound, the
      ``torch.sparse`` call); and phase 4d's hierarchy with its tile-tier
      levels on the sorted tier under the AMG-CG to 1e-8: iterations, true
      residual, cold and warm seconds beside phase 4d's run;
5. the launch counts of each path, each kernel of a path required > 0, and
   the wall seconds of each phase;
6. the whole port on the card against the whole port on the CPU (plain
   versions), float64, residual histories to rtol 1e-10: 32^3 on one part
   and (2,2,2) parts of 8^3, 3 levels, flat and generic CG; the df64
   CG at (2,2,2) parts of 8^3 (``DF64_CROSS_RTOL``); and the box AMG-CG at
   16^3 on one part and on (2,2,2) parts of 8^3 (the ghosted flat cycle).

Then the card's name and power limit, a JSON line of per-kernel results,
and last a JSON line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that last line; so does a machine without a CUDA device,
and a directory that does not hold the port.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

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
# (2,2,2) parts of 64^3: the 128^3 global problem, the largest per-part
# box at which the reference's own-ghost block still takes its slot kernel
# (K5).  The limits are sanity bounds: the reference has no measurement of
# this partition on a chip.
GHOST_PARTS = (2, 2, 2)
GHOST_LOCAL = (64, 64, 64)
GHOSTED_RUNS = (
    (GHOST_LOCAL, "float32", 1e-5),
    (GHOST_LOCAL, "float64", 1e-5),
)
# the df64 path: (local shape, parts per direction, limit on the final
# relative residual).  64^3 on one part is the reference's official-precision
# configuration (bench.py:464-481; it reported 7.51e-10 there); at 128^3 the
# solve is convergence-limited as in float32 and float64 (2e-6); (2,2,2)
# parts of 64^3 keep the ghosted runs' sanity bound.
DF64_RUNS = (
    ((64, 64, 64), (1, 1, 1), 1e-8),
    (LOCAL, (1, 1, 1), 2e-6),
    (GHOST_LOCAL, GHOST_PARTS, 1e-5),
)
# cg_df64 beside the df64 run at the reference's official-precision
# configuration (64^3 on one part; at 128^3 and on (2,2,2) parts too it
# took 16 s more of the script's time limit and added no check): its
# stopping rtol, and the limit on the true float64 residual |b - A x| / |b|
# of its solution
DF64_CG_SHAPE = ((64, 64, 64), (1, 1, 1))
DF64_CG_RTOL = 1e-10
DF64_CG_TRUE_RELRES = 1e-9
DF64_CG_MAXITER = 3000
# K7 against its plain version and against K1 in float64, relative to
# sum_j |A_ij| |x_j| per row (tests/test_df64.py:89)
DF64_KERNEL_TOL = 1e-13
# df64 CG, card against CPU: with no preconditioner both round every
# operation alike (rtol 1e-6); with the float32 MG, K3's contracted
# float32 sums move the histories (rtol 1e-4 over 10 iterations)
DF64_CROSS_RTOL = {"identity": 1e-6, "mg": 1e-4}
# the card's published peaks (H100 SXM, 700 W): memory rate and float32
# rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12  # float64 outside the tensor cores (data sheet)
# (local shape, parts per direction) of the cuda-vs-cpu comparison
CROSS_CASES = (((32, 32, 32), (1, 1, 1)), ((8, 8, 8), GHOST_PARTS))
CROSS_LEVELS = 3
CROSS_ITERATIONS = 10
CROSS_RTOL = 1e-10
# the same float32 set at 128^3 when K3 ran one launch per color step
# (PERF.md section 5): device events and device ms, beside the profile of
# phase 4a
PER_COLOR_K3_SET = {"device_events": 9684, "device_ms": 100.6}
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
    "dia_spmv_strided": (
        "partitionedarrays_tpu_torch/csrc/dia_spmv.cu",
        "partitionedarrays_tpu/ops/spmv_pallas.py:276",
    ),
    "ghost_spmv": (
        "partitionedarrays_tpu_torch/csrc/ghost_spmv.cu",
        "partitionedarrays_tpu/ops/slot_spmv.py:363",
    ),
    "dia_spmv_df": (
        "partitionedarrays_tpu_torch/csrc/dia_spmv_df.cu",
        "partitionedarrays_tpu/ops/spmv_pallas.py:240",
    ),
    "tile_gs_sweeps": (
        "partitionedarrays_tpu_torch/csrc/tile_gs.cu",
        "partitionedarrays_tpu/solvers/gs_slot.py:112",
    ),
}
# the kernels each path of phase 4 must launch
PATH_KERNELS = {
    "one_part": ("dia_spmv", "ax_core", "gs_sweeps"),
    "ghosted": ("dia_spmv", "ax_core", "gs_sweeps", "dia_spmv_strided", "ghost_spmv"),
    "df64": ("dia_spmv_df", "ax_core", "gs_sweeps", "ghost_spmv"),
    "amg_elasticity": ("dia_spmv", "gs_sweeps", "ghost_spmv", "tile_gs_sweeps"),
    "amg_box": ("dia_spmv", "ax_core", "gs_sweeps"),
    "amg_box_df64": ("dia_spmv_df", "ax_core", "gs_sweeps"),
    "amg_elasticity_parts": ("dia_spmv", "gs_sweeps", "ghost_spmv", "tile_gs_sweeps"),
    "amg_box_parts": ("dia_spmv", "ax_core", "gs_sweeps", "ghost_spmv"),
    "reaction_diffusion_parts": ("dia_spmv", "ax_core", "gs_sweeps", "ghost_spmv"),
    "newton_reuse": ("dia_spmv", "ax_core", "gs_sweeps"),
    "elasticity_update": ("dia_spmv", "gs_sweeps", "ghost_spmv", "tile_gs_sweeps"),
    "schwarz_ilu0": ("dia_spmv", "tile_gs_sweeps"),
    "schwarz_ilu0_parts": ("dia_spmv", "ghost_spmv", "tile_gs_sweeps"),
    "amg_schwarz_elasticity": ("dia_spmv", "ghost_spmv", "tile_gs_sweeps"),
    "precond_values": ("ax_core", "gs_sweeps", "dia_spmv_strided", "ghost_spmv", "dia_spmv_df"),
    "amg_unequal_parts": ("dia_spmv", "gs_sweeps", "ghost_spmv", "tile_gs_sweeps"),
    "repartitioned": ("dia_spmv", "gs_sweeps", "ghost_spmv", "tile_gs_sweeps"),
    "hpcg_float16": ("ax_core", "gs_sweeps", "dia_spmv_strided"),
    "block_cg": ("dia_spmv", "ghost_spmv"),
    "newton_krylov": ("dia_spmv", "ghost_spmv", "gs_sweeps"),
    "mp_cg_2": ("dia_spmv", "ghost_spmv", "gs_sweeps"),
    "mp_cg_4": ("dia_spmv", "ghost_spmv", "gs_sweeps"),
    "mp_fem_2": ("dia_spmv", "ghost_spmv"),
    "mp_gsslot_2": ("tile_gs_sweeps",),
    "mp_amg_2": ("dia_spmv", "gs_sweeps", "ghost_spmv"),
    "mp_hpcg_2": ("ax_core", "gs_sweeps", "ghost_spmv"),
    "mp_hpcg_df64_2": ("dia_spmv_df", "ax_core", "gs_sweeps", "ghost_spmv"),
    "mp_folds_2": ("dia_spmv_df", "ghost_spmv"),
    "elasticity_update_24": ("dia_spmv", "gs_sweeps", "ghost_spmv", "tile_gs_sweeps"),
    "sorted_gs": ("dia_spmv", "gs_sweeps", "ghost_spmv"),
}
# phase 4n, the sorted-by-color Gauss-Seidel tier (the reference's tier 2),
# forced through GaussSeidel(..., _sorted=True) on phase 4d's 40^3 elasticity
# operators (192,000 rows; no new build), float32 and float64: a symmetric
# sweep of the fine level (K5 on every color's rows) against the plain tier-2
# sweep (ell_spmv) on the card, and phase 4d's hierarchy with its tile-tier
# level smoothers (levels 1 and 2) replaced by the sorted tier, under the
# AMG-CG to rtol 1e-8 held to phase 4d's residual limits
SORTED_NODES = (40, 40, 40)
SHARED_AMG = {}  # phase 4d's 40^3 hierarchies, rhs and records, for phase 4n
# the elasticity SA-AMG path: the reference's own workload (bench.py:371-430,
# AMGParams(coarse_size=400, block_size=3, max_levels=4), CG to rtol 1e-8),
# (nodes per direction, dtype, allowed CG iterations or None, limit on the
# true float64 residual |b - A x| / |b|).  16^3 is the reference's anchor
# (BENCH_r05.json: 9 iterations, 12,288 rows); 40^3 (192,000 rows) is the
# size of its elasticity operator (bench.py:226-228)
AMG_PARAMS = dict(coarse_size=400, block_size=3, max_levels=4)
AMG_RTOL = 1e-8
AMG_MAXITER = 200
# phase 4d's one-part elasticity matrices that phase 4h's
# amg_schwarz_elasticity runs take again (the same nodes and dtype), with
# their assembly seconds: built once, as the 40^3 build is ~16 s of host work
SHARED_ELASTICITY = {}
AMG_RUNS = (
    ((16, 16, 16), "float32", (8, 10), 1e-5),
    ((40, 40, 40), "float32", None, 1e-5),
    ((40, 40, 40), "float64", None, 2e-8),
)
# the run whose hierarchy holds K6 (levels 1 and 2) and K1 (99 diagonals)
# against their plain versions
AMG_KERNEL_NODES = (40, 40, 40)
# K6 on the forced tile tier of the 20^3-node elasticity block (24,000
# rows; the reference's bench.py:283-349 shape)
FORCED_TILE_NODES = (20, 20, 20)
# the box-stencil SA-AMG path: the reference's bench.py:143-202, the 64^3
# 7-point laplacian_fdm on one part, AMGParams(coarse_size=200), CG to rtol
# 1e-8 (maxiter 100) on ones in the first 10 own entries; its anchor
# (BENCH_r05.json amg64_cg_iters_1e8) is 10 iterations.  (dtype, allowed
# iterations or None, limit on the true float64 residual |b - A x| / |b|)
BOX_NODES = (64, 64, 64)
BOX_PARAMS = dict(coarse_size=200)
BOX_RTOL = 1e-8
BOX_MAXITER = 100
BOX_RUNS = (("float32", (9, 11), 1e-5), ("float64", None, 2e-8))
# bench.py:491-544: cg_df64 on the float64 48^3 laplacian_fdm, b = A x with x
# from default_rng(7), preconditioned by the AMG of the operator's float32
# copy, to rtol 1e-10 (maxiter 300); anchor 13 iterations, relres 3.0956e-11
BOX_DF64_NODES = (48, 48, 48)
BOX_DF64_ITERS = (12, 14)
BOX_DF64_RTOL = 1e-10
BOX_DF64_MAXITER = 300
BOX_DF64_TRUE_RELRES = 1e-9
# the box AMG-CG on the card against the CPU (float64, rtol 0, each
# iteration count from 0 to CROSS_ITERATIONS), on one part and on (2,2,2)
# parts of 8^3
BOX_CROSS_NODES = (16, 16, 16)
BOX_CROSS_PARTS_NODES = (16, 16, 16)
# phase 4f, the two AMG paths across (2,2,2) parts of the serial backend
# (P = 8 on one card), at the reference's workload sizes, uncut:
# - amg_elasticity_parts: bench.py:371-430's elasticity workload at 40^3
#   nodes (192,000 rows, 24,000 per part), disassembled triplets assembled
#   by psparse, AMG_PARAMS, CG to rtol 1e-8;
# - amg_box_parts: bench.py:143-202's 64^3 7-point laplacian_fdm (262,144
#   rows, 32^3 per part), box aggregation and the ghosted flat cycle, CG to
#   rtol 1e-8 on ones in the first 10 own entries of part 0.
# (dtype, allowed CG iterations, limit on the true float64 residual).  The
# iterations are the JAX package's own on the CPU at the same sizes
# (PERF.md section 4): equal in float64, within one in float32.
AMG_PARTS = (2, 2, 2)
AMG_PARTS_NODES = (40, 40, 40)
AMG_PARTS_RUNS = (("float32", (12, 14), 1e-5), ("float64", (13, 13), 2e-8))
BOX_PARTS_NODES = (64, 64, 64)
BOX_PARTS_RUNS = (("float32", (9, 11), 1e-6), ("float64", (10, 10), 1e-7))
# phase 4j, the partition, vector and matrix utilities, at full size:
# - amg_unequal_parts: plaplacian_fdm((65,)*3, (2,2,2)) (274,625 rows; part
#   boxes of 32 or 33 nodes per axis, eight shapes: the own-own block is DIA
#   on the union of the parts' 13 offsets, a part's missing offsets and its
#   padding rows zero) under phase 4f's box AMG-CG (BOX_PARAMS, ones in the
#   first 10 own entries of part 0, rtol 1e-8): the box aggregation declines
#   on unequal boxes, as the JAX package's does, so the generic aggregation;
# - repartitioned: repartition_system onto eight contiguous blocks of the
#   274,625 ids (x-slabs that do not align with the grid's planes), the AMG
#   set up again, CG; the solution moved back by repartition and held to the
#   first path's: the residual of their difference within the sum of their
#   limits.
# (dtype, CG iterations of amg_unequal_parts and of repartitioned, limit on
# the true float64 residual: phase 4f's box bounds).  The iterations are the
# JAX package's own on the CPU at this size, held exactly:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/unequal_parts_jax_counts.py 65
# printed 7 and 8 in float64 and in float32 (levels 274,625 / 34,075 / 921 /
# 28 and 274,625 / 34,618 / 1,083 / 38).
UNEQUAL_NODES = (65, 65, 65)
UNEQUAL_RUNS = (("float32", 7, 8, 1e-6), ("float64", 7, 8, 1e-7))
# phase 4g, the reuse tier, through the user code of examples/implicit_reuse.py
# (the same code runs the JAX package):
# - reaction_diffusion_parts: backward Euler over Newton over refill and
#   AMGPreconditioner.update over the AMG-CG, u_t - Delta_h u + c u^3 = 0 on
#   laplacian_fdm((64,)*3, (2,2,2)) in float64, 3 steps of 1e-2; the Newton
#   iterations per step and CG iterations per solve of the JAX package on the
#   CPU at the same size (its CG compiled anew for each solve, PERF.md
#   section 4), held exactly, and every solve's true residual;
# - newton_reuse: bench.py:547-580 (the 64^3 float32 Laplacian on one part,
#   psparse(reuse=True), refill with 1.1 V, update), then CG to 1e-8 on phase
#   4e's rhs: 10 +- 1 iterations, phase 4e's anchor;
# - elasticity_update: phase 4d's elasticity in float32 at 32^3 nodes
#   (98,304 rows; cut from 40^3 to keep the script under its 800 s with the
#   sorted tier's phase and the re-setup case) refilled with a mass-like shift, update, CG to 1e-8:
#   within one of a fresh setup on the refilled operator (the JAX package's
#   update fails on such a refill).
REUSE_RD_NODES = (64, 64, 64)
REUSE_RD_PARTS = (2, 2, 2)
REUSE_RD_NEWTON = (9, 4, 2)
REUSE_RD_CG = (9, 9, 11, 13, 14, 15, 16, 16, 16, 16, 16, 16, 16, 16, 16)
REUSE_RD_RELRES = 1e-9
NEWTON_REUSE_NODES = (64, 64, 64)
NEWTON_REUSE_ITERS = (9, 11)
ELASTICITY_UPDATE_NODES = (32, 32, 32)
# - elasticity_update at 24^3 float32: the user case that raised in both
#   packages (a refilled Galerkin product real where the build's terms
#   cancelled exactly); update now sets up anew on the same aggregates
#   (n_resetups >= 1) and the CG is within one iteration of a fresh setup
RESETUP_NODES = (24, 24, 24)
# phase 4h, the Schwarz tier through the port's entry points:
# - schwarz_ilu0: bench.py:580-617, the 27-point operator at 32^3 on one part
#   (32,768 rows), AdditiveSchwarz(mode="ilu0"), cg(rtol=1e-6, maxiter=200), b
#   from build_hpcg_problem, float32 and float64; anchor: 20 iterations (the
#   JAX package on the CPU, both dtypes), held exactly in float64 and within
#   one in float32;
# - schwarz_ilu0_parts: the same operator at 64^3 on (2,2,2) parts (8 parts of
#   32^3, 262,144 rows; K6 with P = 8 clusters); anchor: the JAX package on
#   the CPU at this size: 47 iterations in float64 (158 s) and in float32
#   (203 s), held exactly in float64 and within one in float32;
# - amg_schwarz_elasticity: phase 4d's elasticity with AMGParams(smoother=
#   "schwarz"), CG to 1e-8: 16^3 float32 (the JAX package on the CPU: 6
#   iterations, held within one), 40^3 float32 and float64 with phase 4d's
#   residual limits; the ilu0 tier on levels 0 and 1, dense on level 2.
# (dtype, allowed CG iterations)
SCHWARZ_LOCAL = (32, 32, 32)
SCHWARZ_PARTS = (2, 2, 2)
SCHWARZ_RTOL = 1e-6
SCHWARZ_MAXITER = 200
SCHWARZ_RUNS = (("float32", (19, 21)), ("float64", (20, 20)))
SCHWARZ_PARTS_RUNS = (("float32", (46, 48)), ("float64", (47, 47)))
AMG_SCHWARZ_RUNS = (
    ((16, 16, 16), "float32", (5, 7), 1e-5),
    ((40, 40, 40), "float32", None, 1e-5),
    ((40, 40, 40), "float64", None, 2e-8),
)
# K6's triangular solves against their plain version, relative to the
# largest plain entry: float32 as every kernel; float64 1e-15 (4.5 ulps):
# the 32^3 solves (70 dependent waves) stay within two ulps (4.4e-16), the
# backward solve of the 40^3 elasticity fine level (835 waves) reached
# 4.53e-16 (PERF.md, section 6)
TRI_RTOL = {"float32": 1e-5, "float64": 1e-15}
# kernel against plain version on the refreshed operands of phase 4g, relative
# to the largest plain entry: in float64 two ulps; in float32 1e-6, above the
# 3.5e-7 that a 27-color K3 sweep sequence (54 color steps) on the 40^3
# elasticity level reached through FMA contraction (PERF.md, section 6)
REFRESH_RTOL = {"float32": 1e-6, "float64": 4.4e-16}
# phase 4i, the reduced-precision preconditioner values through
# hpcg_benchmark(precond_dtype=...): (local shape, parts per direction,
# vector dtype or "df64", values dtype, limit on the final relative
# residual).  HPCG's 26 and -1 are exact in bfloat16, so each run is held
# to its full-value twin's limit: 128^3 to phase 4a's 2e-6, (2,2,2) parts
# of 64^3 to phase 4b's 1e-5, df64 and float64 at 64^3 to 1e-8.
PRECOND_RUNS = (
    (LOCAL, (1, 1, 1), "float32", "bfloat16", 2e-6),
    (GHOST_LOCAL, GHOST_PARTS, "float32", "bfloat16", 1e-5),
    ((64, 64, 64), (1, 1, 1), "df64", "bfloat16", 1e-8),
    ((64, 64, 64), (1, 1, 1), "float64", "float32", 1e-8),
    ((64, 64, 64), (1, 1, 1), "float64", "bfloat16", 1e-8),
)
# the 128^3 bfloat16-valued float32 history against the float32-valued one
# of the same phase (the timed sets' own consistency bound, chain_consistent)
PRECOND_HISTORY_RTOL = 1e-4
# (values, vectors) of the narrow-value kernels
NARROW_PAIRS = (("bfloat16", "float32"), ("bfloat16", "float64"), ("float32", "float64"))
# narrow-value kernels on HPCG's own values (exact in bfloat16) against the
# full-value kernels, relative to the largest full-value entry: they run
# the same plan and the same order of the sums, so they are expected to
# agree exactly; the bound leaves room for FMA contraction alone
NARROW_HPCG_RTOL = {"float32": 1e-6, "float64": 1e-12}
# phase 4k, float16 preconditioner values and the remaining layers:
# - hpcg_float16: hpcg_benchmark(precond_dtype="float16") at (local shape,
#   vector dtype, limit on the final relative residual): 128^3 float32 (phase
#   4a's limit) and 64^3 float64 (1e-8) on one part; HPCG's 26 and -1 are
#   exact in float16, so each history must equal the full-valued and the
#   bfloat16-valued runs' exactly;
F16_RUNS = ((LOCAL, "float32", 2e-6), ((64, 64, 64), "float64", 1e-8))
F16_PAIRS = (("float16", "float32"), ("float16", "float64"))
# - block_cg: b_cg (rtol 1e-8) on the coupled two-field system [[A, C], [C, S]]
#   with A = plaplacian_fdm((64,)*3, (2,2,2)) (262,144 rows), S = A + 0.5 I,
#   C = 0.1 I on A's rows; b = G x* in float64 on the host, x* from
#   default_rng(14).  (dtype, the JAX package's iterations on the CPU at this
#   size, limit on the true relres of a float64 product):
#     JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/block_cg_jax_counts.py 64
#   printed 188 in float64 and in float32 (true relres 9.88e-9 and 3.58e-7)
BLOCK_NODES = (64, 64, 64)
BLOCK_PARTS = (2, 2, 2)
BLOCK_SHIFT = 0.5
BLOCK_COUPLING = 0.1
BLOCK_SEED = 14
BLOCK_RTOL = 1e-8
BLOCK_MAXITER = 3000
BLOCK_RUNS = (("float32", 188, 1e-6), ("float64", 188, 1e-8))
# phase 4l: ``newton_krylov`` on the reference's test problem
# (tests/test_interfaces.py:409-455) at full width: F(x) = A x + x^3 - b, A =
# plaplacian_fdm((64,)*3, (2, 2, 2)) in float64 (262,144 rows), x* = 0.3
# N(0, 1) drawn part by part from default_rng(0), b = A x* + x*^3, x0 = 0,
# 30 outer and 300 inner steps at most.  (jvp, preconditioner, rtol, inner
# rtol, the JAX package's outer iterations and |F(x)| on the CPU, the limit
# on max |x - x*|):
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/newton_krylov_jax_counts.py 64
# printed 2 outer iterations for all four, |F| 2.6513794768306986e-04,
# 2.602633947820334e-04, 2.5839840632188893, 2.3926179020084524
NK_NODES = (64, 64, 64)
NK_PARTS = (2, 2, 2)
NK_SEED = 0
NK_RUNS = (
    ("auto", None, 1e-10, 1e-6, 2, 2.6513794768306986e-04, 1e-6),
    ("auto", "gs", 1e-10, 1e-6, 2, 2.602633947820334e-04, 1e-6),
    ("fd", None, 1e-6, 1e-4, 2, 2.5839840632188893, 1e-3),
    ("fd", "gs", 1e-6, 1e-4, 2, 2.3926179020084524, 1e-3),
)
NK_RN_RTOL = 0.1  # |F(x)| at the end against the JAX package's, relative
# phase 4m: the multi-process tier, ranks as processes on the one card
# over gloo (host-staged messages; not multi-GPU figures).  The driver is
# tests/torch_multiprocess_driver.py; each rank holds its shards against
# the single-process run of the same problem on the card (the same
# iterations, x within 1e-9 relative in float64).  (ranks, modes, driver
# arguments): the reference driver's main mode (tests/multihost_driver.py:
# 60-122) at full width, build_hpcg_problem((64,)*3, (2, 2, 2)) in float64
# with GS-preconditioned CG to 1e-8, on 2 ranks (4 parts each) and on 4 (2
# each); hpcg_benchmark_mpi at (2, 2, 2) x 64^3 on 2 ranks; the
# per-process FEM construction at the reference's 129^2 nodes (:126-230);
# the per-process AMG setup, AMG-CG and one update on the 3-D laplacian_fem
# at 48^3 nodes over (2, 2, 2) (box aggregation; cut from 64^3 to keep the
# script under its 800 s with the df64 and folds modes); the agreed-dims wave
# GS
# (:231-331); hpcg_benchmark_mpi(precision="df64") at (2, 2, 2) x 64^3, every
# set's residual history bit-equal to the single-process run's; and the
# folds over all parts (pdot_df64 and collect_df64 of x = 1..40,
# find_local_indices, sparse_diag_matrix, renumber_pvector, the COO pvector,
# cg_df64 and a sorted-tier GS sweep on the 32^3 27-point operator), each
# bit-equal to SerialBackend(8)'s
MP_DRIVER = Path(__file__).resolve().parent / "tests" / "torch_multiprocess_driver.py"
MP_RUNS = (
    (2, "cg,fem,gsslot,amg,hpcg,hpcg_df64,folds", dict(
        P=8, n=64, parts="2,2,2", fem_nodes="129,129", fem_grid="8,1", wire_limit=0.1,
        amg_nodes="48,48,48", amg_grid="2,2,2", epsilon=0, coarse=200, amg_levels=6,
        hpcg_n=64, hpcg_parts="2,2,2", hpcg_levels=4, hpcg_iterations=50, folds_n=32)),
    (4, "cg", dict(P=8, n=64, parts="2,2,2")),
)
MP_LIMIT = 420  # seconds a group may take


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


def flushed_ms(fn, reps: int) -> float:
    """Mean device time of one ``fn()`` with the L2 cache flushed before
    each call (a read of 512 MB, ten times the card's 50 MB L2), by CUDA
    events around each call: the time of a call whose operands arrive
    cold, as they do on a path that runs other kernels in between."""
    import torch

    scratch = torch.ones(128 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        scratch.sum()  # the host queues the timed call while this runs
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def device_ms(fn, reps: int):
    """Device time of one ``fn()`` from torch.profiler over ``reps`` calls:
    for each kernel, memset or copy the calls ran, its mean time per launch
    times its launches per call.  Unlike ``time_ms`` it leaves out the
    host's time between launches.  The profiler does not always keep every
    launch of a window, and now and then keeps none: the mean per launch
    does not depend on how many it kept, and a window with none is
    profiled again with twice the calls, up to six times (then None)."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        if events:
            return sum(e.self_device_time_total / e.count * math.ceil(e.count / reps)
                       for e in events) / 1e3
        reps *= 2
    return None


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


def bound(nbytes: float, ops: float, flops_per_s: float = F32_FLOPS_PER_S):
    """The least time (ms) a call that moves ``nbytes`` and does ``ops``
    operations can take on the card, and which of the two sets it: the
    larger of bytes over the memory rate and operations over the rate of
    their type (float32 unless ``flops_per_s`` says otherwise)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _hold(results, kname, dtype_name, kernel, plain, timed=None, library=None, work=None,
          flushed=False, rtol=KERNEL_RTOL):
    """Run ``kernel`` and ``plain`` on the same inputs, hold the largest
    difference to ``rtol`` of the largest plain entry, and time both (or
    the pair ``timed``, calls without the set-up copies).  ``library``: one
    PyTorch call computing the same function, held to ``KERNEL_RTOL`` and
    timed; ``work``: (bytes, operations) of the call,
    for its bound; ``flushed``: also time the kernel and the library call
    with the L2 flushed before each call (``flushed_ms``)."""
    import torch

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    max_abs = (got - want).abs().max().item()
    scale = want.abs().max().item()
    tol = rtol[dtype_name] * scale
    if not (max_abs <= tol):
        raise AssertionError(f"{kname} {dtype_name}: max |kernel - plain| {max_abs} > {tol}")
    results.append({
        "kernel": kname, "dtype": dtype_name, "max_abs_err": max_abs,
        "max_rel_err": max_abs / scale, "tol_rel": rtol[dtype_name],
    })
    k_t, p_t = timed if timed is not None else (kernel, plain)
    results[-1].update(ms=time_ms(k_t, 20), plain_ms=time_ms(p_t, 5),
                       device_ms=device_ms(k_t, 20))
    if library is not None:
        lib_err = (library().reshape(want.shape) - want).abs().max().item()
        if not (lib_err <= KERNEL_RTOL[dtype_name] * scale):
            raise AssertionError(f"{kname} {dtype_name}: the library call differs by {lib_err}")
        results[-1].update(library_ms=time_ms(library, 20), library_max_abs_err=lib_err,
                           library_device_ms=device_ms(library, 20))
        if flushed:
            results[-1].update(library_ms_flushed=flushed_ms(library, 20))
    if flushed:
        results[-1].update(ms_flushed=flushed_ms(k_t, 20))
    if work is not None:
        b_ms, b_by = bound(*work)
        results[-1].update(bytes=work[0], ops=work[1], bound_ms=b_ms, bound_by=b_by)


def _dia_triplets(offsets, vals, n_cols: int, rows_per_part: int, row0: int = 0):
    """The nonzeros of DIA values ``vals[P, n_off, R]`` (x zero outside
    ``[0, n_cols)``) as (row, column, value) tensors of a block-diagonal
    matrix of P blocks of ``rows_per_part`` rows and ``n_cols`` columns,
    the R rows starting at ``row0`` of each block."""
    import torch

    P, _, R = vals.shape
    i = torch.arange(R, device=vals.device)
    part = torch.arange(P, device=vals.device).unsqueeze(1)
    rows, cols, vs = [], [], []
    for d, off in enumerate(offsets):
        j = i + off
        keep = ((j >= 0) & (j < n_cols)).unsqueeze(0) & (vals[:, d] != 0)
        rows.append((part * rows_per_part + row0 + i).expand(P, R)[keep])
        cols.append((part * n_cols + j).expand(P, R)[keep])
        vs.append(vals[:, d][keep])
    return torch.cat(rows), torch.cat(cols), torch.cat(vs)


def _csr(rows, cols, vals, shape):
    """A torch sparse CSR matrix with int32 indices from (row, col, value)."""
    import torch

    csr = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape).coalesce().to_sparse_csr()
    return torch.sparse_csr_tensor(
        csr.crow_indices().int(), csr.col_indices().int(), csr.values(), shape
    )


def _library(csr, x, y=None):
    """``csr @ x`` (or ``y + csr @ x``) on flattened operands as one
    ``torch.mv`` (``torch.addmv``) call."""
    import torch

    xf = x.reshape(-1)
    if y is None:
        return lambda: torch.mv(csr, xf)
    yf = y.reshape(-1)
    return lambda: torch.addmv(yf, csr, xf)


def _flops(dtype_name: str) -> float:
    return F32_FLOPS_PER_S if dtype_name == "float32" else F64_FLOPS_PER_S


def _hold_k1(results, where, oo, x, library=None, rtol=KERNEL_RTOL):
    """K1 against its plain version on the DIA block ``oo`` and the x of
    its columns (``_hold``); bound: the values, x and y, each moved once."""
    from partitionedarrays_tpu_torch.ops.dia import dia_spmv_plain
    from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv

    dtype_name = str(x.dtype).replace("torch.", "")
    P, _, R = oo.vals.shape
    _hold(results, "dia_spmv", dtype_name,
          lambda: dia_spmv(oo.offsets, oo.vals, x),
          lambda: dia_spmv_plain(oo.offsets, oo.vals, x),
          library=library, rtol=rtol,
          work=(x.element_size() * (oo.vals.numel() + x.numel() + P * R), 2 * oo.vals.numel(),
                _flops(dtype_name)))
    results[-1].update(where=where, n_diags=len(oo.offsets), rows=P * R)


def _hold_k4(results, where, col, x, library=None, rtol=KERNEL_RTOL, vals=None):
    """K4 against its plain version on a colored smoother's core ``col``
    (or other values ``vals`` of its shape, e.g. narrower ones) and the
    core x (``_hold``); bound: the values once in their own dtype, x read
    and out written once."""
    from partitionedarrays_tpu_torch.ops.gs_dia_kernels import ax_core, ax_core_plain

    vals = col.vals_d if vals is None else vals
    dtype_name = str(x.dtype).replace("torch.", "")
    _hold(results, "ax_core", dtype_name,
          lambda: ax_core(vals, x, col.taps),
          lambda: ax_core_plain(vals, x, col.taps),
          library=library, rtol=rtol,
          work=(vals.element_size() * vals.numel() + x.element_size() * 2 * x.numel(),
                2 * vals.numel(), _flops(dtype_name)))
    results[-1].update(where=where, values=str(vals.dtype).replace("torch.", ""), m=col.m,
                       n_off=len(col.offsets), Lq=col.Lq)


def _hold_k7(results, where, oo, g, device):
    """K7 against its plain version and, with it, against K1 in float64 on
    the same values: the (hi, lo) split of the float64 DIA block ``oo`` and
    of a random x.  Errors relative to sum_j |A_ij| |x_j| per row."""
    import torch

    from partitionedarrays_tpu_torch.ops import df64 as df
    from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_df

    P = oo.vals.shape[0]
    vh, vl = df.from_f64(oo.vals)
    x64 = torch.randn(P, oo.n_cols_pad, generator=g, dtype=torch.float64).to(device)
    x = df.from_f64(x64)
    got = df.to_f64(*dia_spmv_df(oo.offsets, vh, vl, x))
    torch.cuda.synchronize()
    want = df.to_f64(*df.dia_spmv_df_plain(oo.offsets, vh, vl, x))
    exact = dia_spmv(oo.offsets, oo.vals, x64)
    scale = dia_spmv(oo.offsets, oo.vals.abs(), x64.abs()) + 1e-30
    errs = {
        "kernel_vs_plain": ((got - want).abs() / scale).max().item(),
        "kernel_vs_f64": ((got - exact).abs() / scale).max().item(),
        "plain_vs_f64": ((want - exact).abs() / scale).max().item(),
    }
    bad = {k: v for k, v in errs.items() if not v <= DF64_KERNEL_TOL}
    if bad:
        raise AssertionError(f"dia_spmv_df {where}: {bad} > {DF64_KERNEL_TOL}")
    _, n_off, R = vh.shape
    work = (4 * (2 * vh.numel() + 2 * x[0].numel() + 2 * P * R), 15 * vh.numel())
    b_ms, b_by = bound(*work)
    results.append({
        "kernel": "dia_spmv_df", "dtype": "df64", "where": where, "n_diags": n_off,
        "rows": P * R, "max_abs_err": (got - want).abs().max().item(),
        "tol_rel_sum_abs": DF64_KERNEL_TOL, **errs,
        "ms": time_ms(lambda: dia_spmv_df(oo.offsets, vh, vl, x), 20),
        "device_ms": device_ms(lambda: dia_spmv_df(oo.offsets, vh, vl, x), 20),
        "plain_ms": time_ms(lambda: df.dia_spmv_df_plain(oo.offsets, vh, vl, x), 3),
        "k1_float64_ms": time_ms(lambda: dia_spmv(oo.offsets, oo.vals, x64), 20),
        "bytes": work[0], "ops": work[1], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })


def phase_kernels(device):
    """Each kernel against its plain version: K1, K4, K3 at the 128^3
    one-part fine-level shapes, K5 and K2 at the (2,2,2) x 64^3 ones."""
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
    from partitionedarrays_tpu_torch.ops.dia import dia_spmv_plain
    from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv_strided
    from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv, ghost_spmv_plain
    from partitionedarrays_tpu_torch.ops.gs_dia_kernels import gs_sweeps, gs_sweeps_plain
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
        f32 = dtype == torch.float32
        P, _, R = oo.vals.shape
        m, Lq = col.m, col.Lq
        lib = {}
        if f32:  # the same products as one torch.sparse CSR call each
            lib["dia_spmv"] = _library(_csr(
                *_dia_triplets(oo.offsets, oo.vals, oo.n_cols_pad, R), (P * R, P * oo.n_cols_pad)
            ), x_std)
            lib["ax_core"] = _library(_csr(*(torch.cat(t) for t in zip(*(
                _dia_triplets(col.taps.host[c], col.vals_d[:, c], m * Lq, m * Lq, c * Lq)
                for c in range(m)))), (P * m * Lq, P * m * Lq)), x_core)
        _hold_k1(results, f"fine level, one part of {LOCAL[0]}^3", oo, x_std,
                 library=lib.get("dia_spmv"))
        _hold_k4(results, f"fine level, one part of {LOCAL[0]}^3", col, x_core,
                 library=lib.get("ax_core"))
        # the sweep sequence reads each input once at the least: values,
        # rhs, inverse diagonal, x in and x out
        sweeps = len(order) / m
        isz = x_core.element_size()
        _hold(results, "gs_sweeps", name,
              lambda: gs_sweeps(col.vals_d, bd, col.invd_d, x_core, col.taps, order),
              lambda: gs_sweeps_plain(col.vals_d, bd, col.invd_d, x_core, col.taps, order),
              work=(isz * (col.vals_d.numel() + bd.numel() + col.invd_d.numel() + 2 * x_core.numel()),
                    sweeps * (2 * col.vals_d.numel() + 3 * x_core.numel()), _flops(name)))
        del A, b, gs, col, oo, x_std, x_core, bd, lib
        torch.cuda.empty_cache()

        P = 8
        A, _ = build_hpcg_problem(GHOST_LOCAL, GHOST_PARTS, SerialBackend(P), dtype=dtype, device=device)
        oh = A.device().oh
        col = GaussSeidel(A).colored
        g_vals = torch.randn(P, A.col_layout().n_ghost_pad, generator=g, dtype=dtype).to(device)
        y0 = torch.randn(P, oh.n_rows, generator=g, dtype=dtype).to(device)
        core = torch.randn(P, col.m * col.Lq, generator=g, dtype=dtype).to(device)
        c = col.m // 2  # a middle color: its taps reach both neighbouring rows
        taps, vals_c = col.taps.host[c], col.vals_d[:, c]
        f32 = dtype == torch.float32
        Nr, K, R, n_g = oh.rows.shape[1], oh.cols.shape[1], oh.n_rows, g_vals.shape[1]
        Lq, mLq = col.Lq, col.m * col.Lq
        lib = {}
        if f32:
            live = oh.cols >= 0
            part = torch.arange(P, device=device).view(P, 1, 1)
            lib["ghost_spmv"] = _library(_csr(
                (part * R + oh.rows.unsqueeze(1)).expand(P, K, Nr)[live],
                (part * n_g + oh.cols)[live], oh.vals[live], (P * R, P * n_g),
            ), g_vals, y0)
            lib["dia_spmv_strided"] = _library(
                _csr(*_dia_triplets(taps, vals_c, mLq, Lq), (P * Lq, P * mLq)), core
            )
        n_live = int((oh.rows >= 0).sum())
        isz = core.element_size()
        # K5 accumulates into y: compared on copies of y0, timed in place
        y_t = y0.clone()
        _hold(results, "ghost_spmv", name,
              lambda: ghost_spmv(oh.rows, oh.cols, oh.vals, g_vals, y0.clone(), oh.plan),
              lambda: ghost_spmv_plain(oh.rows, oh.cols, oh.vals, g_vals, y0.clone()),
              timed=(lambda: ghost_spmv(oh.rows, oh.cols, oh.vals, g_vals, y_t, oh.plan),
                     lambda: ghost_spmv_plain(oh.rows, oh.cols, oh.vals, g_vals, y_t)),
              library=lib.get("ghost_spmv"),
              # rows and columns (int32), values and ghost values once; each
              # live row of y read and written
              work=(4 * (oh.rows.numel() + oh.cols.numel())
                    + isz * (oh.cols.numel() + g_vals.numel() + 2 * n_live),
                    2 * int((oh.cols >= 0).sum()), _flops(name)),
              # on the path it runs between other kernels: its operands arrive cold
              flushed=True)
        results[-1].update(where="own-ghost block, (2,2,2)x64^3", lanes=oh.plan.lanes,
                           every_g_ms_flushed=_every_g(oh, g_vals, y_t))
        _hold(results, "dia_spmv_strided", name,
              lambda: dia_spmv_strided(taps, vals_c, core),
              lambda: dia_spmv_plain(taps, vals_c, core),
              library=lib.get("dia_spmv_strided"),
              work=(isz * (vals_c.numel() + core.numel() + P * Lq), 2 * vals_c.numel(), _flops(name)),
              # the sweep runs one color between other kernels, so its
              # 31 MB arrive cold; back to back they stay in the 50 MB L2
              flushed=True)
        results[-1].update(shape=list(vals_c.shape), m=col.m, Lq=Lq, color=c)
        del y_t, A, oh, col, g_vals, y0, core, vals_c, lib
        torch.cuda.empty_cache()
    emit("3 kernels", results)
    return results


def phase_kernel_df(device):
    """K7 against its plain version and, with it, against K1 in float64 on
    the same values, at the 128^3 one-part and (2,2,2) x 64^3 fine shapes:
    the (hi, lo) split of the float64 27-point operator and of a random x.
    Errors relative to sum_j |A_ij| |x_j| per row."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem

    results = []
    for shape, parts in ((LOCAL, (1, 1, 1)), (GHOST_LOCAL, GHOST_PARTS)):
        P = int(np.prod(parts))
        A, _ = build_hpcg_problem(shape, parts, SerialBackend(P), dtype=torch.float64, device=device)
        _hold_k7(results, f"{parts}x{shape[0]}^3", A.device().oo,
                 torch.Generator().manual_seed(4321), device)
        del A
        torch.cuda.empty_cache()
    emit("3b kernel K7", results)
    return results


def _k3_work(col, order, itemsize: int, zero_guess: bool, values_itemsize=None):
    """(bytes, operations, streaming-floor bytes) of one K3 call running
    the color steps ``order``.  Bytes: each input the call reads, once
    (the values of every color that a step taps, bd and invd of every
    color it updates, x in unless the guess is zero) and x written once.
    The streaming floor: each step reads its color's values (none at a
    zero guess's first step), bd and invd once, and x is read (unless the
    guess is zero) and written once.  Values of ``values_itemsize`` bytes
    (default: ``itemsize``, the vectors')."""
    P, m, n_off, Lq = col.vals_d.shape
    vsize = values_itemsize or itemsize
    z = int(zero_guess)
    tapped = len(set(order[z:]))
    steps = len(order) - z
    nbytes = P * Lq * (vsize * n_off * tapped + itemsize * (2 * len(set(order)) + (2 - z) * m))
    ops = P * Lq * (steps * (2 * n_off + 3) + z)
    floor = P * Lq * (vsize * steps * n_off + itemsize * (2 * steps + 2 * z + (2 - z) * m))
    return nbytes, ops, floor


def _k3_plans(col, itemsize: int):
    """K3's launch plan at each lane count, with CTAs for one pass over a
    step."""
    from partitionedarrays_tpu_torch.ops.dia_rows import THREADS, SweepPlan, vec_of

    groups = col.vals_d.shape[-1] // vec_of(itemsize)
    return [SweepPlan(lanes, -(-groups * lanes // THREADS)) for lanes in (1, 2, 4, 8, 16)]


def _hold_k3(results, where, gs, dtype_name, g, device, rtol=KERNEL_RTOL):
    """K3 against its plain version on one level's smoother, symmetric
    order, from a guess and from a zero guess (plain: on a zero core); the
    kernel's time under its default plan and, from the guess, under every
    other plan (``_k3_plans``)."""
    import torch

    from partitionedarrays_tpu_torch.ops.dia_rows import sweep_plan
    from partitionedarrays_tpu_torch.ops.gs_dia_kernels import gs_sweeps, gs_sweeps_plain
    from partitionedarrays_tpu_torch.utils import profiling

    col = gs.colored
    dtype = getattr(torch, dtype_name)
    P, m, n_off, Lq = col.vals_d.shape
    x0 = torch.randn(P, m, Lq, generator=g, dtype=dtype).to(device)
    bd = torch.randn(P, m, Lq, generator=g, dtype=dtype).to(device)
    zero = torch.zeros_like(x0)
    order = gs._order_seq()
    itemsize = x0.element_size()
    plan = sweep_plan(P, m, n_off, Lq, itemsize)
    for start in (x0, None):
        plain_start = zero if start is None else start
        nbytes, ops, floor = _k3_work(col, order, itemsize, zero_guess=start is None)
        b_ms, b_by = bound(nbytes, ops, F32_FLOPS_PER_S if itemsize == 4 else F64_FLOPS_PER_S)
        before = profiling.launches("gs_sweeps")
        got = gs_sweeps(col.vals_d, bd, col.invd_d, start, col.taps, order)
        launches = profiling.launches("gs_sweeps") - before
        torch.cuda.synchronize()
        want = gs_sweeps_plain(col.vals_d, bd, col.invd_d, plain_start, col.taps, order)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not err <= rtol[dtype_name] * scale:
            raise AssertionError(f"gs_sweeps {where} {dtype_name}: max |kernel - plain| {err}, "
                                 f"{err / scale} of the largest entry")
        row = {
            "kernel": "gs_sweeps", "dtype": dtype_name, "where": where,
            "guess": "zero" if start is None else "random",
            "P": P, "m": m, "n_off": n_off, "Lq": Lq, "steps": len(order),
            "plan": list(plan), "launches_per_call": launches,
            "max_abs_err": err, "max_rel_err": err / scale, "tol_rel": rtol[dtype_name],
            "ms": time_ms(lambda: gs_sweeps(col.vals_d, bd, col.invd_d, start, col.taps, order), 20),
            "device_ms": device_ms(
                lambda: gs_sweeps(col.vals_d, bd, col.invd_d, start, col.taps, order), 20),
            "plain_ms": time_ms(lambda: gs_sweeps_plain(
                col.vals_d, bd, col.invd_d, plain_start, col.taps, order), 3),
            "library_ms": None, "bytes": nbytes, "ops": ops, "bound_ms": b_ms, "bound_by": b_by,
            "floor_bytes": floor, "floor_ms": floor / HBM_BYTES_PER_S * 1e3,
        }
        if start is not None:
            # a launch of no step and of one step beside the whole sequence:
            # the fixed cost and the cost of each further step
            row["steps_device_ms"] = [
                [n, device_ms(lambda n=n: gs_sweeps(
                    col.vals_d, bd, col.invd_d, x0, col.taps, order[:n]), 20)]
                for n in (0, 1)
            ] + [[len(order), row["device_ms"]]]
            row["other_plans_device_ms"] = [
                [*p, device_ms(lambda p=p: gs_sweeps(
                    col.vals_d, bd, col.invd_d, x0, col.taps, order, _plan=p), 20)]
                for p in _k3_plans(col, itemsize) if p != plan
            ]
        results.append(row)


def _hold_k4_level(results, where, col, vectors, g, device, fine):
    """K4 on one level's smoother ``col`` in the vectors' dtype and under
    it in each narrow pair (``NARROW_PAIRS``): random values of the
    level's pattern (its operator scaled by [0.5, 1) per entry) stored in
    each values dtype, against the plain version under the plan
    (``dia_rows.ax_plan``, timed: ``_hold_k4``, with the ``torch.sparse``
    CSR call at the ``fine`` level) and under every other lane count
    (held, and its device time); then on the level's own values, exact in
    bfloat16, each narrow pair against the full-value kernel under every
    lane count, which must agree bit for bit (the same plan, the same
    order of the sums)."""
    import torch

    from partitionedarrays_tpu_torch.ops.dia_rows import AxPlan, ax_plan
    from partitionedarrays_tpu_torch.ops.gs_dia_kernels import ax_core, ax_core_plain

    dtype = getattr(torch, vectors)
    P, m, n_off, Lq = col.vals_d.shape
    x = torch.randn(P, m, Lq, generator=g, dtype=dtype).to(device)
    scale = 0.5 + 0.5 * torch.rand(col.vals_d.shape, generator=g, dtype=dtype)
    base = col.vals_d * scale.to(device)
    del scale
    plan = ax_plan(P, m, n_off, Lq, x.element_size())
    pairs = [vectors] + [v for v, t in NARROW_PAIRS if t == vectors]
    for values in pairs:
        vals = base.to(getattr(torch, values))
        library = None
        if fine and values == vectors:
            library = _library(_csr(*(torch.cat(t) for t in zip(*(
                _dia_triplets(col.taps.host[c], vals[:, c], m * Lq, m * Lq, c * Lq)
                for c in range(m)))), (P * m * Lq, P * m * Lq)), x)
        _hold_k4(results, where, col, x, library=library, vals=vals)
        row = results[-1]
        want = ax_core_plain(vals, x, col.taps)
        scale_max = want.abs().max().item()
        other = {}
        for lanes in (1, 2, 4, 8, 16):
            p = AxPlan(lanes)
            err = (ax_core(vals, x, col.taps, _plan=p) - want).abs().max().item()
            if not err <= KERNEL_RTOL[vectors] * scale_max:
                raise AssertionError(f"ax_core {where} {values}/{vectors} lanes {lanes}: "
                                     f"max |kernel - plain| {err}, {err / scale_max} of the largest")
            if p != plan:
                other[lanes] = [err / scale_max, device_ms(
                    lambda p=p: ax_core(vals, x, col.taps, _plan=p), 20)]
        row.update(plan=list(plan), other_lanes_rel_err_device_ms=other)
        del vals, library, want
    exact = {}
    for values in pairs[1:]:
        narrow = col.vals_d.to(getattr(torch, values))
        if not torch.equal(narrow.to(dtype), col.vals_d):
            raise AssertionError(f"{where}: HPCG's values are not exact in {values}")
        diff = max((ax_core(narrow, x, col.taps, _plan=AxPlan(G))
                    - ax_core(col.vals_d, x, col.taps, _plan=AxPlan(G))).abs().max().item()
                   for G in (1, 2, 4, 8, 16))
        if diff != 0.0:
            raise AssertionError(f"ax_core {where}: {values} values differ from full values by "
                                 f"{diff} on HPCG's operator")
        exact[values] = diff
    for row in results[-len(pairs):]:
        row["hpcg_values_narrow_vs_full_max_abs"] = exact
    del base, x
    torch.cuda.empty_cache()


def phase_k3_levels(device):
    """K3 on every level of the one-part 128^3 hierarchy and of the
    (2,2,2) x 64^3 one (``_hold_k3``), float32 and float64: the plan
    depends on the part count, so each path's levels are held under its
    own; and K4 on every level of the one-part hierarchy in every (values,
    vectors) pair under every lane count (``_hold_k4_level``).  Returns
    the K3 rows and the K4 rows."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner

    results, k4_results = [], []
    g = torch.Generator().manual_seed(777)
    for dtype in ("float32", "float64"):
        for local, parts in ((LOCAL, (1, 1, 1)), (GHOST_LOCAL, GHOST_PARTS)):
            P = int(np.prod(parts))
            mg = HPCGMGPreconditioner(
                local, parts, SerialBackend(P), n_levels=LEVELS, dtype=getattr(np, dtype),
                device=device,
            )
            for l, gs in enumerate(reversed(mg.gss)):
                where = f"level {l} of {parts}x{local[0]}^3"
                _hold_k3(results, where, gs, dtype, g, device)
                if P == 1:
                    _hold_k4_level(k4_results, where, gs.colored, dtype, g, device, l == 0)
            del mg
            torch.cuda.empty_cache()
    emit("3c kernel K3 levels", results)
    emit("3d kernel K4 levels", k4_results)
    return results, k4_results


def phase_hpcg(device):
    """The benchmark through the port, plus the standard-order operator (K1)
    against the de-interleaved one (K4) and in the generic CG."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg, hpcg_cg_flat
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
        prof = None
        if (shape, dtype) == (LOCAL, "float32"):  # one set: launches and device time
            prof = _profile_set(lambda: hpcg_cg_flat(mg, mg.b, iterations=ITERATIONS), top=12)
            prof["per_color_k3"] = PER_COLOR_K3_SET
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
            "profiled_set": prof,
            "nrow": s["nrow"],
            "nnz": s["nnz"],
        }
        if not op_err <= KERNEL_RTOL[name]:
            failures.append(f"{key}: standard vs de-interleaved operator differ by {op_err}")
        if not (s["final_relres"] <= limit and generic_relres <= limit):
            failures.append(f"{key}: relres {s['final_relres']} / {generic_relres} > {limit}")
        if not (s["validation_passed"] and s["chain_consistent"]):
            failures.append(f"{key}: HPCG validation or chain consistency failed")
        del mg, report, A, gs, x, y_std, y_core, norms
        torch.cuda.empty_cache()
    emit("4a hpcg one part", out)
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def phase_hpcg_ghosted(device):
    """The benchmark on (2,2,2) parts through the ghosted flat CG, plus the
    standard-order ``spmv`` (exchange, K1, K5) against the core product (K4)
    plus the ghost contribution, the generic CG, and the standalone colored
    sweep (K2) against the smoother's sweep sequence (K3)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg
    from partitionedarrays_tpu_torch.models.hpcg.driver import cg_route, hpcg_benchmark
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
    from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv
    from partitionedarrays_tpu_torch.psparse import spmv
    from partitionedarrays_tpu_torch.pvector import PVector
    from partitionedarrays_tpu_torch.utils import profiling

    P = int(np.prod(GHOST_PARTS))
    out, failures = {}, []
    for shape, dtype, limit in GHOSTED_RUNS:
        name = np.dtype(dtype).name
        key = f"{name}@{GHOST_PARTS}x{shape[0]}^3"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mg = HPCGMGPreconditioner(
            shape, GHOST_PARTS, SerialBackend(P), n_levels=LEVELS, dtype=dtype, device=device
        )
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        route = cg_route(mg)
        k5_before = profiling.launches("ghost_spmv")
        report = hpcg_benchmark(
            None, local_shape=shape, parts_per_dir=GHOST_PARTS, n_levels=LEVELS,
            iterations=ITERATIONS, ref_sets=1, timed_sets=3, dtype=dtype,
            mg=mg, setup_time=setup, device=device,
        )
        k5_in_benchmark = profiling.launches("ghost_spmv") - k5_before
        s = report.summary()
        A, gs = mg.A, mg.gss[-1]
        col = gs.colored
        lay = A.row_layout()
        g = torch.Generator().manual_seed(98)
        x = torch.zeros(P, lay.n_own_pad, dtype=A.dtype)
        x[:, : int(lay.n_own[0])] = torch.randn(P, int(lay.n_own[0]), generator=g, dtype=A.dtype)
        x = x.to(device)
        # standard order (exchange, K1, K5) against core (K4) + ghosts (K5)
        y_std = spmv(A, PVector(x, x.new_zeros(P, lay.n_ghost_pad), lay, A.backend)).own
        y_core = gs.flat_interleave(gs.flat_ax(gs.flat_deinterleave(x))) + gs.ghost_contrib(x)
        op_err = (y_std - y_core).abs().max().item() / y_std.abs().max().item()
        # the standalone sweep (K2 per color) against the sweep sequence (K3)
        gc = gs.ghost_contrib(x)
        order = gs._order_seq()
        via_k2 = col.sweep(x, mg.b.own, gc, col.vals_d, col.invd_d, order)
        via_k3 = gs.flat_interleave(col.sweeps_core(
            gs.flat_deinterleave(x), gs.flat_deinterleave(mg.b.own - gc),
            col.vals_d, col.invd_d, order,
        ))
        sweep_err = (via_k2 - via_k3).abs().max().item() / via_k3.abs().max().item()
        _, norms = hpcg_cg(A, mg.b, M=mg, iterations=ITERATIONS)
        generic_relres = (norms[-1] / norms[0]).item()
        gf = report.gflops()
        out[key] = {
            "cg_route": route,
            "ghost_spmv_launches_in_benchmark": k5_in_benchmark,
            "raw_gflops": gf["raw"],
            "rated_gflops": gf["rated"],
            "final_relres": s["final_relres"],
            "relres_limit": limit,
            "generic_cg_relres": generic_relres,
            "validation_passed": s["validation_passed"],
            "chain_consistent": s["chain_consistent"],
            "seconds_per_set": report.time_solve / report.n_sets,
            "setup_s": setup,
            "spmv_rel_err": op_err,
            "sweep_k2_vs_k3_rel_err": sweep_err,
            "n_ghost_pad": A.col_layout().n_ghost_pad,
            "exchange_rounds": A.col_layout().consistent_plan.n_rounds,
            "nrow": s["nrow"],
            "nnz": s["nnz"],
        }
        if route != "flat_g" or k5_in_benchmark <= 0:
            failures.append(f"{key}: the benchmark did not take the ghosted flat CG ({route})")
        if not op_err <= KERNEL_RTOL[name]:
            failures.append(f"{key}: spmv vs core product + ghosts differ by {op_err}")
        if not sweep_err <= KERNEL_RTOL[name]:
            failures.append(f"{key}: sweep (K2) vs sweeps_core (K3) differ by {sweep_err}")
        if not (s["final_relres"] <= limit and generic_relres <= limit):
            failures.append(f"{key}: relres {s['final_relres']} / {generic_relres} > {limit}")
        if not (s["validation_passed"] and s["chain_consistent"]):
            failures.append(f"{key}: HPCG validation or chain consistency failed")
        del mg, report, A, gs, col, x, y_std, y_core, gc, via_k2, via_k3, norms
        torch.cuda.empty_cache()
    emit("4b hpcg ghosted", out)
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def _profile_set(run_set, top: int = 0, kernels=("gs_seq",)) -> dict:
    """Device events (kernels, memsets, copies) and device time of one
    warm call of ``run_set``, from torch.profiler, beside its wall time;
    with ``top``, the ``top`` device ops by device time (name, count, ms);
    and for each name of ``kernels`` (K3's by default) the launches,
    device ms and share of the device time of the kernels whose name holds
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run_set()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_set()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {
        "device_events": sum(e.count for e in events),
        "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
        "profiled_wall_ms": wall * 1e3,
    }
    for kernel in kernels:
        mine = [e for e in events if kernel in e.key]
        mine_ms = sum(e.self_device_time_total for e in mine) / 1e3
        out[kernel] = {"launches": sum(e.count for e in mine), "ms": mine_ms,
                       "share": mine_ms / out["device_ms"] if out["device_ms"] else None}
    if top:
        events.sort(key=lambda e: -e.self_device_time_total)
        out["top"] = [[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in events[:top]]
    return out


def phase_hpcg_df64(device):
    """The benchmark with ``precision="df64"``: the df64 CG (K7 through
    ``spmv_df64``) with the float32 MG (K3, K4, and K5 with ghosts).  Each
    configuration profiles one set; the one of ``DF64_CG_SHAPE`` also runs
    ``cg_df64`` on the same float64 operator with no preconditioner and
    with the MG's float32 fine-level GaussSeidel."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_df64
    from partitionedarrays_tpu_torch.models.hpcg.driver import cg_route, df64_problem, hpcg_benchmark
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
    from partitionedarrays_tpu_torch.ops import df64 as df
    from partitionedarrays_tpu_torch.psparse import spmv
    from partitionedarrays_tpu_torch.pvector import PVector
    from partitionedarrays_tpu_torch.solvers.krylov import cg_df64

    out, failures = {}, []
    for shape, parts, limit in DF64_RUNS:
        P = int(np.prod(parts))
        key = f"df64@{parts}x{shape[0]}^3"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mg = HPCGMGPreconditioner(
            shape, parts, SerialBackend(P), n_levels=LEVELS, dtype=np.float32, device=device
        )
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        A, b = df64_problem(shape, parts, mg.backend, device)
        torch.cuda.synchronize()
        setup = (t1 - t0, time.perf_counter() - t1)  # MG, df64 operator and rhs
        report = hpcg_benchmark(
            None, local_shape=shape, parts_per_dir=parts, n_levels=LEVELS,
            iterations=ITERATIONS, ref_sets=1, timed_sets=3, precision="df64",
            mg=mg, setup_time=sum(setup), device=device,
        )
        s = report.summary()
        prof = _profile_set(lambda: hpcg_cg_df64(A, b, M=mg, iterations=ITERATIONS),
                            kernels=("gs_seq", "dia_spmv_df"))
        b64 = df.to_f64(b[0].own, b[1].own)
        solves = {}
        side = (shape, parts) == DF64_CG_SHAPE
        for name, M in (("none", None), ("gauss_seidel", mg.gss[-1])) if side else ():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = cg_df64(A, b, M=M, rtol=DF64_CG_RTOL, maxiter=DF64_CG_MAXITER)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            x64 = df.to_f64(x[0].own, x[1].own)
            xv = PVector(x64, x64.new_zeros((P, A.row_layout().n_ghost_pad)), A.row_layout(), A.backend)
            true_relres = (torch.linalg.vector_norm(b64 - spmv(A, xv).own)
                           / torch.linalg.vector_norm(b64)).item()
            solves[name] = {
                "iterations": info.iterations, "seconds": seconds, "true_relres": true_relres,
            }
            if info.iterations >= DF64_CG_MAXITER or not true_relres <= DF64_CG_TRUE_RELRES:
                failures.append(f"{key}: cg_df64 ({name}) {solves[name]}")
        gf = report.gflops()
        out[key] = {
            "cg_route": cg_route(mg, "df64"),
            "dtype": s["dtype"],
            "precision_bits": s["precision_bits"],
            "raw_gflops": gf["raw"],
            "rated_gflops": gf["rated"],
            "final_relres": s["final_relres"],
            "relres_limit": limit,
            "validation_passed": s["validation_passed"],
            "chain_consistent": s["chain_consistent"],
            "seconds_per_set": report.time_solve / report.n_sets,
            "setup_mg_s": setup[0],
            "setup_df64_s": setup[1],
            "profiled_set": prof,
            "cg_df64": solves,
            "nrow": s["nrow"],
            "nnz": s["nnz"],
        }
        if (s["dtype"], s["precision_bits"]) != ("float64-df64", 49):
            failures.append(f"{key}: report says {s['dtype']}, {s['precision_bits']} bits")
        if not s["final_relres"] <= limit:
            failures.append(f"{key}: relres {s['final_relres']} > {limit}")
        if not (s["validation_passed"] and s["chain_consistent"]):
            failures.append(f"{key}: HPCG validation or chain consistency failed")
        del mg, A, b, report, b64
        torch.cuda.empty_cache()
    emit("4c hpcg df64", out)
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def _level_info(M):
    """Per level: rows, nnz, block kind, smoother tier and its geometry, and
    on a box-aggregated level its fine and coarse boxes and whether the
    cycle runs it flat."""
    out = []
    for l, lev in enumerate(M.levels):
        oo = lev.A.device().oo
        info = {"rows": lev.A.shape[0], "nnz": lev.A.nnz(), "kind": oo.kind,
                "n_diags": len(oo.offsets) if oo.kind == "dia" else None}
        if lev.struct is not None:
            info.update(box=[list(lev.struct.fine), list(lev.struct.coarse)], flat=M._flat_ok(l))
        gs = lev.smoother
        if gs is None:
            info["smoother"] = f"coarse {M.coarse_kind}"
        elif hasattr(gs, "sgsL"):  # AdditiveSchwarz
            info["smoother"] = f"schwarz {gs.mode}"
            if gs.mode == "ilu0":
                info["factors"] = _schwarz_factors(gs)
        elif gs.colored is not None:
            info.update(smoother="colored", m=gs.colored.m)
        else:
            tg = gs.tile_gs
            info.update(smoother="tile", tiles=tg.n_real_tiles, W=tg.W, B=tg.B)
        out.append(info)
    return out


def _timed(counters, fn):
    """``fn()`` with every launch count set to 0 just before it: (its
    result, its seconds by CUDA events, the launches it made)."""
    import torch

    from partitionedarrays_tpu_torch.utils import profiling

    profiling.reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3, {k: profiling.launches(k) for k in counters}


def _tile_work(tg, dirs, itemsize):
    """(bytes, operations) of ``len(dirs)`` K6 passes over every part: each
    input read once (the plane of every direction used, the off-tile
    entries and rows, b, x in) and x written once; per pass 2 * 128^2
    operations per tile (the two triangular products) and 2 per off-tile
    entry."""
    P = tg.pack.shape[0]
    n_dir = len(set(dirs))
    nnz_off = int((tg.cols >= 0).sum())
    nbytes = (P * n_dir * tg.n_real_tiles * 128 * 128 * itemsize + nnz_off * (itemsize + 4)
              + 4 * P * tg.rows.shape[1] + 3 * P * tg.Rp * itemsize)
    ops = len(dirs) * (P * tg.n_real_tiles * 2 * 128 * 128 + 2 * nnz_off)
    return nbytes, ops


def _hold_tile(results, where, tg, dtype_name, g, device, rtol=KERNEL_RTOL):
    """K6 against its plain version on one tile smoother: forward, backward
    and symmetric, from a zero and a nonzero guess, one launch per call;
    then the symmetric sweep from a nonzero guess (the post-smoothing)
    timed: CUDA events, device time (profiler), the plain version, the
    bound, the device time of a launch of no wave step and of one, and
    the device time with x read from L2 instead of shared memory."""
    import torch

    from partitionedarrays_tpu_torch.ops.tile_gs import tile_gs_sweeps, tile_gs_sweeps_plain
    from partitionedarrays_tpu_torch.utils import profiling

    dtype = getattr(torch, dtype_name)
    P = tg.pack.shape[0]  # one cluster per part
    b = torch.randn(P, tg.Rp, generator=g, dtype=dtype).to(device)
    x0 = torch.randn(P, tg.Rp, generator=g, dtype=dtype).to(device)
    worst = (0.0, 0.0)
    for dirs in (("f",), ("b",), ("f", "b")):
        for zero in (True, False):
            start = torch.zeros_like(x0) if zero else x0
            before = profiling.launches("tile_gs_sweeps")
            got = tile_gs_sweeps(*tg.operands(), start.clone(), b, dirs, zero_guess=zero,
                                 tile_lanes=tg.tile_lanes)
            n = profiling.launches("tile_gs_sweeps") - before
            if n != 1:
                raise AssertionError(f"tile_gs_sweeps {where}: {n} launches for one call")
            torch.cuda.synchronize()
            want = tile_gs_sweeps_plain(*tg.operands(), start.clone(), b, dirs, zero_guess=zero)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            if not rel <= rtol[dtype_name]:
                raise AssertionError(f"tile_gs_sweeps {where} {dtype_name} {dirs} zero={zero}: {rel}")
            worst = max(worst, (rel, err))
    x_t = x0.clone()

    def sweep(**kw):
        return lambda: tile_gs_sweeps(*tg.operands(), x_t, b, ("f", "b"), tile_lanes=tg.tile_lanes,
                                      **kw)

    work = _tile_work(tg, ("f", "b"), x0.element_size())
    b_ms, b_by = bound(*work, F32_FLOPS_PER_S if dtype_name == "float32" else F64_FLOPS_PER_S)
    dev_ms = device_ms(sweep(), 20)
    results.append({
        "kernel": "tile_gs_sweeps", "dtype": dtype_name, "where": where, "P": P,
        "tiles": tg.n_real_tiles, "W": tg.W, "B": tg.B, "K_off": tg.cols.shape[1],
        "launches_per_call": 1, "max_abs_err": worst[1], "max_rel_err": worst[0],
        "tol_rel": rtol[dtype_name],
        "ms": time_ms(sweep(), 20), "device_ms": dev_ms,
        "plain_ms": time_ms(lambda: tile_gs_sweeps_plain(*tg.operands(), x_t, b, ("f", "b")), 3),
        "library_ms": None, "bytes": work[0], "ops": work[1], "bound_ms": b_ms, "bound_by": b_by,
        # a launch of no wave step and of one beside the whole sequence
        "steps_device_ms": [[n, device_ms(sweep(_n_steps=n), 20)] for n in (0, 1)]
        + [[2 * tg.W, dev_ms]],
        "x_in_l2_device_ms": device_ms(sweep(_x_in_smem=False), 20),
    })


def _every_g(blk, x, y):
    """K5's time (L2 flushed before each call) on block ``blk`` under every
    warps-per-group count, accumulating into ``y``: [[G, ms], ...]."""
    from partitionedarrays_tpu_torch.ops.ell_rows import LANES_MAX
    from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv

    out = []
    G = 1
    while G <= LANES_MAX:
        plan = blk.plan._replace(lanes=G)
        out.append([G, flushed_ms(lambda: ghost_spmv(blk.rows, blk.cols, blk.vals, x, y, plan), 20)])
        G *= 2
    return out


def _hold_k5_blocks(results, where, blocks, dtype_name, g, device, rtol=KERNEL_RTOL):
    """K5 against its plain version on the compressed-row blocks ``blocks``
    ((name, DeviceBlock) pairs: the AMG path's P, P^T and coarse A),
    accumulating into y: the largest difference, the kernel's and the
    ``torch.sparse`` CSR ``addmv``'s times with the L2 flushed before each
    call, the device time, the bound (each live lane's value and column,
    x, and each live row of y read and written, once), the warps per group
    the rule picks, and the time under every count."""
    import torch

    from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv, ghost_spmv_plain

    dtype = getattr(torch, dtype_name)
    for name, blk in blocks:
        P, K, Nr = blk.cols.shape
        R, n_cols = blk.n_rows, blk.n_cols_pad
        x = torch.randn(P, n_cols, generator=g, dtype=dtype).to(device)
        y0 = torch.randn(P, R, generator=g, dtype=dtype).to(device)
        got = ghost_spmv(blk.rows, blk.cols, blk.vals, x, y0.clone(), blk.plan)
        torch.cuda.synchronize()
        want = ghost_spmv_plain(blk.rows, blk.cols, blk.vals, x, y0.clone())
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        tol = rtol[dtype_name] * scale
        if not err <= tol:
            raise AssertionError(f"ghost_spmv {name} of {where} {dtype_name}: {err} > {tol}")
        live = blk.cols >= 0
        nnz = int(live.sum())
        n_live = int((blk.rows >= 0).sum())
        part = torch.arange(P, device=device).view(P, 1, 1)
        lib = _library(_csr((part * R + blk.rows.unsqueeze(1)).expand(P, K, Nr)[live],
                            (part * n_cols + blk.cols)[live], blk.vals[live], (P * R, P * n_cols)),
                       x, y0)
        lib_err = (lib().reshape(want.shape) - want).abs().max().item()
        if not lib_err <= KERNEL_RTOL[dtype_name] * scale:
            raise AssertionError(f"ghost_spmv {name} of {where}: the library call differs by {lib_err}")
        itemsize = x.element_size()
        nbytes = itemsize * (nnz + P * n_cols + 2 * n_live) + 4 * (nnz + n_live)
        b_ms, b_by = bound(nbytes, 2 * nnz,
                           F32_FLOPS_PER_S if dtype_name == "float32" else F64_FLOPS_PER_S)
        y_t = y0.clone()
        kernel = lambda: ghost_spmv(blk.rows, blk.cols, blk.vals, x, y_t, blk.plan)  # noqa: E731
        results.append({
            "kernel": "ghost_spmv", "dtype": dtype_name, "where": f"{name} of {where}",
            "P": P, "rows": Nr, "K": K, "nnz": nnz, "mean_lanes": nnz / max(n_live, 1),
            "groups": blk.plan.group_lanes.numel(),
            "mean_group_lanes": blk.plan.group_lanes.double().mean().item(),
            "lanes": blk.plan.lanes, "max_abs_err": err, "max_rel_err": err / scale,
            "tol_rel": rtol[dtype_name],
            "ms_flushed": flushed_ms(kernel, 20), "device_ms": device_ms(kernel, 20),
            "plain_ms": time_ms(lambda: ghost_spmv_plain(blk.rows, blk.cols, blk.vals, x, y_t), 3),
            "library_ms_flushed": flushed_ms(lib, 20), "library_max_abs_err": lib_err,
            "bytes": nbytes, "ops": 2 * nnz, "bound_ms": b_ms, "bound_by": b_by,
            "every_g_ms_flushed": _every_g(blk, x, y_t),
        })


def _amg_blocks(M):
    """The compressed-row blocks K5 runs in the V-cycle: P_l and P_l^T of
    every level but the coarsest, and the operators A_l (0 < l) whose
    residual the cycle takes."""
    out = []
    for l, lev in enumerate(M.levels):
        if lev.P is None:
            continue
        if l > 0:
            out.append((f"A{l}", lev.A.device().oo))
        out += [(f"P{l}", lev.P.device().oo), (f"P{l}^T", lev.P.device_transpose()[0])]
    return [(n, b) for n, b in out if b.kind == "ell"]


def _aggregation_seconds(M) -> dict:
    """Host seconds of the aggregation of every coarsened level of the
    elasticity hierarchy ``M`` (``AMG_PARAMS``: block size 3 on the fine
    level, 6 nullspace modes below), by the native library (``aggregate``,
    the setup's) and by the Python version (``aggregate_plain``, the
    setup's until the native library was ported); the aggregates agree."""
    import numpy as np

    from partitionedarrays_tpu_torch.psparse import host_blocks
    from partitionedarrays_tpu_torch.solvers import amg

    out = {"native": 0.0, "python": 0.0}
    for l, lev in enumerate(M.levels[:-1]):
        G = amg.strength_graph(host_blocks(lev.A)[0]["oo"], AMG_PARAMS["block_size"] if l == 0
                               else 6)
        got = {}
        for name, fn in (("native", amg.aggregate), ("python", amg.aggregate_plain)):
            t0 = time.perf_counter()
            got[name] = fn(G, 0.0)
            out[name] += time.perf_counter() - t0
        if not np.array_equal(got["native"], got["python"]):
            raise AssertionError(f"level {l}: native and Python aggregates differ")
    return out


def phase_amg_elasticity(device, counters):
    """Elasticity SA-AMG through the port's entry points (``AMG_RUNS``).
    The launch counts of the solves (``counters`` set to 0 just before each
    solve and read just after) are returned as the path's; the kernel
    checks that follow are not counted.  Returns (launches, K6/K1 rows)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.gallery import (
        linear_elasticity_fem, node_coordinates_unit_cube, nullspace_linear_elasticity,
    )
    from partitionedarrays_tpu_torch.psparse import psparse, spmv, to_global_scipy
    from partitionedarrays_tpu_torch.pvector import pones
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
    from partitionedarrays_tpu_torch.solvers.gs_slot import NaturalTileGS
    from partitionedarrays_tpu_torch.solvers.krylov import cg

    out, failures, results = {}, [], []
    path_launches = {k: 0 for k in counters}
    g = torch.Generator().manual_seed(2024)
    for nodes, dtype, iter_range, limit in AMG_RUNS:
        key = f"{dtype}@{nodes[0]}^3"
        np_dtype = getattr(np, dtype)  # the scalar type, as the gallery takes
        t0 = time.perf_counter()
        I, J, V, rows, cols = linear_elasticity_fem(nodes, (1, 1, 1), dtype=np_dtype)
        A = psparse(I, J, V, rows, cols, SerialBackend(1), device=device)
        A.device()
        torch.cuda.synchronize()
        assembly = time.perf_counter() - t0
        del I, J, V
        coords, _ = node_coordinates_unit_cube(nodes, (1, 1, 1))
        ns = nullspace_linear_elasticity(coords)
        t0 = time.perf_counter()
        M = AMGPreconditioner(A, AMGParams(**AMG_PARAMS), nullspace=ns)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        b = spmv(A, pones(A.col_prange, A.backend, dtype=A.dtype, device=device))
        solves = []
        for _ in range(2):  # the second solve is warm
            (x, info), seconds, counts = _timed(
                counters, lambda: cg(A, b, M=M, rtol=AMG_RTOL, maxiter=AMG_MAXITER))
            for k, v in counts.items():
                path_launches[k] += v
            solves.append((seconds, info.iterations, counts))
        prof = None
        if nodes == AMG_KERNEL_NODES and dtype == "float32":
            out_agg = _aggregation_seconds(M)
        else:
            out_agg = None
        if nodes == AMG_KERNEL_NODES:  # where the device time of a solve goes
            prof = _profile_set(lambda: cg(A, b, M=M, rtol=AMG_RTOL, maxiter=AMG_MAXITER), top=8,
                                kernels=("gs_seq_grid", "tile_sweeps", "ghost_spmv"))
        G = to_global_scipy(A).astype(np.float64)
        n = A.shape[0]
        b64 = b.own[0, :n].double().cpu().numpy()
        x64 = x.own[0, :n].double().cpu().numpy()
        true_relres = float(np.linalg.norm(b64 - G @ x64) / np.linalg.norm(b64))
        iters = solves[-1][1]
        out[key] = {
            "rows": n, "nnz": A.nnz(), "assembly_s": assembly, "setup_s": setup,
            "levels": _level_info(M), "omegas": M.omegas, "iterations": iters,
            "cg_residual": float(info.residual), "true_relres": true_relres,
            "solve_s": [s[0] for s in solves], "launches_per_solve": solves[-1][2],
            "profiled_solve": prof, "aggregation_s": out_agg,
        }
        if out_agg is not None:
            # the setup as it was with the Python aggregation
            out[key]["setup_s_python_aggregation"] = (setup - out_agg["native"]
                                                      + out_agg["python"])
        emit(f"4d amg_elasticity {key}", out[key])
        if iter_range is not None and not iter_range[0] <= iters <= iter_range[1]:
            failures.append(f"{key}: {iters} CG iterations, not in {iter_range}")
        if iters >= AMG_MAXITER or not true_relres <= limit:
            failures.append(f"{key}: {iters} iterations, true relres {true_relres} > {limit}")
        if solves[-1][2]["tile_gs_sweeps"] <= 0:
            failures.append(f"{key}: K6 did not launch in the solve")
        if nodes == AMG_KERNEL_NODES:
            # K6 on every tile level, K5 on every compressed-row block, K1
            # on the 99-diagonal fine operator
            for l, lev in enumerate(M.levels):
                if lev.smoother is not None and lev.smoother.tile_gs is not None:
                    _hold_tile(results, f"level {l} of {nodes[0]}^3", lev.smoother.tile_gs,
                               dtype, g, device)
            _hold_k5_blocks(results, f"{nodes[0]}^3", _amg_blocks(M), dtype, g, device)
            oo = A.device().oo
            xs = torch.randn(1, oo.n_cols_pad, generator=g, dtype=A.dtype).to(device)
            _hold_k1(results, f"{len(oo.offsets)} diagonals, {nodes[0]}^3 elasticity", oo, xs)
            _hold_k3(results, f"level 0 of {nodes[0]}^3 elasticity", M.levels[0].smoother,
                     dtype, g, device)
        if any((nodes, dtype) == run[:2] for run in AMG_SCHWARZ_RUNS):
            SHARED_ELASTICITY[(nodes, dtype)] = (A, assembly)
        if nodes == SORTED_NODES:
            SHARED_AMG[(nodes, dtype)] = (M, b, {
                "iterations": iters, "true_relres": true_relres, "solve_s": out[key]["solve_s"],
                "levels": [lv.get("smoother") for lv in out[key]["levels"]]})
        del A, M, b, x, G
        torch.cuda.empty_cache()
    # K6 on the forced tile tier of the 20^3 block (its fine level is DIA)
    for dtype in ("float32", "float64"):
        I, J, V, rows, cols = linear_elasticity_fem(FORCED_TILE_NODES, (1, 1, 1), dtype=getattr(np, dtype))
        A = psparse(I, J, V, rows, cols, SerialBackend(1), device=device)
        _hold_tile(results, f"forced, {FORCED_TILE_NODES[0]}^3 fine level", NaturalTileGS.build(A),
                   dtype, g, device)
        del A
    emit("4d kernels K6, K5, K1, K3", results)
    if failures:
        raise AssertionError("; ".join(failures))
    return path_launches, results


def _sorted_k5_row(where, dtype_name, rows, launches):
    """One row for K5 on the sorted tier's color slices: the sums over the
    colors of ``_hold_k5_blocks``' rows (flushed ms, device ms, plain ms,
    bytes, operations, bound, the ``torch.sparse`` call), its largest
    difference, and the launches of a sweep."""
    tot = lambda k: sum(r[k] for r in rows if r.get(k) is not None)  # noqa: E731
    return {
        "kernel": "ghost_spmv", "dtype": dtype_name, "where": where, "blocks": len(rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_rel_err": max(r["max_rel_err"] for r in rows), "tol_rel": rows[0]["tol_rel"],
        "ms_flushed": tot("ms_flushed"), "device_ms": tot("device_ms"), "plain_ms": tot("plain_ms"),
        "library_ms_flushed": tot("library_ms_flushed"), "bytes": tot("bytes"),
        "ops": tot("ops"), "bound_ms": tot("bound_ms"), "bound_by": "bytes",
        "nnz": tot("nnz"), "launches_per_sweep": launches,
    }


def phase_sorted_gs(device, counters):
    """The sorted-by-color tier (``SORTED_NODES``) on phase 4d's 40^3
    elasticity operators, float32 and float64: the host build of the tier
    on the fine level (colors, the rows' ELL planes, K5's operands), a
    symmetric sweep's K5 launches (counters set to 0 just before it), the
    sweep against the plain tier-2 sweep (``ell_spmv``) on the card, its
    time (CUDA events) and device time, K5 on every color slice against its
    plain version; then phase 4d's hierarchy with its tile-tier level
    smoothers on the sorted tier under the AMG-CG to ``AMG_RTOL`` (cold and
    warm, launches counted), beside phase 4d's run.  Returns (the path's
    launches, kernel rows)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.psparse import to_global_scipy
    from partitionedarrays_tpu_torch.pvector import PVector, _own_mask
    from partitionedarrays_tpu_torch.solvers.krylov import cg
    from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

    failures, results = [], []
    path_launches = {k: 0 for k in counters}
    g = torch.Generator().manual_seed(4242)
    limits = {dtype: limit for nodes, dtype, _, limit in AMG_RUNS if nodes == SORTED_NODES}
    for dtype in ("float32", "float64"):
        M, b, rec4d = SHARED_AMG.pop((SORTED_NODES, dtype))
        key = f"{dtype}@{SORTED_NODES[0]}^3"
        A = M.levels[0].A
        t0 = time.perf_counter()
        gs = GaussSeidel(A, 1, "symmetric", _sorted=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        st = gs.sorted
        own = torch.randn(b.own.shape, generator=g, dtype=A.dtype).to(device)
        r = PVector(torch.where(_own_mask(b.layout, device, b.backend), own, 0),
                    torch.zeros_like(b.ghost), b.layout, b.backend)
        (z, _, counts) = _timed(counters, lambda: gs(r))
        torch.cuda.synchronize()
        plain = gs._apply_sorted(PVector(torch.zeros_like(r.own), r.ghost, r.layout, r.backend),
                                 r, plain=True)
        err = (z.own - plain.own).abs().max().item()
        rel = err / plain.own.abs().max().item()
        if not rel <= KERNEL_RTOL[dtype]:
            failures.append(f"{key}: the sorted sweep differs from the plain sweep by {rel}")
        expected = 2 * sum(1 for blk in st.blocks if blk[0] is not None)
        if counts["ghost_spmv"] != expected or counts["tile_gs_sweeps"] or counts["gs_sweeps"]:
            failures.append(f"{key}: a sweep launched {counts}, not K5 {expected} times")
        sweep = {
            "rows": A.shape[0], "colors": gs.n_colors, "build_s": build_s,
            "rows_per_color": [int((t[0] < st.n_own_pad).sum()) for t in st.tabs],
            "launches_per_sweep": counts, "vs_plain_max_abs_err": err, "vs_plain_max_rel_err": rel,
            "ms": time_ms(lambda: gs(r), 10),
            "plain_ms": time_ms(lambda: gs._apply_sorted(r, r, plain=True), 3),
            "profiled_sweep": _profile_set(lambda: gs(r), top=4, kernels=("ghost_spmv",)),
        }
        color_rows = []
        _hold_k5_blocks(color_rows, f"tier-2 color slices of level 0, {key}",
                        [(f"color {c}", blk[0]) for c, blk in enumerate(st.blocks)
                         if blk[0] is not None], dtype, g, device)
        for row in color_rows:
            row.pop("every_g_ms_flushed", None)
        results.append(_sorted_k5_row(f"tier-2 color slices of level 0, {key}", dtype, color_rows,
                                      expected))
        del gs, st, z, plain
        # the hierarchy with its tile-tier level smoothers on the sorted tier
        swapped = []
        for l, lev in enumerate(M.levels):
            if lev.smoother is not None and lev.smoother.tile_gs is not None:
                lev.smoother = GaussSeidel(lev.A, lev.smoother.iterations, "symmetric",
                                           _sorted=True)
                swapped.append(l)
        solves = []
        for _ in range(2):  # the second solve is warm
            (x, info), seconds, counts = _timed(
                counters, lambda: cg(A, b, M=M, rtol=AMG_RTOL, maxiter=AMG_MAXITER))
            for k, v in counts.items():
                path_launches[k] += v
            solves.append((seconds, int(info.iterations), counts))
        G = to_global_scipy(A).astype(np.float64)
        n = A.shape[0]
        b64 = b.own[0, :n].double().cpu().numpy()
        x64 = x.own[0, :n].double().cpu().numpy()
        true_relres = float(np.linalg.norm(b64 - G @ x64) / np.linalg.norm(b64))
        amg_rec = {
            "sorted_levels": swapped, "colors": {l: M.levels[l].smoother.n_colors for l in swapped},
            "iterations": solves[-1][1], "true_relres": true_relres,
            "solve_s": [s_[0] for s_ in solves], "launches_per_solve": solves[-1][2],
            "tile_tier_4d": rec4d,
        }
        emit(f"4n sorted_gs {key}", {"fine_level_sweep": sweep, "amg_cg_sorted_levels": amg_rec})
        if not swapped:
            failures.append(f"{key}: no tile-tier level to put on the sorted tier")
        if solves[-1][2]["tile_gs_sweeps"]:
            failures.append(f"{key}: K6 launched in the sorted-tier AMG-CG")
        if solves[-1][1] >= AMG_MAXITER or not true_relres <= limits[dtype]:
            failures.append(f"{key}: AMG-CG on the sorted tier: {solves[-1][1]} iterations, "
                            f"true relres {true_relres} > {limits[dtype]}")
        del M, b, A, x, G
        torch.cuda.empty_cache()
    emit("4n kernels K5 on the tier-2 color slices", results)
    if failures:
        raise AssertionError("; ".join(failures))
    return path_launches, results


def _hold_box_levels(results, where, M, g, device, vcycle_launches, rtol=KERNEL_RTOL):
    """K3 (``_hold_k3``) and K4 (``_hold_k4``) against their plain versions,
    to ``rtol``, on every smoothed level of the box AMG ``M``, in its dtype;
    each smoothed level of the flat cycle launches the same number of each
    per V-cycle (``vcycle_launches``)."""
    import torch

    smoothed = [(l, lev) for l, lev in enumerate(M.levels) if lev.smoother is not None]
    for l, lev in smoothed:
        col = lev.smoother.colored
        dtype_name = str(col.vals_d.dtype).replace("torch.", "")
        at = f"level {l} of {where} ({lev.A.shape[0]} rows)"
        _hold_k3(results, at, lev.smoother, dtype_name, g, device, rtol)
        for row in results[-2:]:
            row["launches_per_vcycle"] = vcycle_launches["gs_sweeps"] / len(smoothed)
        x = torch.randn(col.vals_d.shape[0], col.m, col.Lq, generator=g,
                        dtype=col.vals_d.dtype).to(device)
        _hold_k4(results, at, col, x, rtol=rtol)
        results[-1]["launches_per_vcycle"] = vcycle_launches["ax_core"] / len(smoothed)


def phase_amg_box(device, counters):
    """The box-stencil SA-AMG through the port's entry points: the 64^3
    ``laplacian_fdm`` AMG-CG in float32 and float64 (``BOX_RUNS``) and the
    48^3 ``cg_df64`` preconditioned by the AMG of the float32 copy.  The
    launch counts of the solves (counters set to 0 just before each solve
    and read just after) are returned as the two paths'; the kernel checks
    that follow are not counted: K3 and K4 on every colored level of each
    hierarchy (``_hold_box_levels``), K1 on the 64^3 operator, K7 on the
    48^3 one.  Returns (launches of amg_box, of amg_box_df64, kernel
    rows)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.gallery import laplacian_fdm
    from partitionedarrays_tpu_torch.ops import df64 as df
    from partitionedarrays_tpu_torch.psparse import psparse, spmv, to_global_scipy
    from partitionedarrays_tpu_torch.pvector import PVector, pvector_df64, pvector_from_own
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
    from partitionedarrays_tpu_torch.solvers.krylov import cg, cg_df64

    out, failures, results = {}, [], []
    box_launches = {k: 0 for k in counters}
    g = torch.Generator().manual_seed(4242)
    for dtype, iter_range, limit in BOX_RUNS:
        key = f"{dtype}@{BOX_NODES[0]}^3"
        t0 = time.perf_counter()
        I, J, V, rows, cols = laplacian_fdm(BOX_NODES, (1, 1, 1), dtype=getattr(np, dtype))
        A = psparse(I, J, V, rows, cols, SerialBackend(1), device=device)
        A.device()
        torch.cuda.synchronize()
        assembly = time.perf_counter() - t0
        t0 = time.perf_counter()
        M = AMGPreconditioner(A, AMGParams(**BOX_PARAMS))
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        n = A.shape[0]
        own = np.zeros(n, dtype=getattr(np, dtype))
        own[:10] = 1.0
        b = pvector_from_own([own], A.row_prange, A.backend, device=device)
        solves = []
        for _ in range(2):  # cold, then warm
            (x, info), seconds, counts = _timed(
                counters, lambda: cg(A, b, M=M, rtol=BOX_RTOL, maxiter=BOX_MAXITER))
            for k, v in counts.items():
                box_launches[k] += v
            solves.append((seconds, info.iterations, counts))
        _, vcycle_s, vcycle_launches = _timed(counters, lambda: M(b))
        prof = _profile_set(lambda: cg(A, b, M=M, rtol=BOX_RTOL, maxiter=BOX_MAXITER), top=8,
                            kernels=("gs_seq_grid", "ax_core", "dia_spmv_kernel"))
        G = to_global_scipy(A).astype(np.float64)
        x64 = x.own[0, :n].double().cpu().numpy()
        true_relres = float(np.linalg.norm(own - G @ x64) / np.linalg.norm(own))
        iters = solves[-1][1]
        out[key] = {
            "rows": n, "nnz": A.nnz(), "assembly_s": assembly, "setup_s": setup,
            "levels": _level_info(M), "omegas": M.omegas, "iterations": iters,
            "cg_residual": float(info.residual), "true_relres": true_relres,
            "solve_s": {"cold": solves[0][0], "warm": solves[1][0]},
            "launches_per_solve": solves[-1][2],
            "vcycle_s": vcycle_s, "launches_per_vcycle": vcycle_launches,
            "profiled_solve": prof,
        }
        emit(f"4e amg_box {key}", out[key])
        if iter_range is not None and not iter_range[0] <= iters <= iter_range[1]:
            failures.append(f"{key}: {iters} CG iterations, not in {iter_range}")
        if iters >= BOX_MAXITER or not true_relres <= limit:
            failures.append(f"{key}: {iters} iterations, true relres {true_relres} > {limit}")
        if not all(lev.get("flat") for lev in out[key]["levels"][:-1]):
            failures.append(f"{key}: a level did not take the flat cycle")
        # K3 and K4 on every colored level; K1 on the 7-point operator of
        # CG's A p
        _hold_box_levels(results, f"{BOX_NODES[0]}^3 box AMG", M, g, device, vcycle_launches)
        oo = A.device().oo
        xs = torch.randn(1, oo.n_cols_pad, generator=g, dtype=A.dtype).to(device)
        _hold_k1(results, f"{len(oo.offsets)} diagonals, {BOX_NODES[0]}^3 laplacian_fdm", oo, xs)
        results[-1]["launches_per_solve"] = solves[-1][2]["dia_spmv"]
        del A, M, b, x, G, oo, xs
        torch.cuda.empty_cache()

    # the df64 solve with the AMG of the float32 copy
    df64_launches = {k: 0 for k in counters}
    key = f"df64@{BOX_DF64_NODES[0]}^3"
    t0 = time.perf_counter()
    I, J, V, rows, cols = laplacian_fdm(BOX_DF64_NODES, (1, 1, 1))
    A = psparse(I, J, V, rows, cols, SerialBackend(1), device=device)
    G = to_global_scipy(A)
    xg = np.random.default_rng(7).standard_normal(A.shape[0])
    bg = G @ xg
    b = pvector_df64([bg], A.row_prange, A.backend, device=device)
    torch.cuda.synchronize()
    assembly = time.perf_counter() - t0
    t0 = time.perf_counter()
    M = AMGPreconditioner(A.astype(np.float32), AMGParams(**BOX_PARAMS))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    solves = []
    for _ in range(2):
        (xp, info), seconds, counts = _timed(
            counters, lambda: cg_df64(A, b, M=M, rtol=BOX_DF64_RTOL, maxiter=BOX_DF64_MAXITER))
        for k, v in counts.items():
            df64_launches[k] += v
        solves.append((seconds, info.iterations, counts))
    x64 = df.to_f64(xp[0].own, xp[1].own)
    xv = PVector(x64, x64.new_zeros((1, A.row_layout().n_ghost_pad)), A.row_layout(), A.backend)
    b64 = df.to_f64(b[0].own, b[1].own)
    true_relres = (torch.linalg.vector_norm(b64 - spmv(A, xv).own)
                   / torch.linalg.vector_norm(b64)).item()
    host_relres = float(np.linalg.norm(G @ x64[0, : A.shape[0]].cpu().numpy() - bg)
                        / np.linalg.norm(bg))
    iters = solves[-1][1]
    out[key] = {
        "rows": A.shape[0], "assembly_s": assembly, "setup_s": setup,
        "levels": _level_info(M), "level_dtypes": [str(lev.A.dtype) for lev in M.levels],
        "iterations": iters, "true_relres": true_relres, "host_relres": host_relres,
        "solve_s": {"cold": solves[0][0], "warm": solves[1][0]},
        "launches_per_solve": solves[-1][2],
    }
    emit(f"4e amg_box {key}", out[key])
    if not BOX_DF64_ITERS[0] <= iters <= BOX_DF64_ITERS[1]:
        failures.append(f"{key}: {iters} iterations, not in {BOX_DF64_ITERS}")
    if not (true_relres <= BOX_DF64_TRUE_RELRES and host_relres <= BOX_DF64_TRUE_RELRES):
        failures.append(f"{key}: true relres {true_relres} / {host_relres} > {BOX_DF64_TRUE_RELRES}")
    if any(lev.A.dtype != torch.float32 for lev in M.levels):
        failures.append(f"{key}: the AMG of the float32 copy froze a level in another dtype")
    # K3 and K4 on every float32 level of the preconditioner; K7 on the
    # (hi, lo) split of the 7-point operator of cg_df64's A p
    r32 = pvector_from_own([bg.astype(np.float32)], A.row_prange, A.backend, device=device)
    _, _, vcycle_launches = _timed(counters, lambda: M(r32))
    _hold_box_levels(results, f"{BOX_DF64_NODES[0]}^3 box AMG of the float32 copy", M, g, device,
                     vcycle_launches)
    _hold_k7(results, f"7 diagonals, {BOX_DF64_NODES[0]}^3 laplacian_fdm", A.device().oo, g, device)
    results[-1]["launches_per_solve"] = solves[-1][2]["dia_spmv_df"]
    del A, M, b, xp, x64, xv, G, r32
    torch.cuda.empty_cache()
    emit("4e kernels K3, K4, K1, K7 on the box paths", results)
    if failures:
        raise AssertionError("; ".join(failures))
    return box_launches, df64_launches, results


def _parts_blocks(M):
    """The compressed-row blocks K5 runs in the V-cycle of a hierarchy
    across parts: the own-ghost block of every level's operator (the
    smoother's ghost contribution, the residual), P_l and its own-ghost
    block, their transposes (the restriction: the own-ghost one assembled
    back to the owners), and the coarse operators A_l (0 < l)."""
    out = []
    for l, lev in enumerate(M.levels):
        out.append((f"A{l} own-ghost", lev.A.device().oh))
        if l > 0:
            out.append((f"A{l}", lev.A.device().oo))
        if lev.P is not None and lev.struct is None:
            ooT, ohT = lev.P.device_transpose()
            out += [(f"P{l}", lev.P.device().oo), (f"P{l} own-ghost", lev.P.device().oh),
                    (f"P{l}^T", ooT), (f"P{l}^T own-ghost", ohT)]
    return [(n, b) for n, b in out if b is not None and b.kind == "ell"]


def _hold_parts_levels(results, where, M, dtype, g, device):
    """K3 on every colored level, K6 with P = 8 on every tile level, K5 on
    every compressed-row block of the V-cycle (``_parts_blocks``) and K1 on
    the fine own-own block where it is DIA, each against its plain
    version."""
    import torch

    for l, lev in enumerate(M.levels):
        gs = lev.smoother
        if gs is None:
            continue
        at = f"level {l} of {where} ({lev.A.shape[0]} rows)"
        if gs.tile_gs is not None:
            _hold_tile(results, at, gs.tile_gs, dtype, g, device)
        else:
            _hold_k3(results, at, gs, dtype, g, device)
    _hold_k5_blocks(results, where, _parts_blocks(M), dtype, g, device)
    oo = M.levels[0].A.device().oo
    if oo.kind != "dia":
        return
    P = oo.vals.shape[0]
    xs = torch.randn(P, oo.n_cols_pad, generator=g, dtype=oo.vals.dtype).to(device)
    _hold_k1(results, f"{len(oo.offsets)} diagonals, fine level of {where}", oo, xs,
             library=_library(_csr(*_dia_triplets(oo.offsets, oo.vals, oo.n_cols_pad, oo.n_rows),
                                   (P * oo.n_rows, P * oo.n_cols_pad)), xs))


def _amg_parts_run(device, counters, key, make, check, phase="4f"):
    """One AMG path across parts: assembly (``make``: the matrix, the
    preconditioner builder and the rhs), setup, a cold and a warm solve,
    a V-cycle's launches and exchanges, a profiled warm solve and the true
    float64 residual, emitted under ``phase``; returns (the run's record,
    its solves' launches, A, M, b, x)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.psparse import to_global_scipy
    from partitionedarrays_tpu_torch.pvector import collect
    from partitionedarrays_tpu_torch.solvers.krylov import cg
    from partitionedarrays_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    A, build_M, b = make()
    A.device()
    torch.cuda.synchronize()
    assembly = time.perf_counter() - t0
    t0 = time.perf_counter()
    M = build_M(A)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    launches = {k: 0 for k in counters}
    solves = []
    for _ in range(2):  # cold, then warm
        (x, info), seconds, counts = _timed(counters, lambda: cg(A, b, M=M, rtol=AMG_RTOL,
                                                               maxiter=AMG_MAXITER))
        for k, v in counts.items():
            launches[k] += v
        solves.append((seconds, info.iterations, counts))
    _, vcycle_s, vcycle_launches = _timed(counters, lambda: M(b))
    # the V-cycle's exchanges with at least one round, by direction: "set"
    # (consistent) and "add" (assemble), and the bytes each sent
    exchanges = {c: profiling.COUNTS[f"exchanges.{c}"] for c in ("set", "add")}
    exchange_bytes = {c: profiling.COUNTS[f"exchange_bytes.{c}"] for c in ("set", "add")}
    prof = None
    if A.dtype == torch.float32:
        prof = _profile_set(lambda: cg(A, b, M=M, rtol=AMG_RTOL, maxiter=AMG_MAXITER), top=10,
                            kernels=("gs_seq_grid", "tile_sweeps", "ghost_spmv", "ax_core",
                                     "dia_spmv_kernel"))
    G = to_global_scipy(A).astype(np.float64)
    bg, xg = collect(b).astype(np.float64), collect(x).astype(np.float64)
    true_relres = float(np.linalg.norm(bg - G @ xg) / np.linalg.norm(bg))
    rec = {
        "rows": A.shape[0], "nnz": A.nnz(), "parts": A.row_prange.n_parts,
        "rows_per_part": [li.n_own for li in A.row_prange.parts],
        "assembly_s": assembly, "setup_s": setup, "levels": _level_info(M), "omegas": M.omegas,
        "iterations": solves[-1][1], "cg_residual": float(info.residual),
        "true_relres": true_relres,
        "solve_s": {"cold": solves[0][0], "warm": solves[1][0]},
        "launches_per_solve": solves[-1][2], "vcycle_s": vcycle_s,
        "launches_per_vcycle": vcycle_launches, "exchanges_per_vcycle": exchanges,
        "exchange_bytes_per_vcycle": exchange_bytes,
        "profiled_solve": prof,
    }
    emit(f"{phase} {key}", rec)
    check(rec)
    return rec, launches, A, M, b, x


def phase_amg_parts(device, counters):
    """The two AMG paths across (2,2,2) parts (``AMG_PARTS_RUNS``,
    ``BOX_PARTS_RUNS``) through the port's entry points, at full size:
    host seconds of assembly and setup, the hierarchy (rows, nnz, smoother
    tier), iterations against the JAX package's, the true float64
    residual, cold and warm solve seconds, the launches of a solve and of
    a V-cycle, the exchanges of a V-cycle and a profiled warm float32
    solve.  The launch counts of the solves are the paths'; the kernel
    checks that follow are not counted: K1 on both fine own-own blocks, K3
    (and K4 on the box levels) on every colored level, K5 on every
    compressed-row block with the own-ghost transposes, K6 with P = 8 on
    every tile level.  Returns (launches of amg_elasticity_parts, of
    amg_box_parts, kernel rows)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.gallery import (
        laplacian_fdm, linear_elasticity_fem, node_coordinates_unit_cube,
        nullspace_linear_elasticity,
    )
    from partitionedarrays_tpu_torch.psparse import psparse, spmv
    from partitionedarrays_tpu_torch.pvector import pones, pvector_from_own
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner

    P = int(np.prod(AMG_PARTS))
    failures, results = [], []
    path_launches = {"amg_elasticity_parts": {k: 0 for k in counters},
                     "amg_box_parts": {k: 0 for k in counters}}
    g = torch.Generator().manual_seed(4343)

    def within(key, iters_range, limit):
        def check(rec):
            lo, hi = iters_range
            if not lo <= rec["iterations"] <= hi:
                failures.append(f"{key}: {rec['iterations']} CG iterations, not in {iters_range}")
            if not rec["true_relres"] <= limit:
                failures.append(f"{key}: true relres {rec['true_relres']} > {limit}")
        return check

    for dtype, iters_range, limit in AMG_PARTS_RUNS:
        key = f"amg_elasticity_parts {dtype}@{AMG_PARTS_NODES[0]}^3 on {AMG_PARTS}"

        def make(dtype=dtype):
            I, J, V, rows, cols = linear_elasticity_fem(AMG_PARTS_NODES, AMG_PARTS,
                                                        dtype=getattr(np, dtype))
            A = psparse(I, J, V, rows, cols, SerialBackend(P), device=device)
            coords, _ = node_coordinates_unit_cube(AMG_PARTS_NODES, AMG_PARTS)
            ns = nullspace_linear_elasticity(coords, A.row_prange)
            b = spmv(A, pones(A.col_prange, A.backend, dtype=A.dtype, device=device))
            return A, lambda A: AMGPreconditioner(A, AMGParams(**AMG_PARAMS), nullspace=ns), b

        rec, launches, A, M, b, x = _amg_parts_run(device, counters, key, make,
                                                   within(key, iters_range, limit))
        for k, v in launches.items():
            path_launches["amg_elasticity_parts"][k] += v
        if rec["launches_per_solve"]["tile_gs_sweeps"] <= 0:
            failures.append(f"{key}: K6 did not launch in the solve")
        _hold_parts_levels(results, f"{AMG_PARTS_NODES[0]}^3 elasticity on {AMG_PARTS}", M,
                           dtype, g, device)
        if results[-1]["kernel"] == "dia_spmv":
            results[-1]["launches_per_solve"] = rec["launches_per_solve"]["dia_spmv"]
        del A, M, b, x
        torch.cuda.empty_cache()

    for dtype, iters_range, limit in BOX_PARTS_RUNS:
        key = f"amg_box_parts {dtype}@{BOX_PARTS_NODES[0]}^3 on {AMG_PARTS}"

        def make(dtype=dtype):
            I, J, V, rows, cols = laplacian_fdm(BOX_PARTS_NODES, AMG_PARTS, dtype=getattr(np, dtype))
            A = psparse(I, J, V, rows, cols, SerialBackend(P), assembled=True, device=device)
            own = [np.zeros(li.n_own, dtype=getattr(np, dtype)) for li in A.row_prange.parts]
            own[0][:10] = 1.0
            b = pvector_from_own(own, A.row_prange, A.backend, device=device)
            return A, lambda A: AMGPreconditioner(A, AMGParams(**BOX_PARAMS)), b

        rec, launches, A, M, b, x = _amg_parts_run(device, counters, key, make,
                                                   within(key, iters_range, limit))
        for k, v in launches.items():
            path_launches["amg_box_parts"][k] += v
        smoothed = [lev for lev in M.levels if lev.smoother is not None]
        if not all(lev.struct is not None and lev.smoother.colored is not None
                   and not lev.smoother.flat_viable() for lev in smoothed):
            failures.append(f"{key}: a level did not take the ghosted flat cycle")
        where = f"{BOX_PARTS_NODES[0]}^3 box AMG on {AMG_PARTS}"
        _hold_box_levels(results, where, M, g, device, rec["launches_per_vcycle"])
        _hold_k5_blocks(results, where, _parts_blocks(M), dtype, g, device)
        oo = A.device().oo
        xs = torch.randn(P, oo.n_cols_pad, generator=g, dtype=A.dtype).to(device)
        _hold_k1(results, f"{len(oo.offsets)} diagonals, fine level of {where}", oo, xs,
                 library=_library(_csr(*_dia_triplets(oo.offsets, oo.vals, oo.n_cols_pad,
                                                      oo.n_rows),
                                       (P * oo.n_rows, P * oo.n_cols_pad)), xs))
        results[-1]["launches_per_solve"] = rec["launches_per_solve"]["dia_spmv"]
        del A, M, b, x, oo
        torch.cuda.empty_cache()
    emit("4f kernels K1, K3, K4, K5, K6 on the paths across parts", results)
    if failures:
        raise AssertionError("; ".join(failures))
    return path_launches["amg_elasticity_parts"], path_launches["amg_box_parts"], results


# -- phase 4j: the partition, vector and matrix utilities ------------------------

def phase_partition_utilities(device, counters):
    """The two paths of ``UNEQUAL_RUNS`` through the port's entry points:
    ``amg_unequal_parts`` (``plaplacian_fdm`` on part boxes of unequal
    shape, the AMG-CG) and ``repartitioned`` (``repartition_system`` onto
    contiguous blocks of ids, the AMG-CG again, ``repartition`` of the
    solution back), in float32 and float64, with ``_amg_parts_run``'s
    record (host seconds of assembly, here of the repartition, and setup,
    the hierarchy, iterations against the JAX package's, the true float64
    residual, cold and warm solve seconds, the launches of a solve and of a
    V-cycle).  The repartitioned matrix and rhs are held equal to the
    originals; the kernel checks that follow are not counted: K1 on both
    fine own-own blocks (the 13-offset union, the slab DIA), K3 on every
    colored level, K5 on every compressed-row block, K6 with P = 8 on
    every tile level.  Returns (launches of amg_unequal_parts, of
    repartitioned, kernel rows)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch import (
        PRange, SerialBackend, local_range, plaplacian_fdm, repartition, repartition_system,
        to_global_scipy, variable_partition,
    )
    from partitionedarrays_tpu_torch.pvector import collect, pvector_from_own
    from partitionedarrays_tpu_torch.solvers.amg import (
        AMGParams, AMGPreconditioner, box_aggregate_psparse,
    )

    P = int(np.prod(AMG_PARTS))
    failures, results = [], []
    path_launches = {"amg_unequal_parts": {k: 0 for k in counters},
                     "repartitioned": {k: 0 for k in counters}}
    g = torch.Generator().manual_seed(4747)

    def within(key, iterations, limit):
        def check(rec):
            if rec["iterations"] != iterations:
                failures.append(f"{key}: {rec['iterations']} CG iterations, not {iterations}")
            if not rec["true_relres"] <= limit:
                failures.append(f"{key}: true relres {rec['true_relres']} > {limit}")
        return check

    def amg(A):
        return AMGPreconditioner(A, AMGParams(**BOX_PARAMS))

    for dtype, iters, iters_rep, limit in UNEQUAL_RUNS:
        key = f"amg_unequal_parts {dtype}@{UNEQUAL_NODES[0]}^3 on {AMG_PARTS}"

        def make(dtype=dtype):
            A = plaplacian_fdm(UNEQUAL_NODES, AMG_PARTS, SerialBackend(P),
                               dtype=getattr(np, dtype), device=device)
            own = [np.zeros(li.n_own, dtype=getattr(np, dtype)) for li in A.row_prange.parts]
            own[0][:10] = 1.0
            return A, amg, pvector_from_own(own, A.row_prange, A.backend, device=device)

        rec, launches, A, M, b, x = _amg_parts_run(device, counters, key, make,
                                                   within(key, iters, limit), phase="4j")
        for k, v in launches.items():
            path_launches["amg_unequal_parts"][k] += v
        oo = A.device().oo
        shapes = {tuple(li.shape) for li in A.row_prange.parts}
        if len(shapes) != 8 or len(oo.offsets) != 13 or box_aggregate_psparse(A) is not None:
            failures.append(f"{key}: {len(shapes)} box shapes, {len(oo.offsets)} offsets, "
                            "or the box aggregation did not decline")
        where = f"{UNEQUAL_NODES[0]}^3 on unequal boxes {AMG_PARTS}"
        _hold_parts_levels(results, where, M, dtype, g, device)
        results[-1]["launches_per_solve"] = rec["launches_per_solve"]["dia_spmv"]

        key = f"repartitioned {dtype}@{UNEQUAL_NODES[0]}^3 onto {P} blocks"
        N = A.shape[0]
        new_rows = PRange(variable_partition([len(local_range(p, P, N)) for p in range(P)]))

        def make_rep(A=A, b=b, new_rows=new_rows, key=key):
            A2, b2 = repartition_system(A, b, new_rows)
            if (to_global_scipy(A2) != to_global_scipy(A)).nnz or not np.array_equal(
                    collect(b2), collect(b)):
                failures.append(f"{key}: the repartitioned system differs from the original")
            return A2, amg, b2

        rec2, launches, A2, M2, b2, x2 = _amg_parts_run(device, counters, key, make_rep,
                                                        within(key, iters_rep, limit), phase="4j")
        for k, v in launches.items():
            path_launches["repartitioned"][k] += v
        back = repartition(x2, A.row_prange)
        G = to_global_scipy(A).astype(np.float64)
        bg = collect(b).astype(np.float64)
        diff = collect(back).astype(np.float64) - collect(x).astype(np.float64)
        agree = float(np.linalg.norm(G @ diff) / np.linalg.norm(bg))
        xmax = float(np.abs(collect(x)).max())
        emit(f"4j {key} against amg_unequal_parts", {
            "residual_of_difference": agree, "limit": 2 * limit,
            "max_abs_difference": float(np.abs(diff).max()), "max_abs_x": xmax,
            "repartition_back_s": _timed(counters, lambda: repartition(x2, A.row_prange))[1],
        })
        if not agree <= 2 * limit:
            failures.append(f"{key}: solution moved back differs by {agree} > {2 * limit}")
        where = f"{UNEQUAL_NODES[0]}^3 repartitioned onto {P} blocks"
        _hold_parts_levels(results, where, M2, dtype, g, device)
        results[-1]["launches_per_solve"] = rec2["launches_per_solve"]["dia_spmv"]
        del A, M, b, x, A2, M2, b2, x2, oo, back
        torch.cuda.empty_cache()
    emit("4j kernels K1, K3, K5, K6 on the unequal boxes and the repartition", results)
    if failures:
        raise AssertionError("; ".join(failures))
    return path_launches["amg_unequal_parts"], path_launches["repartitioned"], results


# -- phase 4k: float16 preconditioner values and the remaining layers ---------------


def _hpcg_sets(mg):
    """The float32 set's profile of ``mg`` (``_profile_set``) and its
    history (``hpcg_cg_flat``, ITERATIONS)."""
    from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat

    def one_set():
        return hpcg_cg_flat(mg, mg.b, iterations=ITERATIONS)

    profile = _profile_set(one_set, top=8, kernels=("gs_seq", "ax_core"))
    return profile, one_set()[1]


def phase_hpcg_float16(device, counters):
    """``hpcg_float16``: the benchmark with ``precond_dtype="float16"``
    through ``hpcg_benchmark`` (``F16_RUNS``: 128^3 float32 and 64^3
    float64 on one part), the launch counts set to 0 just before each
    benchmark and read just after; in that window also the standalone
    sweep (K2 per color) against K3 on the float16 values of the fine
    level.  Beside each: profiled sets of the float16-, bfloat16- and
    full-valued MGs (not counted), whose histories must equal each other
    (HPCG's 26 and -1 are exact in both narrow types).  Then K2, K3 and K4
    with random float16 values against their plain versions, beside the
    bfloat16 instance on the same operator, and on HPCG's own values
    against the full-value kernels (``_narrow_on_hpcg``).  Returns (the
    path's launches, kernel rows)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.driver import cg_route, hpcg_benchmark
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
    from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem

    launches = {k: 0 for k in counters}
    failures, results = [], []
    g = torch.Generator().manual_seed(1616)
    for shape, vectors, limit in F16_RUNS:
        key = f"{vectors}@{shape[0]}^3 float16 values"
        dtype = getattr(np, vectors)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mg = HPCGMGPreconditioner(shape, (1, 1, 1), SerialBackend(1), n_levels=LEVELS,
                                  dtype=dtype, precond_dtype="float16", device=device)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0

        def run(mg=mg, setup=setup, shape=shape):
            report = hpcg_benchmark(
                None, local_shape=shape, parts_per_dir=(1, 1, 1), n_levels=LEVELS,
                iterations=ITERATIONS, ref_sets=1, timed_sets=3, mg=mg, setup_time=setup,
                device=device,
            )
            gs, col = mg.gss[-1], mg.gss[-1].colored  # the fine level
            x = torch.randn(1, col.m, col.Lq, generator=g, dtype=mg.A.dtype).to(device)
            bd = gs.make_bd(mg.b)
            order = gs._order_seq()
            via_k2 = col.sweep_flat(x.clone(), bd, col.vals_d, col.invd_d, order)
            via_k3 = col.sweeps_core(x, bd, col.vals_d, col.invd_d, order)
            return report, ((via_k2 - via_k3).abs().max() / via_k3.abs().max()).item()

        (report, sweep_err), _, counts = _timed(counters, run)
        for k, v in counts.items():
            launches[k] += v
        s = report.summary()
        gf = report.gflops()
        rec = {
            "cg_route": cg_route(mg, None), "precond_values_dtype": s["precond_values_dtype"],
            "raw_gflops": gf["raw"], "rated_gflops": gf["rated"],
            "final_relres": s["final_relres"], "relres_limit": limit,
            "validation_passed": s["validation_passed"],
            "chain_consistent": s["chain_consistent"],
            "seconds_per_set": report.time_solve / report.n_sets, "setup_s": setup,
            "launches": counts, "sweep_k2_vs_k3_rel_err": sweep_err,
        }
        histories = {}
        rec["profiled_set"], histories["float16"] = _hpcg_sets(mg)
        del mg, report
        torch.cuda.empty_cache()
        for values in ("bfloat16", None):
            other = HPCGMGPreconditioner(shape, (1, 1, 1), SerialBackend(1), n_levels=LEVELS,
                                         dtype=dtype, precond_dtype=values, device=device)
            name = values or vectors
            rec[f"profiled_set_{name}_values"], histories[name] = _hpcg_sets(other)
            del other
            torch.cuda.empty_cache()
        rec["history_equal"] = {k: bool(torch.equal(histories["float16"], h))
                                for k, h in histories.items() if k != "float16"}
        emit(f"4k hpcg_float16 {key}", rec)
        if rec["cg_route"] != "flat" or s["precond_values_dtype"] != "float16":
            failures.append(f"{key}: the {rec['cg_route']} CG, values {s['precond_values_dtype']}")
        if not s["final_relres"] <= limit:
            failures.append(f"{key}: relres {s['final_relres']} > {limit}")
        if not (s["validation_passed"] and s["chain_consistent"]):
            failures.append(f"{key}: HPCG validation or chain consistency failed")
        if not sweep_err <= KERNEL_RTOL[vectors]:
            failures.append(f"{key}: sweep (K2) vs sweeps_core (K3) differ by {sweep_err}")
        if not all(rec["history_equal"].values()):
            failures.append(f"{key}: history differs: {rec['history_equal']}")
    if failures:
        raise AssertionError("; ".join(failures))

    # the kernels: K4 and K3 at the 128^3 level, K2 at one color of the
    # (2,2,2) x 64^3 level, random values of the 27-point pattern, float16
    # beside bfloat16 values on the same operator and inputs
    hpcg_errs = {}
    for values, vectors in F16_PAIRS:
        dtype = getattr(torch, vectors)
        A, b = build_hpcg_problem(LOCAL, (1, 1, 1), SerialBackend(1), dtype=dtype, device=device)
        col16, _ = _random_colored(A, torch.float16, g)
        colbf, _ = _random_colored(A, torch.bfloat16, g)
        _hold_narrow(results, f"random values, one part of {LOCAL[0]}^3", col16, colbf, g,
                     device)
        hpcg_errs[f"{values}/{vectors} one part"] = _narrow_on_hpcg(A, b, values, g, device)
        del A, b, col16, colbf
        torch.cuda.empty_cache()
        A, b = build_hpcg_problem(GHOST_LOCAL, GHOST_PARTS, SerialBackend(8), dtype=dtype,
                                  device=device)
        col16, _ = _random_colored(A, torch.float16, g)
        colbf, _ = _random_colored(A, torch.bfloat16, g)
        _hold_k2_narrow(results, (col16, colbf), g, device)
        hpcg_errs[f"{values}/{vectors} (2,2,2)"] = _narrow_on_hpcg(A, b, values, g, device)
        del A, b, col16, colbf
        torch.cuda.empty_cache()
    rows = [{k: r.get(k) for k in ("kernel", "dtype", "values", "max_abs_err", "max_rel_err",
                                   "ms", "ms_flushed", "device_ms", "bound_ms", "plain_ms")}
            for r in results]
    emit("4k kernels float16 values", {"rows": rows, "hpcg_values_vs_full": hpcg_errs,
                                       "hpcg_rtol": NARROW_HPCG_RTOL})
    return launches, results


def _stencil(n: int, shift: float):
    """``plaplacian_fdm``'s 7-point stencil at n^3 (scaled by (n+1)^3), its
    centre shifted by ``shift``."""
    alpha = float((n + 1) ** 3)
    out = [((0, 0, 0), 6 * alpha + shift)]
    for d in range(3):
        for step in (-1, 1):
            out.append((tuple(step if k == d else 0 for k in range(3)), -alpha))
    return out


def _block_system(dtype_name, device):
    """The coupled two-field system of ``block_cg``: the BMatrix [[A, C],
    [C, S]] (A = ``plaplacian_fdm``, S = A + 0.5 I, C = 0.1 I on A's rows),
    the global float64 block matrix G on the host, and b = G x* rounded to
    the dtype (x* from ``default_rng(BLOCK_SEED)``)."""
    import numpy as np
    import scipy.sparse as sp

    from partitionedarrays_tpu_torch import (
        BMatrix, BVector, SerialBackend, pfill, pvector_from_own, sparse_diag_matrix,
        to_global_scipy,
    )
    from partitionedarrays_tpu_torch.ops.stencil import stencil_psparse

    dtype = getattr(np, dtype_name)
    n = BLOCK_NODES[0]
    backend = SerialBackend(int(np.prod(BLOCK_PARTS)))
    A = stencil_psparse(BLOCK_PARTS, BLOCK_NODES, _stencil(n, 0.0), backend, dtype=dtype,
                        device=device)
    S = stencil_psparse(BLOCK_PARTS, BLOCK_NODES, _stencil(n, BLOCK_SHIFT), backend,
                        dtype=dtype, device=device)
    C = sparse_diag_matrix(pfill(BLOCK_COUPLING, A.row_prange, backend, dtype, device=device))
    M = BMatrix([[A, C], [C, S]])
    G = sp.bmat([[to_global_scipy(B).astype(np.float64) for B in row]
                 for row in M.blocks]).tocsr()
    N = A.shape[0]
    bg = G @ np.random.default_rng(BLOCK_SEED).standard_normal(2 * N)
    b = BVector([pvector_from_own([bg[k * N + li.own_to_global].astype(dtype)
                                   for li in A.row_prange.parts], A.row_prange, backend,
                                  device=device)
                 for k in range(2)])
    return M, G, b


def phase_block_cg(device, counters):
    """``block_cg`` (``BLOCK_RUNS``): ``b_cg`` on the coupled system
    through the port's entry points, float32 and float64, the launch counts
    set to 0 just before each solve and read just after: assembly seconds,
    iterations against the JAX package's on the CPU, the true relres of a
    float64 product of the blocks, cold and warm seconds (the warm solve
    by the port's ``PTimer`` and by CUDA events), a profiled warm solve
    (device time and its kernels' shares); then K1 on the three DIA
    blocks and K5 on the ghost block, each against its plain version (not
    counted).  Returns (the path's launches, kernel rows)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch import PTimer, b_cg, b_collect

    launches = {k: 0 for k in counters}
    failures, results = [], []
    g = torch.Generator().manual_seed(1414)
    for dtype_name, iters, limit in BLOCK_RUNS:
        key = f"{dtype_name}@2x{BLOCK_NODES[0]}^3 on {BLOCK_PARTS}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M, G, b = _block_system(dtype_name, device)
        torch.cuda.synchronize()
        assembly = time.perf_counter() - t0

        def solve(M=M, b=b):
            return b_cg(M, b, rtol=BLOCK_RTOL, maxiter=BLOCK_MAXITER)

        (x, it, relres), cold, counts = _timed(counters, solve)
        timer = PTimer(device=device)
        timer.tic("b_cg")
        (x, it_warm, _), warm, counts_warm = _timed(counters, solve)
        ptimer_s = timer.toc("b_cg")
        for c in (counts, counts_warm):
            for k, v in c.items():
                launches[k] += v
        profile = _profile_set(solve, top=6, kernels=("dia_spmv_kernel", "ghost_spmv_kernel"))
        bh = b_collect(b).astype(np.float64)
        true = float(np.linalg.norm(bh - G @ b_collect(x).astype(np.float64))
                     / np.linalg.norm(bh))
        rec = {
            "rows": G.shape[0], "nnz": M.nnz(), "assembly_s": assembly,
            "iterations": it, "jax_cpu_iterations": iters, "relres": relres,
            "true_relres": true, "true_relres_limit": limit, "cold_s": cold,
            "warm_s_cuda_events": warm, "warm_s_ptimer": ptimer_s,
            "launches_per_solve": counts, "launches_per_iteration": {
                k: v / max(it, 1) for k, v in counts.items()},
            "profiled_solve": profile,
            "idle_share": 1.0 - profile["device_ms"] / profile["profiled_wall_ms"],
        }
        emit(f"4k block_cg {key}", rec)
        if it != iters or it_warm != iters:
            failures.append(f"{key}: {it} / {it_warm} iterations, not the JAX package's {iters}")
        if not true <= limit:
            failures.append(f"{key}: true relres {true} > {limit}")
        if not ptimer_s >= warm:
            failures.append(f"{key}: PTimer {ptimer_s} s < CUDA events {warm} s: no fence")
        where = f"block_cg {key}"
        A, C, S = M.blocks[0][0], M.blocks[0][1], M.blocks[1][1]
        for name, blk in (("A", A), ("S = A + 0.5 I", S), ("C = 0.1 I", C)):
            oo = blk.device().oo
            P = oo.vals.shape[0]
            xs = torch.randn(P, oo.n_cols_pad, generator=g, dtype=oo.vals.dtype).to(device)
            _hold_k1(results, f"{name} of {where}", oo, xs,
                     library=_library(_csr(*_dia_triplets(oo.offsets, oo.vals, oo.n_cols_pad,
                                                          oo.n_rows),
                                           (P * oo.n_rows, P * oo.n_cols_pad)), xs))
        _hold_k5_blocks(results, where, [("A own-ghost", A.device().oh),
                                         ("S own-ghost", S.device().oh)], dtype_name, g, device)
        del M, G, b, x, A, C, S
        torch.cuda.empty_cache()
    rows = [{k: r.get(k) for k in ("kernel", "dtype", "where", "max_abs_err", "max_rel_err",
                                   "ms", "ms_flushed", "device_ms", "bound_ms", "plain_ms",
                                   "library_ms", "library_ms_flushed")}
            for r in results]
    emit("4k kernels K1, K5 on the block system", rows)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, results


def phase_utilities(device):
    """The remaining layers' checks on the card (not counted), one line
    each: ``PTimer`` across a region the card runs after the host has
    queued it (``torch.cuda._sleep``), fenced by ``toc``; a checkpoint round
    trip of a vector and a matrix onto the card (under the git-ignored
    ``build/``); ``primitives.gather``/``scatter``/``multicast`` of CUDA
    tensors."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch import (
        PTimer, SerialBackend, collect, gather, map_parts, multicast, plaplacian_fdm, prandn,
        scatter, spmv, to_global_scipy,
    )
    from partitionedarrays_tpu_torch.ops.jagged import JaggedArray
    from partitionedarrays_tpu_torch.utils import checkpoint

    timer = PTimer(barrier_at_tic=True, device=device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    timer.tic("sleep")
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    seconds = timer.toc("sleep")
    events = start.elapsed_time(end) / 1e3
    rec = {"ptimer_s": seconds, "cuda_events_s": events, "statistics": timer.statistics()}
    emit("4k utils ptimer", rec)
    if not seconds >= events:
        raise AssertionError(f"PTimer {seconds} s < the region's {events} s: toc did not fence")

    out = Path(os.path.dirname(os.path.abspath(__file__))) / "build" / "chip_smoke_checkpoint"
    out.mkdir(parents=True, exist_ok=True)
    A = plaplacian_fdm((32, 32, 32), (2, 2, 2), SerialBackend(8), dtype=np.float32, device=device)
    x = prandn(torch.Generator(device=device).manual_seed(7), A.col_prange, A.backend,
               device=device)
    checkpoint.save_pvector(out / "x.pt", x)
    checkpoint.save_psparse(out / "A.pt", A)
    x2 = checkpoint.load_pvector(out / "x.pt", A.backend, device=device)
    A2 = checkpoint.load_psparse(out / "A.pt", A.backend, device=device)
    y, y2 = spmv(A, x), spmv(A2, x2)
    rec = {"vector_equal": bool(np.array_equal(collect(x2), collect(x))),
           "matrix_equal": (to_global_scipy(A2) != to_global_scipy(A)).nnz == 0,
           "device": str(x2.own.device),
           "spmv_max_rel_diff": ((y2.own - y.own).abs().max() / y.own.abs().max()).item(),
           "bytes": sum(f.stat().st_size for f in out.glob("*.pt"))}
    shutil.rmtree(out)
    emit("4k utils checkpoint", rec)
    if not (rec["vector_equal"] and rec["matrix_equal"] and x2.own.is_cuda
            and rec["spmv_max_rel_diff"] <= KERNEL_RTOL["float32"]):
        raise AssertionError(f"checkpoint round trip on the card: {rec}")

    parts = x.own
    g = gather(parts, destination=0)
    back = scatter(g, source=0)
    jag = gather([parts[p, : n] for p, n in enumerate(x.layout.n_own)], destination="all")
    rec = {"gather_device": str(g[0].device), "gather_shapes": [list(t.shape) for t in g[:2]],
           "scatter_equal": bool(torch.equal(back, parts)),
           "multicast_equal": bool(torch.equal(multicast(parts, source=3)[5], parts[3])),
           "map_parts_equal": bool(torch.equal(map_parts(lambda a: 2 * a, parts), 2 * parts)),
           "jagged_device": str(jag[7].data.device),
           "jagged_equal": all(torch.equal(jag[7][p], parts[p, : n])
                               for p, n in enumerate(x.layout.n_own))}
    emit("4k utils primitives", rec)
    if not (g[0].is_cuda and isinstance(jag[7], JaggedArray) and jag[7].data.is_cuda
            and rec["scatter_equal"] and rec["multicast_equal"] and rec["map_parts_equal"]
            and rec["jagged_equal"]):
        raise AssertionError(f"primitives on CUDA tensors: {rec}")


# -- phase 4g: the reuse tier ------------------------------------------------------

class _StepTimes:
    """The ``timer(name)`` of examples/implicit_reuse.py on the card: the
    seconds of each step on the host clock, the device synchronized at
    both ends, and of each solve by CUDA events."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        torch.cuda.synchronize()
        if name == "solve":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        self.seconds.setdefault(name, []).append(seconds)


def _example():
    """examples/implicit_reuse.py, the user code of phase 4g."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import implicit_reuse

    return implicit_reuse


def _rel_diff(A, B) -> float:
    from partitionedarrays_tpu_torch.psparse import to_global_scipy

    G1, G2 = to_global_scipy(A), to_global_scipy(B)
    d = abs(G1 - G2)
    return float(d.max() if d.nnz else 0.0) / float(abs(G1).max())


def _check_refreshed(M, where, failures) -> list:
    """Every operand ``update`` refreshed, against a fresh build from the
    new matrices: each level's smoother arrays (the colored tier's values
    and inverse diagonal, or the tile tier's planes, off-tile values and
    tables), its box transfer's D^-1, its frozen A, P and P^T, bit for bit;
    its host P and coarse operator against a fresh ``_GalerkinCache`` at the
    frozen omega (1e-12 relative for a float64 operator, 1e-5 for a float32
    one); and the
    coarse factors, bit for bit."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.solvers import amg
    from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

    def same(a, b):
        return bool(torch.equal(a, b))

    def same_blocks(d, e):
        return all(same(getattr(d, k).vals, getattr(e, k).vals) for k in ("oo", "oh")
                   if getattr(d, k) is not None)

    out = []
    current = M.levels[0].A
    for l, (lev, gk) in enumerate(zip(M.levels, M._galerkin)):
        A_new = lev.A.copy()
        gs, gs_new = lev.smoother, GaussSeidel(A_new, lev.smoother.iterations, lev.smoother.sweep)
        if gs.colored is not None:
            ok = {"smoother": same(gs.colored.vals_d, gs_new.colored.vals_d)
                  and same(gs.colored.invd_d, gs_new.colored.invd_d)}
        else:
            ok = {"smoother": all(same(getattr(gs.tile_gs, n), getattr(gs_new.tile_gs, n)) for n in
                                  ("pack", "vals", "rows", "cols", "tile_ptr", "wave_tiles",
                                   "tile_lanes"))}
        ok["A"] = same_blocks(lev.A.device(), A_new.device())
        if lev.struct is not None:
            ok["dinv"] = same(lev.struct.dinv, amg._box_dinv(A_new))
        else:
            P_new = lev.P.copy()
            ok["P"] = same_blocks(lev.P.device(), P_new.device())
            ok["P^T"] = all(same(a.vals, b.vals) for a, b in zip(
                lev.P.device_transpose(), P_new.device_transpose()) if a is not None)
        # the level's operator sets the precision of S and of the products
        tol = 1e-12 if lev.A.blocks[0]["oo"].dtype == np.float64 else 1e-5
        fresh = amg._GalerkinCache(current.copy(), gk.P0, gk.omega)
        errs = {"P": _rel_diff(fresh.P, lev.P), "Ac": _rel_diff(fresh.Ac, gk.Ac)}
        current = gk.Ac
        for k, v in ok.items():
            if not v:
                failures.append(f"{where} level {l}: the refreshed {k} differs from a fresh build")
        for k, v in errs.items():
            if not v <= tol:
                failures.append(f"{where} level {l}: the updated {k} is {v} from a fresh build")
        out.append({"level": l, "equal": ok, "rel_diff": errs, "tol": tol})
    tmp = amg.AMGPreconditioner.__new__(amg.AMGPreconditioner)
    tmp._coarse_factorize(M.levels[-1].A.copy())
    coarse_ok = tmp.coarse_kind == M.coarse_kind and all(
        same(a, b) for a, b in zip(tmp._coarse, M._coarse))
    if not coarse_ok:
        failures.append(f"{where}: the refreshed coarse factors differ from a fresh build")
    out.append({"coarse": M.coarse_kind, "equal": coarse_ok})
    return out


def _vcycle(counters, M, b):
    """One V-cycle's seconds (CUDA events), launches and device ms."""
    _, seconds, launches = _timed(counters, lambda: M(b))
    return {"s": seconds, "launches": launches, "device_ms": device_ms(lambda: M(b), 5)}


def phase_reuse(device, counters):
    """The reuse tier through the user code of examples/implicit_reuse.py:
    ``reaction_diffusion_parts``, ``newton_reuse`` and
    ``elasticity_update``, each with the launch counts set to 0 just before
    it and read just after.  Then each refreshed operand against a fresh
    build, and K1, K3, K4, K5 and K6 against their plain versions on the
    refreshed operands (``REFRESH_RTOL``; those calls are not counted).
    Returns (the three paths' launches, kernel rows)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.psparse import device_refill_plan
    from partitionedarrays_tpu_torch.utils import profiling

    ir = _example()
    ns = ir.port(device)
    failures, results = [], []
    launches = {}
    g = torch.Generator().manual_seed(4747)

    # reaction_diffusion_parts
    timer = _StepTimes()
    profiling.reset_counts()
    t0 = time.perf_counter()
    rd = ir.reaction_diffusion(ns, nodes=REUSE_RD_NODES, parts=REUSE_RD_PARTS, timer=timer)
    wall = time.perf_counter() - t0
    launches["reaction_diffusion_parts"] = {k: profiling.launches(k) for k in counters}
    M, J = rd["M"], rd["J"]
    where = f"reaction-diffusion {REUSE_RD_NODES[0]}^3 on {REUSE_RD_PARTS}"
    b = ns.from_own([np.random.default_rng(5).standard_normal(li.n_own)
                     for li in J.row_prange.parts], J.row_prange, J.backend)
    rec = {
        "rows": J.shape[0], "parts": J.row_prange.n_parts, "newton": rd["newton"],
        "cg": rd["cg"], "true_relres": rd["relres"], "wall_s": wall,
        "anchor": {"newton": REUSE_RD_NEWTON, "cg": REUSE_RD_CG},
        "refill_ms": [1e3 * t for t in timer.seconds["refill"]],
        "setup_s": timer.seconds["setup"], "update_s": timer.seconds.get("update", []),
        "solve_s": timer.seconds["solve"], "levels": _level_info(M), "omegas": M.omegas,
        "vcycle": _vcycle(counters, M, b),
    }
    if tuple(rd["newton"]) != REUSE_RD_NEWTON:
        failures.append(f"{where}: Newton iterations {rd['newton']}, not {REUSE_RD_NEWTON}")
    if tuple(rd["cg"]) != REUSE_RD_CG:
        failures.append(f"{where}: CG iterations {rd['cg']}, not {REUSE_RD_CG}")
    if not max(rd["relres"]) <= REUSE_RD_RELRES:
        failures.append(f"{where}: true relres {max(rd['relres'])} > {REUSE_RD_RELRES}")
    if len(rec["update_s"]) != len(rd["cg"]) - 1:
        failures.append(f"{where}: {len(rec['update_s'])} updates for {len(rd['cg'])} solves")
    rec["refreshed"] = _check_refreshed(M, where, failures)
    emit("4g reuse reaction_diffusion_parts", rec)
    _hold_box_levels(results, f"refreshed {where}", M, g, device, rec["vcycle"]["launches"],
                     REFRESH_RTOL)
    _hold_k5_blocks(results, f"refreshed {where}", _parts_blocks(M), "float64", g, device,
                    REFRESH_RTOL)
    oo = J.device().oo
    P = oo.vals.shape[0]
    xs = torch.randn(P, oo.n_cols_pad, generator=g, dtype=J.dtype).to(device)
    _hold_k1(results, f"refilled Jacobian of {where}", oo, xs,
             library=_library(_csr(*_dia_triplets(oo.offsets, oo.vals, oo.n_cols_pad, oo.n_rows),
                                   (P * oo.n_rows, P * oo.n_cols_pad)), xs),
             rtol=REFRESH_RTOL)
    del rd, M, J, oo, b
    torch.cuda.empty_cache()

    # newton_reuse
    timer = _StepTimes()
    profiling.reset_counts()
    nr = ir.newton_reuse(ns, nodes=NEWTON_REUSE_NODES, timer=timer, fresh=False)
    launches["newton_reuse"] = {k: profiling.launches(k) for k in counters}
    A, M = nr["A"], nr["M"]
    where = f"newton_reuse {NEWTON_REUSE_NODES[0]}^3 float32"
    plan = device_refill_plan(A, nr["cache"])
    Vs = plan.stack_values(nr["V2"])
    dev = plan(Vs)
    exact = all(bool(torch.equal(getattr(dev, k).vals, getattr(A.device(), k).vals))
                for k in ("oo", "oh"))
    if not exact:
        failures.append(f"{where}: DeviceRefill differs from the host refill and refreeze")
    fresh_its = int(ns.cg(A, nr["b"], M=ns.AMGPreconditioner(A, ns.AMGParams(**BOX_PARAMS)),
                          rtol=BOX_RTOL, maxiter=BOX_MAXITER)[1].iterations)
    rec = {
        "rows": A.shape[0], "iterations": nr["iterations"], "fresh_iterations": fresh_its,
        "true_relres": nr["relres"],
        "reuse_cache_build_s": timer.seconds["cache_build"][0],
        "setup_s": timer.seconds["setup"][0], "newton_refill_s": timer.seconds["refill"][0],
        "newton_update_s": timer.seconds["update"][0], "solve_s": timer.seconds["solve"][0],
        "device_refill_ms": time_ms(lambda: plan(Vs), 10), "device_refill_exact": exact,
        "device_refill_rank_scatters": {k: len(v) for k, v in plan.ranks.items()},
        "levels": _level_info(M), "vcycle": _vcycle(counters, M, nr["b"]),
    }
    lo, hi = NEWTON_REUSE_ITERS
    if not lo <= nr["iterations"] <= hi:
        failures.append(f"{where}: {nr['iterations']} CG iterations, not in {NEWTON_REUSE_ITERS}")
    rec["refreshed"] = _check_refreshed(M, where, failures)
    emit("4g reuse newton_reuse", rec)
    _hold_box_levels(results, f"refreshed {where}", M, g, device, rec["vcycle"]["launches"],
                     REFRESH_RTOL)
    oo = A.device().oo
    xs = torch.randn(1, oo.n_cols_pad, generator=g, dtype=A.dtype).to(device)
    _hold_k1(results, f"refilled operator of {where}", oo, xs,
             library=_library(_csr(*_dia_triplets(oo.offsets, oo.vals, oo.n_cols_pad, oo.n_rows),
                                   (oo.n_rows, oo.n_cols_pad)), xs),
             rtol=REFRESH_RTOL)
    del nr, A, M, dev, plan, Vs, oo
    torch.cuda.empty_cache()

    # elasticity_update
    timer = _StepTimes()
    profiling.reset_counts()
    eu = ir.elasticity_update(ns, nodes=ELASTICITY_UPDATE_NODES, timer=timer, fresh=False)
    launches["elasticity_update"] = {k: profiling.launches(k) for k in counters}
    A, M = eu["A"], eu["M"]
    where = f"elasticity_update {ELASTICITY_UPDATE_NODES[0]}^3 float32"
    t0 = time.perf_counter()
    fresh_M = ns.AMGPreconditioner(A, ns.AMGParams(**AMG_PARAMS), nullspace=eu["nullspace"])
    fresh_setup = time.perf_counter() - t0
    fresh_its = int(ns.cg(A, eu["b"], M=fresh_M, rtol=AMG_RTOL, maxiter=AMG_MAXITER)[1].iterations)
    del fresh_M
    rec = {
        "rows": A.shape[0], "shift": eu["shift"], "iterations": eu["iterations"],
        "fresh_iterations": fresh_its, "true_relres": eu["relres"],
        "cache_build_s": timer.seconds["cache_build"][0], "setup_s": timer.seconds["setup"][0],
        "fresh_setup_s": fresh_setup, "refill_s": timer.seconds["refill"][0],
        "update_s": timer.seconds["update"][0], "solve_s": timer.seconds["solve"][0],
        "n_resetups": M.n_resetups, "levels": _level_info(M),
        "vcycle": _vcycle(counters, M, eu["b"]),
    }
    if abs(eu["iterations"] - fresh_its) > 1:
        failures.append(f"{where}: {eu['iterations']} CG iterations after update, "
                        f"{fresh_its} after a fresh setup")
    if not eu["relres"] <= 1e-5:
        failures.append(f"{where}: true relres {eu['relres']} > 1e-5")
    rec["refreshed"] = _check_refreshed(M, where, failures)
    emit("4g reuse elasticity_update", rec)
    for l, lev in enumerate(M.levels):
        gs = lev.smoother
        if gs is None:
            continue
        if gs.tile_gs is not None:
            _hold_tile(results, f"refreshed level {l} of {where}", gs.tile_gs, "float32", g,
                       device, REFRESH_RTOL)
        else:
            _hold_k3(results, f"refreshed level {l} of {where}", gs, "float32", g, device,
                     REFRESH_RTOL)
    _hold_k5_blocks(results, f"refreshed {where}", _amg_blocks(M), "float32", g, device,
                    REFRESH_RTOL)
    oo = A.device().oo
    if oo.kind == "dia":
        xs = torch.randn(1, oo.n_cols_pad, generator=g, dtype=A.dtype).to(device)
        _hold_k1(results, f"refilled operator of {where}", oo, xs,
                 library=_library(_csr(*_dia_triplets(oo.offsets, oo.vals, oo.n_cols_pad,
                                                      oo.n_rows), (oo.n_rows, oo.n_cols_pad)), xs),
                 rtol=REFRESH_RTOL)
    del eu, A, M, oo
    torch.cuda.empty_cache()

    # elasticity_update at 24^3: its refilled Galerkin products are real where
    # the build's cancelled exactly, so update sets up anew on the same
    # aggregates (n_resetups); the JAX package and the port before raised
    timer = _StepTimes()
    profiling.reset_counts()
    eu = ir.elasticity_update(ns, nodes=RESETUP_NODES, timer=timer, fresh=True)
    launches["elasticity_update_24"] = {k: profiling.launches(k) for k in counters}
    M = eu["M"]
    where = f"elasticity_update {RESETUP_NODES[0]}^3 float32"
    rec = {
        "rows": eu["A"].shape[0], "shift": eu["shift"], "n_resetups": M.n_resetups,
        "iterations": eu["iterations"], "fresh_iterations": eu["fresh_iterations"],
        "true_relres": eu["relres"], "setup_s": timer.seconds["setup"][0],
        "refill_s": timer.seconds["refill"][0], "update_s": timer.seconds["update"][0],
        "solve_s": timer.seconds["solve"][0], "levels": _level_info(M),
    }
    emit("4g reuse elasticity_update (re-setup)", rec)
    if M.n_resetups < 1:
        failures.append(f"{where}: update took no re-setup")
    if abs(eu["iterations"] - eu["fresh_iterations"]) > 1 or not eu["relres"] <= 1e-5:
        failures.append(f"{where}: {eu['iterations']} CG iterations against a fresh setup's "
                        f"{eu['fresh_iterations']}, true relres {eu['relres']}")
    for l, lev in enumerate(M.levels):
        if lev.smoother is not None and lev.smoother.tile_gs is not None:
            _hold_tile(results, f"re-set-up level {l} of {where}", lev.smoother.tile_gs,
                       "float32", g, device, REFRESH_RTOL)
    _hold_k5_blocks(results, f"re-set-up {where}", _amg_blocks(M), "float32", g, device,
                    REFRESH_RTOL)
    del eu, M
    torch.cuda.empty_cache()
    emit("4g kernels K1, K3, K4, K5, K6 on refreshed operands", results)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, results


def _schwarz_factors(S) -> dict:
    """W, B and tiles of the ILU(0) Schwarz smoother's two K6 factors."""
    return {name: {"tiles": tg.n_real_tiles, "W": tg.W, "B": tg.B, "parts": tg.pack.shape[0]}
            for name, tg in (("L", S.sgsL), ("U", S.sgsU))}


def _sparse_triangular_library(tg, L, b):
    """One PyTorch call that solves with the factor of part 0 (a one-part
    smoother), where the card's PyTorch has one: ``torch.triangular_solve``
    with a sparse CSR matrix (cuSPARSE's triangular solve).  Returns (the
    call, None) or (None, why not)."""
    import torch

    if tg.pack.shape[0] != 1:
        return None, "more than one part"
    C = L.tocsr()
    A = torch.sparse_csr_tensor(torch.from_numpy(C.indptr.astype("int64")),
                                torch.from_numpy(C.indices.astype("int64")),
                                torch.from_numpy(C.data), size=C.shape,
                                dtype=b.dtype, device=b.device)
    rhs = b[0, : C.shape[0]].unsqueeze(1).contiguous()
    upper = tg.directions == ("b",)

    def call():
        return torch.triangular_solve(rhs, A, upper=upper).solution

    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:  # no such kernel on this build
        return None, f"{type(exc).__name__}: {str(exc)[:200]}"
    return call, None


def _hold_tri(results, where, S, dtype_name, g, device, scipy_check=True):
    """K6 in one-direction mode on an ILU(0) Schwarz smoother: the forward
    solve with L and the backward solve with U from a zero guess, one
    launch each, against the plain version (``TRI_RTOL``) and, in float64
    with ``scipy_check``, against scipy's ``spsolve_triangular`` (1e-10 of
    the largest entry); then each solve timed: CUDA events, device time,
    the plain version, the bound (one direction's planes, the off-tile
    entries, b and x, each moved once), the device time of a launch of no
    wave step and of one (the latency floor is W such steps), and a sparse
    triangular solve of PyTorch where there is one."""
    import numpy as np
    import torch
    from scipy.sparse.linalg import spsolve_triangular

    from partitionedarrays_tpu_torch.ops.native import ilu0
    from partitionedarrays_tpu_torch.ops.tile_gs import tile_gs_sweeps, tile_gs_sweeps_plain
    from partitionedarrays_tpu_torch.psparse import host_blocks
    from partitionedarrays_tpu_torch.utils import profiling

    dtype = getattr(torch, dtype_name)
    factors = [ilu0(blk["oo"]) for blk in host_blocks(S.A)]
    for k, (tg, d, name) in enumerate(((S.sgsL, "f", "L"), (S.sgsU, "b", "U"))):
        P = tg.pack.shape[0]
        b = torch.randn(P, tg.Rp, generator=g, dtype=dtype).to(device)
        zero = torch.zeros_like(b)
        before = profiling.launches("tile_gs_sweeps")
        got = tile_gs_sweeps(*tg.operands(), zero.clone(), b, (d,), zero_guess=True,
                             tile_lanes=tg.tile_lanes)
        n = profiling.launches("tile_gs_sweeps") - before
        if n != 1:
            raise AssertionError(f"tile_gs_sweeps {name} of {where}: {n} launches for one solve")
        torch.cuda.synchronize()
        want = tile_gs_sweeps_plain(*tg.operands(), zero.clone(), b, (d,), zero_guess=True)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not err <= TRI_RTOL[dtype_name] * scale:
            raise AssertionError(f"tile_gs_sweeps {name} of {where} {dtype_name}: "
                                 f"{err / scale} > {TRI_RTOL[dtype_name]}")
        scipy_err = None
        if scipy_check and dtype_name == "float64":
            scipy_err = 0.0
            for p, li in enumerate(S.A.row_prange.parts):
                n = li.n_own
                xe = spsolve_triangular(factors[p][k].tocsr(), b[p, :n].cpu().numpy(),
                                        lower=d == "f")
                e = np.abs(got[p, :n].cpu().numpy() - xe).max() / max(np.abs(xe).max(), 1.0)
                scipy_err = max(scipy_err, float(e))
            if not scipy_err < 1e-10:
                raise AssertionError(f"tile_gs_sweeps {name} of {where}: {scipy_err} from "
                                     "spsolve_triangular")
        x_t = zero.clone()

        def solve(**kw):
            return lambda: tile_gs_sweeps(*tg.operands(), x_t, b, (d,), zero_guess=True,
                                          tile_lanes=tg.tile_lanes, **kw)

        work = _tile_work(tg, (d,), b.element_size())
        b_ms, b_by = bound(*work, _flops(dtype_name))
        dev_ms = device_ms(solve(), 10)
        step0, step1 = (device_ms(solve(_n_steps=n), 10) for n in (0, 1))
        row = {
            "kernel": "tile_gs_sweeps", "mode": "triangular solve (topo, one direction)",
            "dtype": dtype_name, "where": f"{name} of {where}", "P": P,
            "tiles": tg.n_real_tiles, "W": tg.W, "B": tg.B, "K_off": tg.cols.shape[1],
            "launches_per_call": 1, "max_abs_err": err, "max_rel_err": err / scale,
            "tol_rel": TRI_RTOL[dtype_name], "spsolve_triangular_rel_err": scipy_err,
            "ms": time_ms(solve(), 10), "device_ms": dev_ms,
            "plain_ms": time_ms(lambda: tile_gs_sweeps_plain(*tg.operands(), zero.clone(), b,
                                                             (d,), zero_guess=True), 2),
            "bytes": work[0], "ops": work[1], "bound_ms": b_ms, "bound_by": b_by,
            "steps_device_ms": [[0, step0], [1, step1], [tg.W, dev_ms]],
            "latency_floor_ms": None if step0 is None or step1 is None
            else tg.W * (step1 - step0),
        }
        lib, why = _sparse_triangular_library(tg, factors[0][k], b)
        if lib is not None:
            xe = lib()[:, 0]
            n = xe.shape[0]
            row["library_max_abs_err"] = (xe - want[0, :n]).abs().max().item()
            row["library_ms"] = time_ms(lib, 5)
            row["library_device_ms"] = device_ms(lib, 5)
        else:
            row["library_ms"] = None
            row["library_none"] = why
        results.append(row)


def _schwarz_solve(counters, A, b, S, rtol, maxiter):
    """CG on A x = b preconditioned by S, launches counted: (x, info,
    seconds, launches) and the true float64 relative residual."""
    import numpy as np

    from partitionedarrays_tpu_torch.psparse import to_global_scipy
    from partitionedarrays_tpu_torch.pvector import collect
    from partitionedarrays_tpu_torch.solvers.krylov import cg

    (x, info), seconds, counts = _timed(counters, lambda: cg(A, b, M=S, rtol=rtol,
                                                            maxiter=maxiter))
    G = to_global_scipy(A).astype(np.float64)
    bg, xg = collect(b).astype(np.float64), collect(x).astype(np.float64)
    relres = float(np.linalg.norm(bg - G @ xg) / np.linalg.norm(bg))
    return x, info, seconds, counts, relres


def phase_schwarz(device, counters):
    """The Schwarz tier through the port's entry points (``SCHWARZ_RUNS``,
    ``SCHWARZ_PARTS_RUNS``, ``AMG_SCHWARZ_RUNS``), each path's launch counts
    set to 0 just before its solves and read just after: ``schwarz_ilu0``
    (bench.py:580-617), ``schwarz_ilu0_parts`` and
    ``amg_schwarz_elasticity``.  Then K6 in one-direction mode, K1 (A.p, a
    residual) and K5 (the own-ghost block, a coarse residual) on those
    paths' operands against their plain versions (not counted).  Returns
    (the three paths' launches, kernel rows)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.gallery import (
        linear_elasticity_fem, node_coordinates_unit_cube, nullspace_linear_elasticity,
    )
    from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
    from partitionedarrays_tpu_torch.psparse import psparse, spmv
    from partitionedarrays_tpu_torch.pvector import pones
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
    from partitionedarrays_tpu_torch.solvers.smoothers import AdditiveSchwarz

    failures, results = [], []
    launches = {p: {k: 0 for k in counters}
                for p in ("schwarz_ilu0", "schwarz_ilu0_parts", "amg_schwarz_elasticity")}
    g = torch.Generator().manual_seed(1010)

    def add(path, counts):
        for k, v in counts.items():
            launches[path][k] += v

    for path, local, parts, runs in (
        ("schwarz_ilu0", SCHWARZ_LOCAL, (1, 1, 1), SCHWARZ_RUNS),
        ("schwarz_ilu0_parts", SCHWARZ_LOCAL, SCHWARZ_PARTS, SCHWARZ_PARTS_RUNS),
    ):
        for dtype, (lo, hi) in runs:
            key = f"{path} {dtype}"
            A, b = build_hpcg_problem(local, parts, SerialBackend(int(np.prod(parts))),
                                      dtype=getattr(np, dtype), device=device)
            A.device()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            S = AdditiveSchwarz(A, mode="ilu0")
            torch.cuda.synchronize()
            setup = time.perf_counter() - t0
            x, info, seconds, counts, relres = _schwarz_solve(counters, A, b, S, SCHWARZ_RTOL,
                                                              SCHWARZ_MAXITER)
            add(path, counts)
            rec = {
                "rows": A.shape[0], "parts": A.row_prange.n_parts, "mode": S.mode,
                "factors": _schwarz_factors(S), "setup_s": setup,
                "iterations": info.iterations, "anchor": [lo, hi],
                "cg_residual": float(info.residual), "true_relres": relres, "solve_s": seconds,
                "launches_per_solve": counts, "apply_ms": time_ms(lambda: S(b), 10),
                "apply_device_ms": device_ms(lambda: S(b), 10),
            }
            emit(f"4h {key}", rec)
            if not lo <= info.iterations <= hi:
                failures.append(f"{key}: {info.iterations} CG iterations, not in [{lo}, {hi}]")
            if counts["tile_gs_sweeps"] != 2 * (info.iterations + 1):
                failures.append(f"{key}: {counts['tile_gs_sweeps']} K6 launches for "
                                f"{info.iterations} iterations (2 per Schwarz apply)")
            _hold_tri(results, f"{key} {'x'.join(map(str, parts))}x{local[0]}^3", S, dtype,
                      g, device)
            oo = A.device().oo
            xs = torch.randn(oo.vals.shape[0], oo.n_cols_pad, generator=g,
                             dtype=A.dtype).to(device)
            _hold_k1(results, f"A.p of {key}", oo, xs)
            if A.col_layout().n_ghost_pad:
                _hold_k5_blocks(results, key, [("own-ghost", A.device().oh)], dtype, g, device)
            del A, b, S, x
            torch.cuda.empty_cache()

    # amg_schwarz_elasticity: phase 4d's workload with Schwarz level smoothers
    for nodes, dtype, iter_range, limit in AMG_SCHWARZ_RUNS:
        key = f"amg_schwarz_elasticity {dtype}@{nodes[0]}^3"
        shared = SHARED_ELASTICITY.pop((nodes, dtype), None)
        if shared is None:
            t0 = time.perf_counter()
            A = psparse(*linear_elasticity_fem(nodes, (1, 1, 1), dtype=getattr(np, dtype)),
                        SerialBackend(1), device=device)
            A.device()
            torch.cuda.synchronize()
            assembly = time.perf_counter() - t0
        else:
            A, assembly = shared
        coords, _ = node_coordinates_unit_cube(nodes, (1, 1, 1))
        t0 = time.perf_counter()
        M = AMGPreconditioner(A, AMGParams(smoother="schwarz", **AMG_PARAMS),
                              nullspace=nullspace_linear_elasticity(coords))
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        b = spmv(A, pones(A.col_prange, A.backend, dtype=A.dtype, device=device))
        x, info, seconds, counts, relres = _schwarz_solve(counters, A, b, M, AMG_RTOL,
                                                          AMG_MAXITER)
        add("amg_schwarz_elasticity", counts)
        tiers = [lev.smoother.mode for lev in M.levels if lev.smoother is not None]
        rec = {
            "rows": A.shape[0], "assembly_s": assembly, "matrix_of_phase_4d": shared is not None,
            "setup_s": setup, "levels": _level_info(M), "tiers": tiers,
            "iterations": info.iterations,
            "anchor": iter_range, "cg_residual": float(info.residual), "true_relres": relres,
            "solve_s": seconds, "launches_per_solve": counts,
            "vcycle": _vcycle(counters, M, b) if nodes == AMG_KERNEL_NODES else None,
        }
        emit(f"4h {key}", rec)
        if iter_range is not None and not iter_range[0] <= info.iterations <= iter_range[1]:
            failures.append(f"{key}: {info.iterations} CG iterations, not in {iter_range}")
        if info.iterations >= AMG_MAXITER or not relres <= limit:
            failures.append(f"{key}: {info.iterations} iterations, true relres {relres} > {limit}")
        if nodes == AMG_KERNEL_NODES:
            if not {"ilu0", "dense"} <= set(tiers):
                failures.append(f"{key}: Schwarz tiers {tiers}, not both ilu0 and dense")
            for l, lev in enumerate(M.levels):
                if lev.smoother is not None and lev.smoother.mode == "ilu0":
                    _hold_tri(results, f"level {l} of {key}", lev.smoother, dtype, g, device,
                              scipy_check=False)
            # K1: the fine operator (A.p and the level-0 residual); K5: the
            # level-1 residual (P and P^T: phase 4d, the same matrices)
            oo = A.device().oo
            xs = torch.randn(1, oo.n_cols_pad, generator=g, dtype=A.dtype).to(device)
            _hold_k1(results, f"A of {key}", oo, xs)
            _hold_k5_blocks(results, key, [("A1", M.levels[1].A.device().oo)], dtype, g, device)
        del A, M, b, x
        torch.cuda.empty_cache()
    emit("4h kernels K6 (triangular solves), K1, K5", results)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, results


# -- phase 4i: reduced-precision preconditioner values ----------------------------


def _random_colored(A, values_dtype, g):
    """The colored GS state of ``A``'s DIA pattern with random values
    (off-diagonals scaled by [0.5, 1), the diagonal by [1, 1.5)), stored in
    ``values_dtype``, and the same values stored in the vectors' dtype."""
    import torch

    from partitionedarrays_tpu_torch.solvers.gs_dia import ColoredDIAGS

    oo = A.device().oo
    scale = (0.5 + 0.5 * torch.rand(oo.vals.shape, generator=g, dtype=oo.vals.dtype))
    k0 = oo.offsets.index(0)
    scale[:, k0] += 0.5
    vals = oo.vals * scale.to(oo.vals.device)
    diag = vals[:, k0].contiguous()
    return (ColoredDIAGS.from_device(oo.offsets, vals, diag, values_dtype),
            ColoredDIAGS.from_device(oo.offsets, vals, diag))


def _hold_narrow(results, where, col, full, g, device):
    """K4 and K3 (symmetric, from a random guess) on the narrow values of
    ``col`` against their plain versions, beside the full-value kernels on
    the same operator ``full``, each with its time, device time, plain time
    and bound (values read in their own dtype)."""
    import torch

    from partitionedarrays_tpu_torch.ops.gs_dia_kernels import gs_sweeps, gs_sweeps_plain

    P, m, n_off, Lq = col.vals_d.shape
    dtype = col.invd_d.dtype
    name = str(dtype).replace("torch.", "")
    x = torch.randn(P, m, Lq, generator=g, dtype=dtype).to(device)
    bd = torch.randn(P, m, Lq, generator=g, dtype=dtype).to(device)
    fwd = tuple(range(m))
    order = fwd + fwd[::-1]
    itemsize = x.element_size()
    for c in (full, col):
        _hold_k4(results, where, c, x)
        nbytes, ops, _ = _k3_work(c, order, itemsize, False, c.vals_d.element_size())
        _hold(results, "gs_sweeps", name,
              lambda c=c: gs_sweeps(c.vals_d, bd, c.invd_d, x, c.taps, order),
              lambda c=c: gs_sweeps_plain(c.vals_d, bd, c.invd_d, x, c.taps, order),
              work=(nbytes, ops, _flops(name)))
        results[-1].update(where=where, values=str(c.vals_d.dtype).replace("torch.", ""),
                           m=m, n_off=n_off, Lq=Lq)


def _hold_k2_narrow(results, cols, g, device):
    """K2 on the middle color of each colored state of ``cols`` (one
    operator of the (2,2,2) x 64^3 level, values of several dtypes) against
    its plain version, timed with the L2 flushed; bound: the color's values
    in their own dtype, the core and the color's rows, once."""
    from functools import partial

    import torch

    from partitionedarrays_tpu_torch.ops.dia import dia_spmv_plain
    from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv_strided

    first = cols[0]
    dtype = first.invd_d.dtype
    vectors = str(dtype).replace("torch.", "")
    P = first.vals_d.shape[0]
    core = torch.randn(P, first.m * first.Lq, generator=g, dtype=dtype).to(device)
    c = first.m // 2
    for cc in cols:
        taps, vals_c = cc.taps.host[c], cc.vals_d[:, c]
        _hold(results, "dia_spmv_strided", vectors,
              partial(dia_spmv_strided, taps, vals_c, core),
              partial(dia_spmv_plain, taps, vals_c, core), flushed=True,
              work=(vals_c.element_size() * vals_c.numel()
                    + core.element_size() * (core.numel() + P * cc.Lq),
                    2 * vals_c.numel(), _flops(vectors)))
        results[-1].update(where=f"random values, one color of {GHOST_PARTS}x{GHOST_LOCAL[0]}^3",
                           values=str(cc.vals_d.dtype).replace("torch.", ""),
                           shape=list(vals_c.shape), m=cc.m, color=c)


def _narrow_on_hpcg(A, b, values, g, device) -> dict:
    """HPCG's own values (exact in bfloat16): the narrow-value K4, K3 and
    the standalone sweep (K2 per color) against the full-value kernels,
    relative to the largest full-value entry (``NARROW_HPCG_RTOL``)."""
    import torch

    from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

    full, narrow = GaussSeidel(A), GaussSeidel(A, values_dtype=getattr(torch, values))
    col = full.colored
    x = torch.randn(col.vals_d.shape[0], col.m, col.Lq, generator=g, dtype=A.dtype).to(device)
    bd = full.make_bd(b)
    order = full._order_seq()

    def outputs(gs):
        c = gs.colored
        return {"ax_core": gs.flat_ax(x), "gs_sweeps": gs.smooth_bd(x, bd),
                "dia_spmv_strided": c.sweep_flat(x.clone(), bd, c.vals_d, c.invd_d, order)}

    want, got = outputs(full), outputs(narrow)
    torch.cuda.synchronize()
    name = str(A.dtype).replace("torch.", "")
    errs = {k: ((got[k] - want[k]).abs().max() / want[k].abs().max()).item() for k in want}
    bad = {k: e for k, e in errs.items() if not e <= NARROW_HPCG_RTOL[name]}
    if bad:
        raise AssertionError(f"narrow {values} values on HPCG's operator vs full values: {bad}")
    return errs


def phase_precond_values(device, counters):
    """The reduced-precision preconditioner values through the port's entry
    point (``PRECOND_RUNS``), the launch counts set to 0 just before each
    benchmark and read just after (the float32-valued comparison set at
    128^3 runs outside that window); then the narrow-value K2, K3 and K4
    against their plain versions and the full-value kernels (not
    counted).  Returns (the path's launches, kernel rows)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat
    from partitionedarrays_tpu_torch.models.hpcg.driver import cg_route, hpcg_benchmark
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
    from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem

    launches = {k: 0 for k in counters}
    failures, results = [], []
    for shape, parts, vectors, values, limit in PRECOND_RUNS:
        P = int(np.prod(parts))
        key = f"{vectors}@{'x'.join(map(str, parts))}x{shape[0]}^3 {values} values"
        precision = "df64" if vectors == "df64" else None
        dtype = np.float32 if precision else getattr(np, vectors)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mg = HPCGMGPreconditioner(shape, parts, SerialBackend(P), n_levels=LEVELS, dtype=dtype,
                                  precond_dtype=values, device=device)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        route = cg_route(mg, precision)

        def run(mg=mg, setup=setup, precision=precision, shape=shape, parts=parts):
            report = hpcg_benchmark(
                None, local_shape=shape, parts_per_dir=parts, n_levels=LEVELS,
                iterations=ITERATIONS, ref_sets=1, timed_sets=3, precision=precision,
                mg=mg, setup_time=setup, device=device,
            )
            sweep_err = None
            if route == "flat_g":  # the standalone sweep (K2) against K3, narrow values
                gs, col = mg.gss[-1], mg.gss[-1].colored
                x = mg.b.own * 0.5
                gc = gs.ghost_contrib(x)
                order = gs._order_seq()
                via_k2 = col.sweep(x, mg.b.own, gc, col.vals_d, col.invd_d, order)
                via_k3 = gs.flat_interleave(col.sweeps_core(
                    gs.flat_deinterleave(x), gs.flat_deinterleave(mg.b.own - gc),
                    col.vals_d, col.invd_d, order))
                sweep_err = ((via_k2 - via_k3).abs().max() / via_k3.abs().max()).item()
            return report, sweep_err

        (report, sweep_err), _, counts = _timed(counters, run)
        for k, v in counts.items():
            launches[k] += v
        s = report.summary()
        gf = report.gflops()
        rec = {
            "cg_route": route, "precond_values_dtype": s["precond_values_dtype"],
            "raw_gflops": gf["raw"], "rated_gflops": gf["rated"],
            "final_relres": s["final_relres"], "relres_limit": limit,
            "validation_passed": s["validation_passed"],
            "chain_consistent": s["chain_consistent"],
            "seconds_per_set": report.time_solve / report.n_sets, "setup_s": setup,
            "launches": counts, "nrow": s["nrow"],
        }
        if sweep_err is not None:
            rec["sweep_k2_vs_k3_rel_err"] = sweep_err
            if not sweep_err <= KERNEL_RTOL[vectors]:
                failures.append(f"{key}: sweep (K2) vs sweeps_core (K3) differ by {sweep_err}")
        if shape == LOCAL:  # a profiled set and the history beside float32 values
            rec["profiled_set"] = _profile_set(
                lambda: hpcg_cg_flat(mg, mg.b, iterations=ITERATIONS), top=8,
                kernels=("gs_seq", "ax_core"))
            _, narrow = hpcg_cg_flat(mg, mg.b, iterations=ITERATIONS)
            del mg
            torch.cuda.empty_cache()
            mg = HPCGMGPreconditioner(shape, parts, SerialBackend(P), n_levels=LEVELS,
                                      dtype=dtype, device=device)
            rec["profiled_set_float32_values"] = _profile_set(
                lambda: hpcg_cg_flat(mg, mg.b, iterations=ITERATIONS), top=8,
                kernels=("gs_seq", "ax_core"))
            _, wide = hpcg_cg_flat(mg, mg.b, iterations=ITERATIONS)
            diff = ((narrow - wide).abs() / wide.abs()).max().item()
            rec["history_vs_float32_values_max_rel_diff"] = diff
            if not diff <= PRECOND_HISTORY_RTOL:
                failures.append(f"{key}: history differs from float32 values by {diff}")
        emit(f"4i {key}", rec)
        if route != ("df64" if precision else "flat" if P == 1 else "flat_g"):
            failures.append(f"{key}: the benchmark took the {route} CG")
        if s["precond_values_dtype"] != values:
            failures.append(f"{key}: report says {s['precond_values_dtype']}")
        if not s["final_relres"] <= limit:
            failures.append(f"{key}: relres {s['final_relres']} > {limit}")
        if not (s["validation_passed"] and s["chain_consistent"]):
            failures.append(f"{key}: HPCG validation or chain consistency failed")
        del mg, report
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))

    # the kernels: K4 and K3 at the 128^3 level, K2 at one color of the
    # (2,2,2) x 64^3 level, random values of the 27-point pattern
    g = torch.Generator().manual_seed(1111)
    hpcg_errs = {}
    for values, vectors in NARROW_PAIRS:
        dtype = getattr(torch, vectors)
        A, b = build_hpcg_problem(LOCAL, (1, 1, 1), SerialBackend(1), dtype=dtype, device=device)
        col, full = _random_colored(A, getattr(torch, values), g)
        _hold_narrow(results, f"random values, one part of {LOCAL[0]}^3", col, full, g, device)
        hpcg_errs[f"{values}/{vectors} one part"] = _narrow_on_hpcg(A, b, values, g, device)
        del A, b, col, full
        torch.cuda.empty_cache()
        A, b = build_hpcg_problem(GHOST_LOCAL, GHOST_PARTS, SerialBackend(8), dtype=dtype,
                                  device=device)
        col, full = _random_colored(A, getattr(torch, values), g)
        _hold_k2_narrow(results, (full, col), g, device)
        hpcg_errs[f"{values}/{vectors} (2,2,2)"] = _narrow_on_hpcg(A, b, values, g, device)
        del A, b, col, full
        torch.cuda.empty_cache()
    emit("4i kernels narrow values", {"rows": results, "hpcg_values_vs_full": hpcg_errs,
                                      "hpcg_rtol": NARROW_HPCG_RTOL})
    return launches, results


def _cross_amg_box_parts(device):
    """The box AMG-CG on (2,2,2) parts of 8^3 (the ghosted flat cycle) on
    the card against the CPU, float64: the residual norm after each
    iteration count from 0 to CROSS_ITERATIONS (``cg`` with rtol 0)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.gallery import laplacian_fdm
    from partitionedarrays_tpu_torch.psparse import psparse
    from partitionedarrays_tpu_torch.pvector import pvector_from_own
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
    from partitionedarrays_tpu_torch.solvers.krylov import cg

    I, J, V, rows, cols = laplacian_fdm(BOX_CROSS_PARTS_NODES, AMG_PARTS)
    rng = np.random.default_rng(17)
    own = [rng.standard_normal(li.n_own) for li in rows]
    hist = {}
    for dev in (device, torch.device("cpu")):
        A = psparse(I, J, V, rows, cols, SerialBackend(8), assembled=True, device=dev)
        M = AMGPreconditioner(A, AMGParams(coarse_size=10))
        b = pvector_from_own(own, A.row_prange, A.backend, device=dev)
        hist[dev.type] = np.array([
            float(cg(A, b, M=M, rtol=0.0, maxiter=k)[1].residual)
            for k in range(CROSS_ITERATIONS + 1)
        ])
    a, c = hist["cuda"], hist["cpu"]
    err = float(np.max(np.abs(a - c) / np.abs(c)))
    if not err <= CROSS_RTOL:
        raise AssertionError(f"box AMG-CG {AMG_PARTS}: cuda vs cpu differ by {err}")
    return {"max_rel_diff": err, "levels": [lev.A.shape[0] for lev in M.levels],
            "ghosted_flat": [lev.struct is not None and not M._flat_ok(l)
                             for l, lev in enumerate(M.levels[:-1])],
            "final_relres": float(c[-1] / c[0])}


def _cross_amg_box(device):
    """The box AMG-CG on the card against the CPU, float64, at 16^3: the
    residual norm after each iteration count from 0 to CROSS_ITERATIONS
    (``cg`` with rtol 0)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.gallery import laplacian_fdm
    from partitionedarrays_tpu_torch.psparse import psparse
    from partitionedarrays_tpu_torch.pvector import pvector_from_own
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
    from partitionedarrays_tpu_torch.solvers.krylov import cg

    I, J, V, rows, cols = laplacian_fdm(BOX_CROSS_NODES, (1, 1, 1))
    own = np.random.default_rng(16).standard_normal(int(np.prod(BOX_CROSS_NODES)))
    hist = {}
    for dev in (device, torch.device("cpu")):
        A = psparse(I, J, V, rows, cols, SerialBackend(1), device=dev)
        M = AMGPreconditioner(A, AMGParams(coarse_size=10))
        b = pvector_from_own([own], A.row_prange, A.backend, device=dev)
        hist[dev.type] = np.array([
            float(cg(A, b, M=M, rtol=0.0, maxiter=k)[1].residual)
            for k in range(CROSS_ITERATIONS + 1)
        ])
    a, c = hist["cuda"], hist["cpu"]
    err = float(np.max(np.abs(a - c) / np.abs(c)))
    if not err <= CROSS_RTOL:
        raise AssertionError(f"box AMG-CG {BOX_CROSS_NODES}: cuda vs cpu differ by {err}")
    return {"max_rel_diff": err, "levels": [lev.A.shape[0] for lev in M.levels],
            "final_relres": float(c[-1] / c[0])}


def _cross_df64(device):
    """The df64 CG on the card against the CPU at (2,2,2) parts of 8^3,
    with the float32 MG and with no preconditioner."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_df64
    from partitionedarrays_tpu_torch.models.hpcg.driver import df64_problem
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner

    hist = {}
    for dev in (device, torch.device("cpu")):
        mg = HPCGMGPreconditioner(
            (8, 8, 8), GHOST_PARTS, SerialBackend(8), n_levels=CROSS_LEVELS,
            dtype=np.float32, device=dev,
        )
        A, b = df64_problem((8, 8, 8), GHOST_PARTS, mg.backend, dev)
        hist[dev.type] = {
            name: hpcg_cg_df64(A, b, M=M, iterations=CROSS_ITERATIONS)[1].cpu().numpy()
            for name, M in (("mg", mg), ("identity", None))
        }
    errs = {}
    for name, rtol in DF64_CROSS_RTOL.items():
        a, c = hist["cuda"][name], hist["cpu"][name]
        errs[name] = float(np.max(np.abs(a - c) / np.abs(c)))
        if not errs[name] <= rtol:
            raise AssertionError(f"df64 CG ({name}) (2,2,2)x8^3: cuda vs cpu differ by {errs[name]}")
    return {"max_rel_diff": errs, "rtol": DF64_CROSS_RTOL,
            "final_relres": float(hist["cpu"]["mg"][-1] / hist["cpu"]["mg"][0])}


def phase_cross(device):
    """The whole port on the card against the whole port on the CPU."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg, hpcg_cg_flat, hpcg_cg_flat_g
    from partitionedarrays_tpu_torch.models.hpcg.driver import cg_route
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner

    out = {}
    for shape, parts in CROSS_CASES:
        hist = {}
        for dev in (device, torch.device("cpu")):
            mg = HPCGMGPreconditioner(
                shape, parts, SerialBackend(int(np.prod(parts))), n_levels=CROSS_LEVELS,
                dtype=np.float64, device=dev,
            )
            flat_cg = hpcg_cg_flat if cg_route(mg) == "flat" else hpcg_cg_flat_g
            _, flat = flat_cg(mg, mg.b, iterations=CROSS_ITERATIONS)
            _, generic = hpcg_cg(mg.A, mg.b, M=mg, iterations=CROSS_ITERATIONS)
            hist[dev.type] = (flat.cpu().numpy(), generic.cpu().numpy())
        errs = {}
        for i, kind in enumerate((flat_cg.__name__, "hpcg_cg")):
            a, b = hist["cuda"][i], hist["cpu"][i]
            errs[kind] = float(np.max(np.abs(a - b) / np.abs(b)))
            if not errs[kind] <= CROSS_RTOL:
                raise AssertionError(f"{kind} {parts}x{shape}: cuda vs cpu differ by {errs[kind]}")
        out[f"{parts}x{shape[0]}^3"] = {
            "max_rel_diff": errs,
            "final_relres": float(hist["cpu"][0][-1] / hist["cpu"][0][0]),
        }
    out[f"df64 {GHOST_PARTS}x8^3"] = _cross_df64(device)
    out[f"amg_box {BOX_CROSS_NODES[0]}^3"] = _cross_amg_box(device)
    out[f"amg_box_parts {AMG_PARTS}x8^3"] = _cross_amg_box_parts(device)
    emit("6 cuda-vs-cpu", {
        "levels": CROSS_LEVELS, "iterations": CROSS_ITERATIONS, "rtol": CROSS_RTOL, "cases": out,
    })


def _nk_problem(device):
    """``NK_NODES`` on ``NK_PARTS``: A, the residual closure and x0, x*."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch import SerialBackend, plaplacian_fdm, pvector_from_own, spmv
    from partitionedarrays_tpu_torch.pvector import PVector

    A = plaplacian_fdm(NK_NODES, NK_PARTS, SerialBackend(int(np.prod(NK_PARTS))),
                       dtype=np.float64, device=device)
    pr = A.row_prange
    rng = np.random.default_rng(NK_SEED)
    x_star = pvector_from_own([0.3 * rng.standard_normal(li.n_own) for li in pr.parts], pr,
                              A.backend, device=device)
    b = spmv(A, x_star).own + x_star.own ** 3

    def residual(x):
        ax = spmv(A, x)
        return PVector(ax.own + x.own ** 3 - b, torch.zeros_like(ax.ghost), ax.layout,
                       ax.backend)

    x0 = pvector_from_own([np.zeros(li.n_own) for li in pr.parts], pr, A.backend,
                          device=device)
    return A, residual, x0, x_star


def _hold_tangent(results, where, kname, block, g, device):
    """The forward derivative of ``block.spmv`` (K1 or K5, ``ops/blocks.py``'s
    autograd Function: the kernel on the primal, then on the tangent) held
    against the plain product of the tangent, and timed (both launches)."""
    import torch
    import torch.autograd.forward_ad as fwAD

    from partitionedarrays_tpu_torch.ops.dia import dia_spmv_plain
    from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv_plain

    P = block.vals.shape[0]
    x = torch.randn(P, block.n_cols_pad, generator=g, dtype=block.vals.dtype).to(device)
    v = torch.randn(P, block.n_cols_pad, generator=g, dtype=block.vals.dtype).to(device)

    def tangent():
        with fwAD.dual_level():
            return fwAD.unpack_dual(block.spmv(fwAD.make_dual(x, v))).tangent

    if block.kind == "dia":
        plain = lambda: dia_spmv_plain(block.offsets, block.vals, v)  # noqa: E731
        nnz = block.vals.numel()
    else:
        plain = lambda: ghost_spmv_plain(  # noqa: E731
            block.rows, block.cols, block.vals, v, v.new_zeros((P, block.n_rows)))
        nnz = int((block.cols >= 0).sum())
    itemsize = x.element_size()
    # two products: the values read twice, x and v once each, y and y' written
    work = (itemsize * (2 * nnz + 2 * x.numel() + 2 * P * block.n_rows), 4 * nnz,
            F64_FLOPS_PER_S)
    _hold(results, kname, "float64", tangent, plain, work=work)
    results[-1].update(where=where, tangent=True)


def phase_newton_krylov(device, counters):
    """``newton_krylov`` (``NK_RUNS``) through the port's entry points on
    the card, each run's launch counts set to 0 just before it and read
    just after: outer iterations and |F| against the JAX package's on the
    CPU, max |x - x*|, seconds by CUDA events, a profiled run (device time,
    idle share, K1's and K5's launches); then the forward derivatives of
    K1 (the own-own block) and K5 (the own-ghost block) against the plain
    products of the tangent (not counted).  Returns (the path's launches,
    kernel rows)."""
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch import GaussSeidel, collect, newton_krylov

    A, residual, x0, x_star = _nk_problem(device)
    xs = collect(x_star)
    launches = {k: 0 for k in counters}
    failures, results = [], []
    for jvp, m_name, rtol, inner_rtol, jax_iters, jax_rn, x_limit in NK_RUNS:
        M = GaussSeidel(A, 1, "symmetric") if m_name == "gs" else None

        def run(M=M, jvp=jvp, rtol=rtol, inner_rtol=inner_rtol):
            return newton_krylov(residual, x0, M=M, rtol=rtol, maxiters=30,
                                 inner_rtol=inner_rtol, inner_maxiter=300, jvp=jvp)

        (x, iters, rn), secs, counts = _timed(counters, run)
        for k, v in counts.items():
            launches[k] += v
        profile = _profile_set(run, top=4, kernels=("dia_spmv_kernel", "ghost_spmv_kernel",
                                                    "gs_seq"))
        err = float(np.abs(collect(x) - xs).max())
        key = f"jvp={jvp} M={m_name or 'none'}"
        emit(f"4l newton_krylov {key}", {
            "rows": A.shape[0], "outer_iterations": int(iters), "jax_cpu_iterations": jax_iters,
            "rn": float(rn), "jax_cpu_rn": jax_rn, "max_abs_x_err": err, "limit": x_limit,
            "seconds": secs, "launches": counts, "profiled_run": profile,
            "idle_share": 1.0 - profile["device_ms"] / profile["profiled_wall_ms"],
        })
        if int(iters) != jax_iters:
            failures.append(f"{key}: {int(iters)} outer iterations, the JAX package's {jax_iters}")
        if not abs(float(rn) - jax_rn) <= NK_RN_RTOL * jax_rn:
            failures.append(f"{key}: |F| {float(rn)} against the JAX package's {jax_rn}")
        if not err <= x_limit:
            failures.append(f"{key}: max |x - x*| {err} > {x_limit}")
    g = torch.Generator().manual_seed(1515)
    dev = A.device()
    where = f"tangent of newton_krylov's residual, {NK_NODES[0]}^3 on {NK_PARTS}"
    _hold_tangent(results, f"own-own block, {where}", "dia_spmv", dev.oo, g, device)
    _hold_tangent(results, f"own-ghost block, {where}", "ghost_spmv", dev.oh, g, device)
    emit("4l kernels K1, K5 tangents", [
        {k: r.get(k) for k in ("kernel", "dtype", "where", "max_abs_err", "max_rel_err", "ms",
                               "device_ms", "bound_ms", "plain_ms")} for r in results])
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, results


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_multiprocess():
    """The multi-process tier (``MP_RUNS``): each group of ranks started as
    processes of ``tests/torch_multiprocess_driver.py`` on the card over a
    gloo group on localhost (host-staged messages: the ranks share one
    card, so these are not multi-GPU figures), every rank's exit code and
    checks, the modes' seconds, iterations and errors, and each mode's
    launches summed over the ranks (set to 0 just before the mode's
    multi-process path and read just after, in each rank).  Returns the
    launches by path (``mp_<mode>_<ranks>``) and, by kernel, the largest
    difference from its plain version that a rank's ``cg`` mode found on
    its ``[P_local, ...]`` tensors (K1, K5, K3)."""
    env = dict(os.environ)
    env.update(PYTHONPATH=str(MP_DRIVER.parent.parent) + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    launches, holds, failures = {}, {}, []
    for nproc, modes, kw in MP_RUNS:
        args = [f"{k}={v}" for k, v in dict(kw, device="cuda", timeout=MP_LIMIT).items()]
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(MP_DRIVER), str(r), str(nproc),
                                   str(port), modes, *args], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(nproc)]
        outs, codes = [], []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(MP_LIMIT - (time.perf_counter() - t0), 1))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += "\n<TIMEOUT>"
            outs.append(out)
            codes.append(p.returncode)
        wall = time.perf_counter() - t0
        results = []
        for r, (code, out) in enumerate(zip(codes, outs)):
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            if code != 0 or not lines:
                failures.append(f"{nproc} ranks, rank {r}: exit {code}: {out[-1500:]}")
                continue
            results.append(json.loads(lines[-1][len("RESULT "):]))
        if len(results) != nproc:
            continue
        for mode in modes.split(","):
            per_rank = [{k: v for k, v in res[mode].items() if k != "launches"}
                        for res in results]
            counts = {}
            for res in results:
                for k, v in res[mode]["launches"].items():
                    counts[k] = counts.get(k, 0) + v
            launches[f"mp_{mode}_{nproc}"] = counts
            for res in results:
                for k, h in res[mode].get("kernels_vs_plain", {}).items():
                    prev = holds.setdefault(k, {"max_abs_err": 0.0, "timed": {}})
                    prev["max_abs_err"] = max(prev["max_abs_err"], h["max_abs_err"])
                    t = prev["timed"].get(f"{nproc} ranks", {})
                    if "ms" in h and h["ms"] >= t.get("ms", 0.0):  # the slowest rank's
                        b_ms, b_by = bound(h["bytes"], h["ops"], F64_FLOPS_PER_S)
                        prev["timed"][f"{nproc} ranks"] = dict(
                            ms=h["ms"], library_ms=h["library_ms"], bound_ms=b_ms, bound_by=b_by,
                            shape=h["shape"])
            emit(f"4m multiprocess {mode} on {nproc} ranks (one card, gloo; not multi-GPU "
                 f"figures)", {"ranks": per_rank, "launches": counts})
        emit(f"4m multiprocess group of {nproc} ranks", {"wall_s": wall, "modes": modes})
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, holds


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
        from partitionedarrays_tpu_torch.utils import profiling
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable from here: {exc}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    seconds = {}  # the wall seconds of each phase, printed in phase 5

    @contextlib.contextmanager
    def timed(name):
        t0 = time.perf_counter()
        yield
        seconds[name] = round(time.perf_counter() - t0, 1)

    with timed("1-2 toolchain, build"):
        phase_toolchain()
        phase_build()
    with timed("3 kernels"):
        kernel_results = phase_kernels(device)
        kernel_results += phase_kernel_df(device)
    with timed("3c-3d K3, K4 levels"):
        k3_results, k4_results = phase_k3_levels(device)
        kernel_results += k3_results + k4_results

    counters = ("dia_spmv", "ax_core", "gs_sweeps", "dia_spmv_strided", "ghost_spmv",
                "dia_spmv_df", "tile_gs_sweeps")  # C entries, counted by profiling.COUNTS
    launches = {}
    for path, run_path in (
        ("one_part", phase_hpcg), ("ghosted", phase_hpcg_ghosted), ("df64", phase_hpcg_df64),
    ):
        profiling.reset_counts()
        with timed(f"4a-c {path}"):
            run_path(device)
        launches[path] = {k: profiling.launches(k) for k in counters}
    with timed("4d amg_elasticity"):
        launches["amg_elasticity"], k6_results = phase_amg_elasticity(device, counters)
    kernel_results += k6_results
    with timed("4n sorted_gs"):
        launches["sorted_gs"], sorted_results = phase_sorted_gs(device, counters)
    with timed("4e amg_box"):
        launches["amg_box"], launches["amg_box_df64"], box_results = phase_amg_box(
            device, counters)
    kernel_results += box_results
    with timed("4f parts"):
        (launches["amg_elasticity_parts"], launches["amg_box_parts"],
         parts_results) = phase_amg_parts(device, counters)
    kernel_results += parts_results
    with timed("4g reuse"):
        reuse_launches, reuse_results = phase_reuse(device, counters)
    launches.update(reuse_launches)
    kernel_results += reuse_results
    with timed("4h schwarz"):
        schwarz_launches, schwarz_results = phase_schwarz(device, counters)
    launches.update(schwarz_launches)
    kernel_results += schwarz_results
    with timed("4i precond_values"):
        launches["precond_values"], narrow_results = phase_precond_values(device, counters)
    with timed("4j partition utilities"):
        (launches["amg_unequal_parts"], launches["repartitioned"],
         unequal_results) = phase_partition_utilities(device, counters)
    kernel_results += unequal_results
    with timed("4k hpcg_float16"):
        launches["hpcg_float16"], f16_results = phase_hpcg_float16(device, counters)
    with timed("4k block_cg"):
        launches["block_cg"], block_results = phase_block_cg(device, counters)
    kernel_results += block_results
    with timed("4k utilities"):
        phase_utilities(device)
    with timed("4l newton_krylov"):
        launches["newton_krylov"], nk_results = phase_newton_krylov(device, counters)
    with timed("4m multiprocess"):
        mp_launches, mp_holds = phase_multiprocess()
        launches.update(mp_launches)
    emit("5 launches", launches)
    missing = [
        f"{path}:{k}" for path, names in PATH_KERNELS.items() for k in names
        if launches[path][k] <= 0
    ]
    if missing:
        raise AssertionError(f"kernels not launched on their path: {missing}")

    with timed("6 cuda-vs-cpu"):
        phase_cross(device)
    emit("5 phase seconds", seconds)

    # one row per kernel: its float32 measurement (K7: df64 at the 128^3
    # one-part shape; K6: a symmetric sweep of level 1 of the 40^3
    # elasticity hierarchy; K2, K5 and their library calls with the L2
    # flushed before each call), its launches over the thirty paths'
    # runs (calls of the kernel's C entry: K3 and K6 one per sweep sequence;
    # phase 4m's summed over the ranks);
    # K2, K3 and K4 also with bfloat16 values (phase 4i) and with float16
    # values (phase 4k) under float32 vectors, at the same shapes, with
    # their launches on the precond_values and hpcg_float16 paths; K1 and K5
    # also as tangent products (phase 4l, float64, with their launches on
    # the newton_krylov path); every kernel that phase 4m's ranks launched,
    # with those launches (``per_rank_launches``), and K1's, K5's and K3's
    # largest difference from their plain versions on a rank's parts
    # (``per_rank_max_abs_err``) with the slowest rank's time, bound and
    # library time on its parts in float64 (``per_rank``); K5 also on the
    # sorted tier's color slices (phase 4n, ``sorted_tier``)
    rows = []
    for kname, (source, replaces) in KERNELS.items():
        r = next(r for r in kernel_results
                 if r["kernel"] == kname and r["dtype"] in ("float32", "df64") and "ms" in r)
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches[path][kname] for path in launches),
            "max_abs_err": r["max_abs_err"], "ms": r.get("ms_flushed", r["ms"]),
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms_flushed", r.get("library_ms")),
        })
        tangent = [r for r in nk_results if r["kernel"] == kname]
        if tangent:
            t = tangent[0]
            rows[-1]["tangent"] = {
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "max_abs_err": t["max_abs_err"],
                "launches": launches["newton_krylov"][kname],
            }
        if kname == "ghost_spmv":
            t = next(r for r in sorted_results if r["dtype"] == "float32")
            rows[-1]["sorted_tier"] = {
                "ms": t["ms_flushed"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms_flushed"],
                "max_abs_err": t["max_abs_err"], "launches": launches["sorted_gs"][kname],
            }
        per_rank = sum(n.get(kname, 0) for path, n in launches.items() if path.startswith("mp_"))
        if per_rank:
            rows[-1]["per_rank_launches"] = per_rank
        if kname in mp_holds:
            rows[-1]["per_rank_max_abs_err"] = mp_holds[kname]["max_abs_err"]
            rows[-1]["per_rank"] = mp_holds[kname]["timed"]
        for tag, values, found, path in (("values_bf16", "bfloat16", narrow_results,
                                          "precond_values"),
                                         ("values_f16", "float16", f16_results, "hpcg_float16")):
            narrow = [r for r in found if r["kernel"] == kname
                      and r["values"] == values and r["dtype"] == "float32" and "ms" in r]
            if narrow:
                n = narrow[0]
                rows[-1][tag] = {
                    "ms": n.get("ms_flushed", n["ms"]), "plain_ms": n["plain_ms"],
                    "bound_ms": n["bound_ms"], "max_abs_err": n["max_abs_err"],
                    "launches": launches[path][kname],
                }
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
