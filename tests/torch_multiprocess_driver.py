"""One process of a multi-process run of the port, over ``torch.distributed``
(gloo): the counterpart of ``tests/multihost_driver.py``.

Usage::

    torch_multiprocess_driver.py RANK NPROC PORT MODE[,MODE...] [key=value ...]

Every process joins the group through ``with_multihost``, builds the same
problem on a ``MeshBackend`` (it holds its own parts only), runs it, and
checks its own shards against scipy and against the port's single-process
run of the same problem on ``SerialBackend(P)`` (made in the process, on
the same device): the same iteration counts and x within ``x_rtol``
relative.  It prints ``RESULT {json}`` (one entry per mode) on success
and exits nonzero on any mismatch.  Modes:

- ``cg``: the reference driver's main mode, ``build_hpcg_problem`` and a
  symmetric Gauss-Seidel preconditioned CG, with the timer's statistics
  across processes, and the process's K1, K5 and K3 launches on its parts
  held against their plain versions (``n``: local box edge, ``parts``:
  "px,py,pz");
- ``fail``: rank 1 raises after the group is up (every rank must end
  nonzero);
- ``fem``: the per-process FEM construction (``laplacian_fem(...,
  parts=)``, ``psparse_local``, ``pvector_local``), the shuffle's wire
  bytes against the local triplet bytes (``fem_nodes``, ``fem_grid``);
- ``gsslot``: the agreed-dims wave tile Gauss-Seidel on an operator
  without a DIA coloring;
- ``amg``: the per-process AMG setup, AMG-CG, one ``update`` and the CG
  after it, ``spmm_into`` and ``repartition_system`` onto uneven blocks (``amg_nodes``, ``amg_grid``, ``epsilon``, ``coarse``,
  ``amg_levels``);
- ``hpcg``: ``hpcg_benchmark_mpi`` (``hpcg_n``, ``hpcg_parts``,
  ``hpcg_levels``, ``hpcg_iterations``);
- ``hpcg_df64``: the same with ``precision="df64"``, every set's residual
  history bit-equal to the single-process run's;
- ``folds``: the reductions and host utilities that gather over all parts,
  each bit-equal to ``SerialBackend(P)``: ``pdot_df64`` and
  ``collect_df64`` of x = 1..40 on ``uniform_partition(P, 40)``,
  ``find_local_indices`` (every third id), ``sparse_diag_matrix``,
  ``renumber_pvector``, the COO ``pvector``, a GaussSeidel sweep on the
  sorted-by-color tier, and ``cg_df64`` on the 27-point operator of
  ``folds_n``^3 ids (``parts`` as "px,py,pz").

``device``: "cpu" (the tests) or "cuda" (every rank on the card
``rank % device_count``).  Each mode's entry has the kernels' launches of
its multi-process path (the counts set to 0 just before it and read just
after, before the single-process run), and the seconds of the mode.
"""
import contextlib
import json
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch


def _args():
    rank, nproc, port, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    kw = dict(a.split("=", 1) for a in sys.argv[5:])
    return rank, nproc, port, mode, kw


def _ints(s):
    return tuple(int(v) for v in s.split(","))


def _sync(device):
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _shards_vs(x_local, x_ref_local, tol, what):
    """The largest relative difference of this process's own values."""
    err = max((_rel(a, b) for a, b in zip(x_local, x_ref_local)), default=0.0)
    if not err <= tol:
        raise AssertionError(f"{what}: shards differ by {err:.3e} > {tol:.1e}")
    return err


KERNELS = ("dia_spmv", "ax_core", "gs_sweeps", "dia_spmv_strided", "ghost_spmv", "dia_spmv_df",
           "tile_gs_sweeps", "mg_restrict_core",
           "mg_prolong_core")  # the C entries, counted by profiling.COUNTS


def _count_from_zero():
    from partitionedarrays_tpu_torch.utils import profiling

    profiling.reset_counts()


def _counts():
    """The launches of each kernel since ``_count_from_zero``."""
    from partitionedarrays_tpu_torch.utils import profiling

    return {k: profiling.launches(k) for k in KERNELS}


def _local_own(v):
    return [o for o in v.own_values() if o is not None]


def _serial_own(v, local):
    own = v.own_values()
    return [own[p] for p in local]


def _hold_local_kernels(A, M, device, seed):
    """This process's K1 (own-own block), K5 (own-ghost block) and K3 (the
    smoother's sweep sequence) on its ``[P_local, ...]`` tensors, each
    against its plain version on the same random inputs: the largest
    difference of each, absolute and relative to the largest entry.
    Raises beyond 1e-12 (float64) or 1e-5 (float32) relative.  (On the
    CPU both sides are the plain version.)  On the card each kernel is also
    timed on those inputs (``_time_local``)."""
    from partitionedarrays_tpu_torch.ops.dia import dia_spmv_plain
    from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv_plain
    from partitionedarrays_tpu_torch.ops.gs_dia_kernels import gs_sweeps, gs_sweeps_plain

    g = torch.Generator().manual_seed(seed)
    dev = A.device()
    pairs, timed = [], {}
    for blk in (dev.oo, dev.oh):
        P = blk.vals.shape[0]
        x = torch.randn(P, blk.n_cols_pad, generator=g, dtype=blk.vals.dtype).to(device)
        if blk.kind == "dia":
            want = dia_spmv_plain(blk.offsets, blk.vals, x)
        else:
            want = ghost_spmv_plain(blk.rows, blk.cols, blk.vals, x, x.new_zeros((P, blk.n_rows)))
        name = "dia_spmv" if blk.kind == "dia" else "ghost_spmv"
        pairs.append((name, blk.spmv(x), want))
        timed[name] = (lambda blk=blk, x=x: blk.spmv(x), _block_work(blk),
                       _library_call(blk, x) if str(device).startswith("cuda") else None)
    col, order = M.colored, M._order_seq()
    shape = col.vals_d.shape[:2] + col.vals_d.shape[3:]
    x0, bd = (torch.randn(shape, generator=g, dtype=col.invd_d.dtype).to(device)
              for _ in range(2))
    pairs.append(("gs_sweeps", gs_sweeps(col.vals_d, bd, col.invd_d, x0, col.taps, order),
                  gs_sweeps_plain(col.vals_d, bd, col.invd_d, x0, col.taps, order)))
    itemsize = col.vals_d.element_size()
    timed["gs_sweeps"] = (
        lambda: gs_sweeps(col.vals_d, bd, col.invd_d, x0, col.taps, order),
        # each input read once (values, bd, D^-1, x), x written once; two
        # operations a value a step of its color
        (itemsize * (col.vals_d.numel() + 4 * x0.numel()),
         2 * col.vals_d.numel() * len(order) // col.m), None)
    out = {}
    for name, got, want in pairs:
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-300)
        tol = 1e-12 if want.dtype == torch.float64 else 1e-5
        if not rel <= tol:
            raise AssertionError(f"{name} on this process's parts: {rel:.3e} > {tol:.0e} "
                                 "relative to its plain version")
        prev = out.get(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
        out[name] = {"max_abs_err": max(err, prev["max_abs_err"]),
                     "max_rel_err": max(rel, prev["max_rel_err"]), "shape": list(got.shape)}
    if str(device).startswith("cuda"):
        for name, (fn, (nbytes, ops), lib) in timed.items():
            out[name].update(ms=_time_local(fn), bytes=nbytes, ops=ops,
                             library_ms=None if lib is None else _time_local(lib))
    return out


def _time_local(fn, reps=20):
    """Mean ms of ``fn()`` on the card by CUDA events over ``reps`` calls
    back to back, after two warm calls."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _block_work(blk):
    """(bytes, operations) of a block's SpMV: each input read once (the
    values, a compressed row's columns and rows, x) and y written once; two
    operations an entry."""
    P, item = blk.vals.shape[0], blk.vals.element_size()
    if blk.kind == "dia":
        nnz = blk.vals.numel()
        return item * (nnz + P * blk.n_cols_pad + P * blk.n_rows), 2 * nnz
    nnz = int((blk.cols >= 0).sum())
    n_live = int((blk.rows >= 0).sum())
    return item * (nnz + P * blk.n_cols_pad + 2 * n_live) + 4 * (nnz + n_live), 2 * nnz


def _library_call(blk, x):
    """One ``torch.sparse`` CSR ``mv`` of the same product over the stacked
    parts (a block-diagonal matrix of ``P`` blocks)."""
    P, R, n_cols = x.shape[0], blk.n_rows, blk.n_cols_pad
    part = torch.arange(P, device=x.device)
    if blk.kind == "dia":
        r = torch.arange(R, device=x.device)
        rows, cols, vals = [], [], []
        for d, o in enumerate(blk.offsets):
            ok = (r + o >= 0) & (r + o < n_cols)
            rows.append(part.view(P, 1) * R + r[ok].view(1, -1))
            cols.append(part.view(P, 1) * n_cols + (r[ok] + o).view(1, -1))
            vals.append(blk.vals[:, d, ok])
        rows, cols, vals = (torch.cat(t, dim=1) for t in (rows, cols, vals))
        live = torch.ones_like(rows, dtype=torch.bool)
    else:
        K, Nr = blk.cols.shape[1:]
        rows = (part.view(P, 1, 1) * R + blk.rows.view(P, 1, Nr)).expand(P, K, Nr).reshape(P, -1)
        cols = (part.view(P, 1, 1) * n_cols + blk.cols).reshape(P, -1)
        live = (blk.cols >= 0).reshape(P, -1)
        vals = blk.vals.reshape(P, -1)
    csr = torch.sparse_coo_tensor(torch.stack([rows[live], cols[live]]), vals[live],
                                  (P * R, P * n_cols)).coalesce().to_sparse_csr()
    xf = x.reshape(-1)
    return lambda: torch.mv(csr, xf)


def mode_cg(backend, kw, device):
    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
    from partitionedarrays_tpu_torch.psparse import gather_global_scipy
    from partitionedarrays_tpu_torch.solvers.krylov import cg
    from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel
    from partitionedarrays_tpu_torch.utils.ptimer import PTimer

    n = int(kw.get("n", 6))
    parts = _ints(kw.get("parts", f"1,1,{backend.n_parts}"))
    dtype = np.dtype(kw.get("dtype", "float64"))
    rtol = float(kw.get("rtol", 1e-8))
    timer = PTimer(device=device)
    _count_from_zero()
    timer.tic("setup")
    A, b = build_hpcg_problem((n, n, n), parts, backend, dtype=dtype, device=device)
    M = GaussSeidel(A, 1, "symmetric")
    timer.toc("setup")
    timer.tic("solve")
    x, info = cg(A, b, M=M, rtol=rtol, maxiter=500)
    timer.toc("solve")
    launches = _counts()
    kernels = _hold_local_kernels(A, M, device, seed=backend.rank)
    stats = timer.gather_statistics(backend)
    assert stats["setup"]["procs"] == backend.n_procs, "the timer did not span the processes"
    assert stats["solve"]["min"] <= stats["solve"]["avg"] <= stats["solve"]["max"]
    timer.print_main(backend)
    out = {"iterations": int(info.iterations), "solve_s": stats["solve"]["max"],
           "setup_s": stats["setup"]["max"], "rows": A.shape[0], "launches": launches,
           "kernels_vs_plain": kernels}
    local = backend.local_parts()
    # the single-process run of the same problem
    As, bs = build_hpcg_problem((n, n, n), parts, SerialBackend(backend.n_parts), dtype=dtype,
                                device=device)
    Ms = GaussSeidel(As, 1, "symmetric")
    _sync(device)
    t0 = time.perf_counter()
    xs, infos = cg(As, bs, M=Ms, rtol=rtol, maxiter=500)
    _sync(device)
    out["serial_solve_s"] = time.perf_counter() - t0
    assert int(infos.iterations) == out["iterations"], (
        f"iterations {out['iterations']} against the serial run's {int(infos.iterations)}")
    out["x_vs_serial"] = _shards_vs(_local_own(x), _serial_own(xs, local),
                                    float(kw.get("x_rtol", 1e-9)), "x against the serial run")
    if A.shape[0] <= 50_000:
        import scipy.sparse.linalg as spla

        G = gather_global_scipy(A)
        bg = 26.0 - (G.getnnz(axis=1) - 1)
        xg = spla.spsolve(G.tocsc(), bg)
        pr = A.row_prange
        for p, v in zip(local, _local_own(b)):
            assert np.array_equal(v, bg[pr.parts[p].own_to_global].astype(dtype)), "rhs shard"
        out["x_vs_scipy"] = _shards_vs(_local_own(x), [xg[pr.parts[p].own_to_global]
                                                       for p in local], 1e-6, "x against scipy")
    return out


def mode_fem(backend, kw, device):
    """The per-process FEM construction: each process makes its parts'
    triplets only; the off-owner ones cross processes in padded rounds."""
    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.gallery import laplacian_fem
    from partitionedarrays_tpu_torch.parallel.partition import INT, PRange
    from partitionedarrays_tpu_torch.psparse import psparse, psparse_local, spmv, to_global_scipy
    from partitionedarrays_tpu_torch.pvector import pones, pvector_local

    nodes = _ints(kw.get("fem_nodes", "33,33"))
    grid = _ints(kw.get("fem_grid", f"{backend.n_parts},1"))
    dtype = np.dtype(kw.get("fem_dtype", "float32")).type
    P, local = backend.n_parts, backend.local_parts()
    _count_from_zero()
    t0 = time.perf_counter()
    I, J, V, rows, cols = laplacian_fem(nodes, grid, dtype=dtype, parts=local)
    for p in range(P):
        assert (I[p] is not None) == (p in local), "a part of another process was made"
    A = psparse_local(I, J, V, PRange(rows), PRange(cols), backend, device=device)
    if backend.is_multiprocess:
        try:
            to_global_scipy(A)
        except ValueError:
            pass
        else:
            raise AssertionError("to_global_scipy took a per-process matrix")
    _sync(device)
    build_s = time.perf_counter() - t0
    st = dict(backend._last_local_build_stats)
    n_tri = sum(I[p].size for p in local)
    tri_bytes = n_tri * (2 * np.dtype(INT).itemsize + np.dtype(dtype).itemsize)
    frac = st["wire_bytes"] / tri_bytes
    assert st["cross_msgs"] > 0, "no triplet crossed processes"
    limit = float(kw.get("wire_limit", 0.10 if min(nodes) >= 65 else "inf"))
    assert frac < limit, f"wire bytes {frac:.2%} of the local triplet bytes"
    y = spmv(A, pones(A.col_prange, backend, dtype=dtype, device=device))
    b = pvector_local(I, V, PRange(rows), backend, dtype=dtype, device=device)
    launches = _counts()
    # the single-process construction of the same triplets
    Ia, Ja, Va, _, _ = laplacian_fem(nodes, grid, dtype=dtype)
    As = psparse(Ia, Ja, Va, PRange(rows), PRange(cols), SerialBackend(P), device=device)
    ys = spmv(As, pones(As.col_prange, As.backend, dtype=dtype, device=device))
    out = {"n_rows": A.shape[0], "wire_bytes": st["wire_bytes"], "triplet_bytes": tri_bytes,
           "wire_frac": frac, "rounds": st["n_rounds"], "cross_msgs": st["cross_msgs"],
           "build_s": build_s, "oo_kind": A.device().oo.kind, "launches": launches}
    tol = float(kw.get("fem_rtol", 1e-6 if dtype == np.float32 else 1e-12))
    out["Ax_vs_serial"] = _shards_vs(_local_own(y), _serial_own(ys, local), tol,
                                     "A 1 against the serial build")
    G = sp.csr_matrix((Va[0] if P == 1 else np.concatenate(Va),
                       (np.concatenate(Ia), np.concatenate(Ja))), shape=A.shape)
    ref = G.astype(np.float64) @ np.ones(A.shape[1])
    pr = A.row_prange
    out["Ax_vs_scipy"] = _shards_vs(_local_own(y), [ref[pr.parts[p].own_to_global]
                                                    for p in local], 1e-5, "A 1 against scipy")
    # the matrix triplets as vector contributions give b = A 1
    out["b_vs_Ax"] = _shards_vs(_local_own(b), _local_own(y), tol, "pvector_local")
    return out


def _fem_system(backend, nodes, grid, dtype, device, parts=None):
    """The FEM operator (per process, or on ``SerialBackend(P)`` with all
    parts), and b = A x* for x* from a seed."""
    from partitionedarrays_tpu_torch.models.gallery import laplacian_fem
    from partitionedarrays_tpu_torch.parallel.partition import PRange
    from partitionedarrays_tpu_torch.psparse import psparse
    from partitionedarrays_tpu_torch.pvector import pvector_from_own

    I, J, V, rows, cols = laplacian_fem(nodes, grid, dtype=dtype, parts=parts)
    A = psparse(I, J, V, PRange(rows), PRange(cols), backend, device=device)
    n = A.shape[0]
    xg = np.random.default_rng(0).standard_normal(n)
    Ia, Ja, Va, _, _ = laplacian_fem(nodes, grid, dtype=np.float64)
    G = sp.csr_matrix((np.concatenate(Va), (np.concatenate(Ia), np.concatenate(Ja))),
                      shape=(n, n))
    bg = G @ xg
    pr = A.row_prange
    b = pvector_from_own([bg[li.own_to_global].astype(dtype) for li in pr.parts], pr, backend,
                         dtype=dtype, device=device)
    return (I, J, V, rows, cols), A, b, xg


def mode_amg(backend, kw, device):
    """The per-process AMG: setup on each process's parts, AMG-CG, one
    ``update`` for 2 A (the aggregates reused, values refilled through the
    routes across processes) and the CG after it, and the reuse product
    ``spmm_into``; every number held to the single-process run."""
    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.parallel.partition import PRange, variable_partition
    from partitionedarrays_tpu_torch.psparse import (psparse, repartition_system, spmm,
                                                     spmm_into, spmv)
    from partitionedarrays_tpu_torch.pvector import pones
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
    from partitionedarrays_tpu_torch.solvers.krylov import cg

    nodes = _ints(kw.get("amg_nodes", "17,17"))
    grid = _ints(kw.get("amg_grid", f"{backend.n_parts},1"))
    dtype = np.dtype(kw.get("dtype", "float64")).type
    rtol = float(kw.get("rtol", 1e-8))
    params = AMGParams(coarse_size=int(kw.get("coarse", 12)),
                       max_levels=int(kw.get("amg_levels", 3)),
                       epsilon=float(kw.get("epsilon", 0.02)))
    x_rtol = float(kw.get("x_rtol", 1e-9))
    local = backend.local_parts()
    out = {}
    runs = {}
    for name, bk, parts in (("mp", backend, local), ("serial", SerialBackend(backend.n_parts),
                                                       None)):
        _count_from_zero()
        t0 = time.perf_counter()
        (I, J, V, rows, cols), A, b, xg = _fem_system(bk, nodes, grid, dtype, device, parts)
        M = AMGPreconditioner(A, params)
        _sync(device)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, info = cg(A, b, M=M, rtol=rtol, maxiter=200)
        _sync(device)
        solve_s = time.perf_counter() - t0
        aggs = [e[0] for e in M._aggs]
        V2 = [None if v is None else 2.0 * v for v in V]
        A2 = psparse(I, J, V2, PRange(rows), PRange(cols), bk, device=device)
        t0 = time.perf_counter()
        M.update(A2)
        _sync(device)
        update_s = time.perf_counter() - t0
        assert all(a is e[0] for a, e in zip(aggs, M._aggs)), "update aggregated again"
        x2, info2 = cg(A2, b, M=M, rtol=rtol, maxiter=200)
        launches = _counts()
        C, cache = spmm(A, A, reuse=True)
        spmm_into(C, A2, A2, cache)
        y = spmv(C, pones(C.col_prange, bk, dtype=dtype, device=device))
        # the system moved onto uneven blocks of ids (repartition_system)
        n, P = A.shape[0], backend.n_parts
        sizes = [n // P + (20 if p == 0 else 0) for p in range(P)]
        sizes[-1] = n - sum(sizes[:-1])
        A3, b3 = repartition_system(A, b, PRange(variable_partition(sizes, n)))
        y3 = spmv(A3, pones(A3.col_prange, bk, dtype=dtype, device=device))
        runs[name] = dict(x=x, x2=x2, y=y, y3=y3, b3=b3, it=int(info.iterations),
                          it2=int(info2.iterations),
                          levels=[lev.A.shape[0] for lev in M.levels], xg=xg,
                          setup_s=setup_s, solve_s=solve_s, update_s=update_s,
                          launches=launches)
    mp, se = runs["mp"], runs["serial"]
    assert mp["levels"] == se["levels"], f"levels {mp['levels']} against {se['levels']}"
    assert (mp["it"], mp["it2"]) == (se["it"], se["it2"]), (
        f"iterations {mp['it']}, {mp['it2']} against the serial run's {se['it']}, {se['it2']}")
    out.update(iterations=mp["it"], iterations_update=mp["it2"], levels=mp["levels"],
               setup_s=mp["setup_s"], solve_s=mp["solve_s"], update_s=mp["update_s"],
               serial_setup_s=se["setup_s"], serial_solve_s=se["solve_s"],
               serial_update_s=se["update_s"],
               rows=mp["x"].n_global, launches=mp["launches"])
    out["x_vs_serial"] = _shards_vs(_local_own(mp["x"]), _serial_own(se["x"], local), x_rtol,
                                    "AMG-CG x against the serial run")
    out["x_update_vs_serial"] = _shards_vs(_local_own(mp["x2"]), _serial_own(se["x2"], local),
                                           x_rtol, "x after update against the serial run")
    out["spmm_into_vs_serial"] = _shards_vs(_local_own(mp["y"]), _serial_own(se["y"], local),
                                            x_rtol, "spmm_into against the serial run")
    out["repartitioned_A1_vs_serial"] = _shards_vs(
        _local_own(mp["y3"]), _serial_own(se["y3"], local), x_rtol,
        "the repartitioned A 1 against the serial run")
    out["repartitioned_b_vs_serial"] = _shards_vs(
        _local_own(mp["b3"]), _serial_own(se["b3"], local), 0.0,
        "the repartitioned b against the serial run")
    pr = mp["x"].layout.pr
    xs = [mp["xg"][pr.parts[p].own_to_global] for p in local]
    out["x_vs_exact"] = _shards_vs(_local_own(mp["x"]), xs, 1e3 * rtol, "x against x*")
    out["x_update_vs_exact"] = _shards_vs([2 * v for v in _local_own(mp["x2"])], xs, 1e3 * rtol,
                                          "2 x after update against x*")
    return out


def _gsslot_blocks(P, sz):
    """Per-part random symmetric diagonally dominant blocks: the first half
    of the parts couple only inside 128-row tiles (their off-tile blocks are
    empty, so every choice of the wave tile GS must still be agreed), the
    others within 120 rows.  The operator has no DIA band."""
    blocks = []
    for p in range(P):
        rp = np.random.default_rng(300 + p)
        rows_l, cols_l, vals_l = [], [], []
        for r in range(sz):
            if p < P // 2:
                lo, hi = (r // 128) * 128, min(sz, (r // 128) * 128 + 128)
            else:
                lo, hi = max(0, r - 120), min(sz, r + 121)
            c = rp.choice(np.arange(lo, hi), size=min(9, hi - lo), replace=False)
            rows_l += [r] * len(c)
            cols_l += list(c)
            vals_l += list(rp.standard_normal(len(c)))
        Ab = sp.csr_matrix((vals_l, (rows_l, cols_l)), shape=(sz, sz))
        Ab = Ab + Ab.T
        blocks.append((Ab + sp.diags(np.abs(Ab).sum(1).A1 + 1.0)).tocoo())
    return blocks


def mode_gsslot(backend, kw, device):
    """The wave tile Gauss-Seidel on a per-process operator without a DIA
    coloring: the same W and B on every process (agreed), and each part's
    zero-guess forward sweep equal to scipy's triangular solve in the
    part's wave-major order and to the single-process sweep."""
    from scipy.sparse.linalg import spsolve_triangular

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.parallel.partition import PRange, uniform_partition
    from partitionedarrays_tpu_torch.psparse import psparse
    from partitionedarrays_tpu_torch.pvector import pvector_from_own
    from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

    P, local = backend.n_parts, backend.local_parts()
    sz = int(kw.get("rows", 1024))
    dtype = np.dtype(kw.get("dtype", "float64")).type
    blocks = _gsslot_blocks(P, sz)
    b_parts = [np.random.default_rng(7 + p).standard_normal(sz).astype(dtype) for p in range(P)]
    runs = {}
    for name, bk, parts in (("mp", backend, local), ("serial", SerialBackend(P), range(P))):
        I = [blocks[p].row + p * sz if p in parts else None for p in range(P)]
        J = [blocks[p].col + p * sz if p in parts else None for p in range(P)]
        V = [blocks[p].data.astype(dtype) if p in parts else None for p in range(P)]
        rows = PRange(uniform_partition((P,), (P * sz,)))
        A = psparse(I, J, V, rows, PRange(uniform_partition((P,), (P * sz,))), bk,
                    assembled=True, device=device)
        gs = GaussSeidel(A, iterations=1, sweep="forward")
        assert gs.colored is None and gs.tile_gs is not None, "the operator took the DIA tier"
        b = pvector_from_own(b_parts, A.row_prange, bk, dtype=dtype, device=device)
        _count_from_zero()
        runs[name] = (gs.tile_gs, gs(b), _counts())
    sgs, z, launches = runs["mp"]
    sgs_s, z_s, _ = runs["serial"]
    WB = backend.allgather_object((sgs.W, sgs.B))
    assert len(set(WB)) == 1 and sgs.B > 1, f"the processes' (W, B) {WB}"
    assert (sgs.W, sgs.B) == (sgs_s.W, sgs_s.B), "(W, B) differ from the serial run's"
    refs = []
    for k, p in enumerate(local):
        perm = np.concatenate([np.arange(t * 128, min((t + 1) * 128, sz))
                               for wave in sgs.schedules[k] for t in wave if t * 128 < sz])
        Ap = blocks[p].tocsr().astype(np.float64)[perm][:, perm]
        xp = spsolve_triangular(sp.tril(Ap).tocsr(), b_parts[p][perm].astype(np.float64),
                                lower=True)
        ref = np.empty_like(xp)
        ref[perm] = xp
        refs.append(ref)
    tol = 1e-12 if dtype == np.float64 else 5e-4
    out = {"W": sgs.W, "B": sgs.B, "launches": launches}
    out["z_vs_scipy"] = _shards_vs(_local_own(z), refs, tol, "GS sweep against scipy")
    out["z_vs_serial"] = _shards_vs(_local_own(z), _serial_own(z_s, local),
                                    float(kw.get("x_rtol", 1e-12)), "GS sweep against serial")
    return out


def mode_hpcg(backend, kw, device, precision=None):
    """``hpcg_benchmark_mpi`` over the processes: the residual history held
    to the single-process benchmark's (``hpcg_benchmark_debug``)."""
    from partitionedarrays_tpu_torch.models.hpcg import hpcg_benchmark_debug, hpcg_benchmark_mpi

    n = int(kw.get("hpcg_n", 8))
    parts = _ints(kw.get("hpcg_parts", "2,2,2"))
    args = dict(local_shape=(n, n, n), parts_per_dir=parts,
                n_levels=int(kw.get("hpcg_levels", 3)),
                iterations=int(kw.get("hpcg_iterations", 10)), ref_sets=1, timed_sets=1,
                dtype=np.dtype(kw.get("dtype", "float64")).type, device=device)
    if precision is not None:
        args["precision"] = precision
    with _recorded_df64_histories() as hist:
        _count_from_zero()
        r = hpcg_benchmark_mpi(backend.n_parts, **args).summary()
        launches = _counts()
        rs = hpcg_benchmark_debug(backend.n_parts, **args).summary()
    rel = abs(r["final_relres"] - rs["final_relres"]) / rs["final_relres"]
    tol = 0.0 if precision == "df64" else float(kw.get("x_rtol", 1e-9))
    assert r["validation_passed"] and rel <= tol, (
        f"relres {r['final_relres']} against the serial run's {rs['final_relres']}")
    out = {"final_relres": r["final_relres"], "relres_vs_serial": rel,
           "gflops_raw": r["GFLOPs"]["raw"], "time_solve_s": r["time_solve_s"],
           "serial_time_solve_s": rs["time_solve_s"], "nrow": r["nrow"],
           "launches": launches}
    if precision == "df64":
        # the sets of each run (reference, optimized, timed), in order
        half = len(hist) // 2
        assert half and all(torch.equal(a, b) for a, b in zip(hist[:half], hist[half:])), (
            "a df64 residual history differs from the serial run's")
        out.update(dtype=r["dtype"], history_sets=half, history_bit_equal=True)
    return out


def mode_hpcg_df64(backend, kw, device):
    """``hpcg_benchmark_mpi(precision="df64")``: every set's residual
    history bit-equal to the single-process benchmark's (the df64 dots fold
    their per-part pairs over all parts in part order)."""
    return mode_hpcg(backend, kw, device, precision="df64")


@contextlib.contextmanager
def _recorded_df64_histories():
    """Record the residual norms of every df64 CG set that the benchmark
    runs (a wrapper of ``hpcg_cg_df64`` as the driver module calls it)."""
    from partitionedarrays_tpu_torch.models.hpcg import driver

    hist, original = [], driver.hpcg_cg_df64

    def recording(*a, **k):
        out = original(*a, **k)
        hist.append(out[1].detach().cpu().clone())
        return out

    driver.hpcg_cg_df64 = recording
    try:
        yield hist
    finally:
        driver.hpcg_cg_df64 = original


def _folds(be, P, n, parts, device):
    """The ``folds`` results of backend ``be`` (every one gathered over all
    parts, so the same on every process)."""
    from partitionedarrays_tpu_torch.models.hpcg.problem import STENCIL_27PT
    from partitionedarrays_tpu_torch.ops import df64 as df
    from partitionedarrays_tpu_torch.ops.stencil import stencil_psparse
    from partitionedarrays_tpu_torch.parallel.partition import PRange, uniform_partition
    from partitionedarrays_tpu_torch.psparse import sparse_diag_matrix, spmv
    from partitionedarrays_tpu_torch.pvector import (collect, collect_df64, find_local_indices,
                                                     pdot, pdot_df64, pvector, pvector_df64,
                                                     pvector_from_own, pvector_split_df64,
                                                     renumber_pvector)
    from partitionedarrays_tpu_torch.solvers.krylov import cg_df64
    from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

    out = {}
    pr = PRange(uniform_partition(P, 40))
    x = pvector_from_own([(li.own_to_global + 1).astype(np.float64) for li in pr.parts], pr, be,
                         device=device)
    out["pdot"] = float(pdot(x, x))
    out["pdot_df64"] = df.to_f64(*pdot_df64(pvector_split_df64(x), pvector_split_df64(x))).item()
    out["collect_df64"] = collect_df64(pvector_split_df64(x))
    mask = pvector_from_own([(li.own_to_global % 3 == 0).astype(np.float64) for li in pr.parts],
                            pr, be, device=device)
    out["find_local_indices"] = find_local_indices(mask)
    out["sparse_diag_matrix"] = collect(spmv(sparse_diag_matrix(x), x))
    ren = renumber_pvector(x)
    out["renumber_pvector"] = (ren.layout.pr, collect(ren))
    # the COO vector: every part adds to its own ids and to the first id of
    # the next part (a ghost it gains), summed on the owners
    nxt = [pr.parts[(p + 1) % P].own_to_global[:1] for p in range(P)]
    I_parts = [np.concatenate([li.own_to_global, m]) for li, m in zip(pr.parts, nxt)]
    V_parts = [np.arange(i.size, dtype=np.float64) + 0.5 * li.part
               for i, li in zip(I_parts, pr.parts)]
    v = pvector(I_parts, V_parts, pr, be, device=device)
    out["pvector"] = (v.layout.pr, collect(v))
    # the df64 CG on the 27-point operator, and a sorted-by-color GS on it
    A = stencil_psparse(parts, (n, n, n), STENCIL_27PT, be, dtype=np.float64, device=device)
    rng = np.random.default_rng(42)
    b_own = [rng.standard_normal(li.n_own) for li in A.row_prange.parts]
    xs, info = cg_df64(A, pvector_df64(b_own, A.row_prange, be, device=device), rtol=1e-10,
                       maxiter=500)
    out["cg_df64"] = (int(info.iterations), collect_df64(xs))
    gs = GaussSeidel(A, 1, "symmetric", _sorted=True)
    out["sorted_gs"] = (gs.n_colors, collect(gs(pvector_from_own(b_own, A.row_prange, be,
                                                                 device=device))))
    return out


def _same(a, b, what):
    """``a`` equal to ``b`` bit for bit (arrays, numbers, partitions and
    tuples of them)."""
    if isinstance(a, tuple):
        for k, (u, w) in enumerate(zip(a, b)):
            _same(u, w, f"{what}[{k}]")
    elif hasattr(a, "parts"):
        for li, ls in zip(a.parts, b.parts):
            for name in ("own_to_global", "ghost_to_global", "ghost_to_owner"):
                if not np.array_equal(getattr(li, name), getattr(ls, name)):
                    raise AssertionError(f"{what}: part {li.part} {name} differs")
    elif not np.array_equal(np.asarray(a), np.asarray(b)):
        raise AssertionError(f"{what}: {a} against the serial {b}")


def mode_folds(backend, kw, device):
    """Every result of ``_folds`` on the processes equals the serial
    backend's bit for bit."""
    from partitionedarrays_tpu_torch.backends import SerialBackend

    P = backend.n_parts
    n = int(kw.get("folds_n", 8))
    parts = _ints(kw.get("parts", f"1,1,{P}"))
    _count_from_zero()
    got = _folds(backend, P, n, parts, device)
    launches = _counts()
    want = _folds(SerialBackend(P), P, n, parts, device)
    for key in want:
        _same(got[key], want[key], key)
    return {"pdot": got["pdot"], "pdot_df64": got["pdot_df64"],
            "selected": int(got["find_local_indices"][0].n_global),
            "cg_df64_iterations": got["cg_df64"][0], "sorted_colors": got["sorted_gs"][0],
            "launches": launches}


MODES = {"cg": mode_cg, "fem": mode_fem, "amg": mode_amg, "gsslot": mode_gsslot,
         "hpcg": mode_hpcg, "hpcg_df64": mode_hpcg_df64, "folds": mode_folds}


def main():
    rank, nproc, port, mode, kw = _args()
    device = kw.get("device", "cpu")
    torch.set_num_threads(int(kw.get("threads", 1)))
    from partitionedarrays_tpu_torch.backends import with_multihost

    backend = with_multihost(coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
                             process_id=rank, n_parts=int(kw.get("P", nproc)),
                             timeout=float(kw.get("timeout", 60)))
    assert backend.is_multiprocess and backend.local_parts()
    if device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    if mode == "fail":
        if rank == 1:
            raise RuntimeError("injected failure on rank 1")
        backend.barrier()  # blocks on the failed rank
        time.sleep(3600)
        return
    out = {}
    for m in mode.split(","):  # several modes share one process group
        t0 = time.perf_counter()
        out[m] = MODES[m](backend, kw, device)
        _sync(device)
        out[m]["seconds"] = time.perf_counter() - t0
    out.update(rank=rank, parts=backend.local_parts())
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "partitionedarrays_tpu"))
    assert not loaded, f"the port loaded {loaded}"
    print("RESULT " + json.dumps(out), flush=True)
    backend.barrier()


if __name__ == "__main__":
    main()
