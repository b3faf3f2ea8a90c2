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
  ``hpcg_levels``, ``hpcg_iterations``).

``device``: "cpu" (the tests) or "cuda" (every rank on the card
``rank % device_count``).  Each mode's entry has the kernels' launches of
its multi-process path (the counts set to 0 just before it and read just
after, before the single-process run), and the seconds of the mode.
"""
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


def _kernels():
    """The kernel wrappers, whose ``launches`` count their launches."""
    from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_df, dia_spmv_strided
    from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv
    from partitionedarrays_tpu_torch.ops.gs_dia_kernels import ax_core, gs_sweeps
    from partitionedarrays_tpu_torch.ops.tile_gs import tile_gs_sweeps

    return {"dia_spmv": dia_spmv, "ax_core": ax_core, "gs_sweeps": gs_sweeps,
            "dia_spmv_strided": dia_spmv_strided, "ghost_spmv": ghost_spmv,
            "dia_spmv_df": dia_spmv_df, "tile_gs_sweeps": tile_gs_sweeps}


def _count_from_zero():
    for fn in _kernels().values():
        fn.launches = 0


def _counts():
    """The launches of each kernel since ``_count_from_zero``."""
    return {k: fn.launches for k, fn in _kernels().items()}


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
    CPU both sides are the plain version.)"""
    from partitionedarrays_tpu_torch.ops.dia import dia_spmv_plain
    from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv_plain
    from partitionedarrays_tpu_torch.ops.gs_dia_kernels import gs_sweeps, gs_sweeps_plain

    g = torch.Generator().manual_seed(seed)
    dev = A.device()
    pairs = []
    for blk in (dev.oo, dev.oh):
        P = blk.vals.shape[0]
        x = torch.randn(P, blk.n_cols_pad, generator=g, dtype=blk.vals.dtype).to(device)
        if blk.kind == "dia":
            want = dia_spmv_plain(blk.offsets, blk.vals, x)
        else:
            want = ghost_spmv_plain(blk.rows, blk.cols, blk.vals, x, x.new_zeros((P, blk.n_rows)))
        pairs.append(("dia_spmv" if blk.kind == "dia" else "ghost_spmv", blk.spmv(x), want))
    col, order = M.colored, M._order_seq()
    shape = col.vals_d.shape[:2] + col.vals_d.shape[3:]
    x0, bd = (torch.randn(shape, generator=g, dtype=col.invd_d.dtype).to(device)
              for _ in range(2))
    pairs.append(("gs_sweeps", gs_sweeps(col.vals_d, bd, col.invd_d, x0, col.taps, order),
                  gs_sweeps_plain(col.vals_d, bd, col.invd_d, x0, col.taps, order)))
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
    return out


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


def mode_hpcg(backend, kw, device):
    """``hpcg_benchmark_mpi`` over the processes: the residual history held
    to the single-process benchmark's (``hpcg_benchmark_debug``)."""
    from partitionedarrays_tpu_torch.models.hpcg import hpcg_benchmark_debug, hpcg_benchmark_mpi

    n = int(kw.get("hpcg_n", 8))
    parts = _ints(kw.get("hpcg_parts", "2,2,2"))
    args = dict(local_shape=(n, n, n), parts_per_dir=parts,
                n_levels=int(kw.get("hpcg_levels", 3)),
                iterations=int(kw.get("hpcg_iterations", 10)), ref_sets=1, timed_sets=1,
                dtype=np.dtype(kw.get("dtype", "float64")).type, device=device)
    _count_from_zero()
    r = hpcg_benchmark_mpi(backend.n_parts, **args).summary()
    launches = _counts()
    rs = hpcg_benchmark_debug(backend.n_parts, **args).summary()
    rel = abs(r["final_relres"] - rs["final_relres"]) / rs["final_relres"]
    tol = float(kw.get("x_rtol", 1e-9))
    assert r["validation_passed"] and rel <= tol, (
        f"relres {r['final_relres']} against the serial run's {rs['final_relres']}")
    return {"final_relres": r["final_relres"], "relres_vs_serial": rel,
            "gflops_raw": r["GFLOPs"]["raw"], "time_solve_s": r["time_solve_s"],
            "serial_time_solve_s": rs["time_solve_s"], "nrow": r["nrow"],
            "launches": launches}


MODES = {"cg": mode_cg, "fem": mode_fem, "amg": mode_amg, "gsslot": mode_gsslot,
         "hpcg": mode_hpcg}


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
