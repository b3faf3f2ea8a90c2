"""Implicit time stepping and Newton on the fixed-sparsity reuse tier: the
same user code on either package.

Three runs, each re-assembling its operator's values at fixed sparsity and
re-coarsening its AMG hierarchy (``M.update``) instead of setting it up
again:

- ``reaction_diffusion``: u_t - Delta_h u + c u^3 = 0 on the 64^3 grid of
  ``laplacian_fdm`` (K, scaled by alpha = 65^3 in the gallery) on (2,2,2)
  parts, c = alpha, u0 uniform in [0, 1) from ``default_rng(0)`` by global
  id; ``backward_euler`` with dt = 1e-2 over (0, 0.03), ``newton_raphson``
  to rtol 1e-8 (at most 10 iterations), each Jacobian a_v I + a_x (K +
  3 c diag(u^2)) refilled into the matrix of the first one
  (``psparse_refill``), and CG to rtol 1e-10 preconditioned by one
  ``AMGPreconditioner(J, AMGParams(coarse_size=200))``, built at the first
  Jacobian and updated at every later one;
- ``newton_reuse``: the 64^3 float32 Laplacian on one part, ``psparse(...,
  reuse=True)``, the AMG, a refill with 1.1 V and ``update``, then CG to
  rtol 1e-8 on ones in the first 10 entries;
- ``elasticity_update``: 3-D Q1 elasticity (40^3 nodes, float32, one
  part, the rigid-body nullspace, ``AMGParams(coarse_size=400,
  block_size=3, max_levels=4)``) refilled with V + s [I = J], s a tenth of
  the mean diagonal (a lumped mass per element), ``update``, then CG to
  rtol 1e-8 on b = A 1.

    python examples/implicit_reuse.py --package jax [--nodes 16]
    python examples/implicit_reuse.py --package torch [--device cpu] [--nodes 16]

prints one JSON line per run: Newton iterations per step, CG iterations
per solve and the true residual of each solve (after an update, and with
a fresh setup on the refilled operator), and the host seconds of the
refills and updates.  With ``--package jax`` it runs the JAX package on
the CPU (Pallas off; the float32 elasticity with x64 off, as its tests
run it; each CG compiled anew, see ``reference``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def port(device="cuda") -> SimpleNamespace:
    """The entry points of ``partitionedarrays_tpu_torch`` on ``device``."""
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models import gallery
    from partitionedarrays_tpu_torch.psparse import psparse, psparse_refill, spmv, to_global_scipy
    from partitionedarrays_tpu_torch.pvector import PVector, collect, pvector_from_own
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
    from partitionedarrays_tpu_torch.solvers.interfaces import ODEProblem
    from partitionedarrays_tpu_torch.solvers.krylov import cg
    from partitionedarrays_tpu_torch.solvers.ode import backward_euler

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    return SimpleNamespace(
        gallery=gallery, SerialBackend=SerialBackend, PVector=PVector, collect=collect,
        psparse=lambda *a, **kw: psparse(*a, device=device, **kw),
        psparse_refill=psparse_refill, spmv=spmv, to_global_scipy=to_global_scipy,
        from_own=lambda own, pr, backend: pvector_from_own(own, pr, backend, device=device),
        AMGParams=AMGParams, AMGPreconditioner=AMGPreconditioner, cg=cg,
        ODEProblem=ODEProblem, backward_euler=backward_euler, sync=sync,
        float32_mode=contextlib.nullcontext,
    )


def reference(keep_jit_cache: bool = False) -> SimpleNamespace:
    """The same entry points of the JAX package, on the CPU with Pallas
    off.  Its ``cg`` keeps a compiled program per argument structure, and
    an AMG level's box transfer (omega, D^-1) is part of that structure,
    not an argument: after ``update`` a cached program would apply the old
    D^-1.  So each ``cg`` here starts from an empty cache, unless
    ``keep_jit_cache``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    from partitionedarrays_tpu import config
    from partitionedarrays_tpu.backends import SerialBackend
    from partitionedarrays_tpu.models import gallery
    from partitionedarrays_tpu.parallel.p_range import PRange
    from partitionedarrays_tpu.psparse import psparse, psparse_refill, spmv, to_global_scipy
    from partitionedarrays_tpu.pvector import PVector, collect, pvector_from_own
    from partitionedarrays_tpu.solvers.amg import AMGParams, AMGPreconditioner
    from partitionedarrays_tpu.solvers.interfaces import ODEProblem
    from partitionedarrays_tpu.solvers import krylov
    from partitionedarrays_tpu.solvers.ode import backward_euler

    def cg(*args, **kw):
        if not keep_jit_cache:
            krylov._jit_cache.clear()
        return krylov.cg(*args, **kw)

    config.use_pallas = False
    return SimpleNamespace(
        gallery=gallery, SerialBackend=SerialBackend, PVector=PVector, collect=collect,
        psparse=lambda I, J, V, rows, cols, *a, **kw: psparse(I, J, V, PRange(rows), PRange(cols),
                                                             *a, **kw),
        psparse_refill=psparse_refill, to_global_scipy=to_global_scipy,
        spmv=lambda A, x: spmv(A, krylov._as_col_vector(A, x)),
        from_own=pvector_from_own, AMGParams=AMGParams, AMGPreconditioner=AMGPreconditioner,
        cg=cg, ODEProblem=ODEProblem, backward_euler=backward_euler, sync=lambda: None,
        float32_mode=lambda: jax.enable_x64(False),
    )


class Times:
    """Host seconds of named steps (the package's device synchronized at
    both ends); a caller may pass another ``timer(name)`` context."""

    def __init__(self, ns):
        self.ns = ns
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name):
        self.ns.sync()
        t0 = time.perf_counter()
        yield
        self.ns.sync()
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


def _relres(ns, A, x, b) -> float:
    """|b - A x| / |b| in float64 on the host."""
    bg = ns.collect(b).astype(np.float64)
    return float(np.linalg.norm(bg - ns.collect(ns.spmv(A, x))) / np.linalg.norm(bg))


def _from_global(ns, g, pr, backend):
    parts = pr.parts if hasattr(pr, "parts") else pr.partition()
    return ns.from_own([g[li.own_to_global] for li in parts], pr, backend)


def reaction_diffusion(ns, nodes=(64, 64, 64), parts=(2, 2, 2), dt=1e-2, steps=3, seed=0,
                       newton_rtol=1e-8, newton_maxiters=10, cg_rtol=1e-10, cg_maxiter=200,
                       coarse_size=200, timer=None) -> dict:
    """The implicit reaction-diffusion run; returns its record (``newton``:
    iterations per step, ``cg``: iterations per solve, ``relres``: true
    residual per solve, ``seconds``) and its objects (K, J, M, u)."""
    timer = timer or Times(ns)
    backend = ns.SerialBackend(int(np.prod(parts)))
    I, J, V, rows, cols = ns.gallery.laplacian_fdm(nodes, parts)
    K = ns.psparse(I, J, V, rows, cols, backend, assembled=True)
    alpha = float(np.prod([n + 1 for n in nodes]))
    u0 = np.random.default_rng(seed).uniform(0.0, 1.0, int(np.prod(nodes)))
    diag = [np.asarray(i) == np.asarray(j) for i, j in zip(I, J)]
    out = {"newton": [], "cg": [], "relres": []}

    def residual(t, u, v):
        Ku = ns.spmv(K, u)
        return ns.PVector(v.own + Ku.own + alpha * u.own ** 3, Ku.ghost * 0, Ku.layout, Ku.backend)

    def jacobian(t, u, v, coeffs):
        a_x, a_v = coeffs
        ug = ns.collect(u)
        Vj = [a_x * np.asarray(vq) + d * (a_v + 3.0 * a_x * alpha * ug[np.asarray(iq)] ** 2)
              for iq, vq, d in zip(I, V, diag)]
        with timer("refill"):
            if "J" not in out:
                out["J"], out["cache"] = ns.psparse(I, J, Vj, rows, cols, backend,
                                                    assembled=True, reuse=True)
            else:
                ns.psparse_refill(out["J"], Vj, out["cache"])
        if not out["newton"] or out["newton"][-1][0] != t:
            out["newton"].append([t, 0])
        out["newton"][-1][1] += 1
        return out["J"]

    class AMGCG:
        """CG preconditioned by one AMG, updated at every later Jacobian."""

        def solve(self, p):
            if "M" not in out:
                with timer("setup"):
                    out["M"] = ns.AMGPreconditioner(p.A, ns.AMGParams(coarse_size=coarse_size))
            else:
                with timer("update"):
                    out["M"].update(p.A)
            with timer("solve"):
                x, info = ns.cg(p.A, p.b, M=out["M"], rtol=cg_rtol, maxiter=cg_maxiter)
            out["cg"].append(int(info.iterations))
            out["relres"].append(_relres(ns, p.A, x, p.b))
            return x

    ode = ns.ODEProblem(residual, jacobian, _from_global(ns, u0, K.row_prange, backend),
                        (0.0, steps * dt))
    for _, u in ns.backward_euler(ode, dt, solver=AMGCG(), rtol=newton_rtol,
                                  maxiters=newton_maxiters):
        out["u"] = u
    out["K"] = K
    out["newton"] = [n for _, n in out["newton"]]
    out["seconds"] = getattr(timer, "seconds", None)
    return out


def _laplacian_rhs(ns, A, dtype):
    """Ones in the first 10 own entries of part 0."""
    parts = A.row_prange.parts if hasattr(A.row_prange, "parts") else A.row_prange.partition()
    own = [np.zeros(li.n_own, dtype=dtype) for li in parts]
    own[0][:10] = 1.0
    return ns.from_own(own, A.row_prange, A.backend)


def newton_reuse(ns, nodes=(64, 64, 64), dtype=np.float32, scale=1.1, coarse_size=200,
                 rtol=1e-8, maxiter=100, timer=None, fresh=True) -> dict:
    """The reference's own measure of the reuse tier: cache build, refill
    with ``scale`` V, update, then CG (and, with ``fresh``, CG with a fresh
    setup on the refilled operator)."""
    timer = timer or Times(ns)
    I, J, V, rows, cols = ns.gallery.laplacian_fdm(nodes, (1, 1, 1), dtype=dtype)
    with timer("cache_build"):
        A, cache = ns.psparse(I, J, V, rows, cols, ns.SerialBackend(1), assembled=True,
                              reuse=True)
    with ns.float32_mode() if dtype == np.float32 else contextlib.nullcontext():
        with timer("setup"):
            M = ns.AMGPreconditioner(A, ns.AMGParams(coarse_size=coarse_size))
        V2 = [np.asarray(scale * v, dtype=dtype) for v in V]
        with timer("refill"):
            ns.psparse_refill(A, V2, cache)
        with timer("update"):
            M.update(A)
        b = _laplacian_rhs(ns, A, dtype)
        with timer("solve"):
            x, info = ns.cg(A, b, M=M, rtol=rtol, maxiter=maxiter)
        relres = _relres(ns, A, x, b)
        fresh_its = None
        if fresh:
            M2 = ns.AMGPreconditioner(A, ns.AMGParams(coarse_size=coarse_size))
            fresh_its = int(ns.cg(A, b, M=M2, rtol=rtol, maxiter=maxiter)[1].iterations)
    return {"A": A, "cache": cache, "M": M, "V2": V2, "b": b, "iterations": int(info.iterations),
            "fresh_iterations": fresh_its, "relres": relres,
            "seconds": getattr(timer, "seconds", None)}


def elasticity_update(ns, nodes=(40, 40, 40), dtype=np.float32, shift=0.1,
                      params=(("coarse_size", 400), ("block_size", 3), ("max_levels", 4)),
                      rtol=1e-8, maxiter=200, timer=None, fresh=True) -> dict:
    """3-D elasticity on one part: setup, a refill with the mass-like
    shift, update, then CG on b = A 1 (and, with ``fresh``, CG with a fresh
    setup on the refilled operator)."""
    timer = timer or Times(ns)
    I, J, V, rows, cols = ns.gallery.linear_elasticity_fem(nodes, (1, 1, 1), dtype=dtype)
    with timer("cache_build"):
        A, cache = ns.psparse(I, J, V, rows, cols, ns.SerialBackend(1), reuse=True)
    coords, _ = ns.gallery.node_coordinates_unit_cube(nodes, (1, 1, 1))
    null = ns.gallery.nullspace_linear_elasticity(coords, A.row_prange)
    with ns.float32_mode() if dtype == np.float32 else contextlib.nullcontext():
        with timer("setup"):
            M = ns.AMGPreconditioner(A, ns.AMGParams(**dict(params)), nullspace=null)
        s = shift * float(ns.to_global_scipy(A).diagonal().astype(np.float64).mean())
        V2 = [np.asarray(v + s * (np.asarray(i) == np.asarray(j)), dtype=dtype)
              for i, j, v in zip(I, J, V)]
        with timer("refill"):
            ns.psparse_refill(A, V2, cache)
        with timer("update"):
            M.update(A)
        parts = A.col_prange.parts if hasattr(A.col_prange, "parts") else A.col_prange.partition()
        ones = ns.from_own([np.ones(li.n_own, dtype=dtype) for li in parts], A.col_prange,
                           A.backend)
        b = ns.spmv(A, ones)
        with timer("solve"):
            x, info = ns.cg(A, b, M=M, rtol=rtol, maxiter=maxiter)
        relres = _relres(ns, A, x, b)
        fresh_its = None
        if fresh:
            M2 = ns.AMGPreconditioner(A, ns.AMGParams(**dict(params)), nullspace=null)
            fresh_its = int(ns.cg(A, b, M=M2, rtol=rtol, maxiter=maxiter)[1].iterations)
    return {"A": A, "cache": cache, "M": M, "V2": V2, "b": b, "shift": s, "nullspace": null,
            "iterations": int(info.iterations), "fresh_iterations": fresh_its,
            "relres": relres, "seconds": getattr(timer, "seconds", None)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=None,
                    help="nodes per direction of every run (default: 64, 64, 40)")
    ap.add_argument("--runs", default="reaction_diffusion,newton_reuse,elasticity_update")
    ap.add_argument("--keep-jit-cache", action="store_true",
                    help="with --package jax: keep its compiled CG across solves")
    args = ap.parse_args()
    ns = reference(args.keep_jit_cache) if args.package == "jax" else port(args.device)
    n = args.nodes
    for name in args.runs.split(","):
        if name == "reaction_diffusion":
            r = reaction_diffusion(ns, nodes=(n or 64,) * 3)
            line = {k: r[k] for k in ("newton", "cg", "relres", "seconds")}
        elif name == "newton_reuse":
            r = newton_reuse(ns, nodes=(n or 64,) * 3)
            line = {k: r[k] for k in ("iterations", "fresh_iterations", "relres", "seconds")}
        else:
            r = elasticity_update(ns, nodes=(n or 40,) * 3)
            line = {k: r[k] for k in ("iterations", "fresh_iterations", "relres", "shift",
                                      "seconds")}
        print(json.dumps({"run": name, "package": args.package, "nodes": n, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
