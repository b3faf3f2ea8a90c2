"""The Newton and backward-Euler layers of the port against the JAX
package, float64: mirrors of ``tests/test_interfaces.py``'s Newton (A x +
x^3 = b) and backward Euler (du/dt = -u) cases, a Newton whose Jacobian is
refilled in place (the host LU must not keep the first Jacobian's
factors), and the implicit reaction-diffusion run of
``examples/implicit_reuse.py`` (the same user code on both packages) at
8^3 on (2,2,2) parts: the same Newton iterations per step and CG
iterations per solve, and the states within 1e-10 relative.
"""
import importlib
import os
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.solvers import interfaces as jax_if
from partitionedarrays_tpu.solvers import nonlinear as jax_nl
from partitionedarrays_tpu.solvers import ode as jax_ode

import partitionedarrays_tpu_torch as pt
from partitionedarrays_tpu_torch import psparse as ps
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.parallel.partition import PRange, uniform_partition
from partitionedarrays_tpu_torch.pvector import PVector, collect, pvector_from_own, pzeros
from partitionedarrays_tpu_torch.solvers import interfaces, nonlinear

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))
import implicit_reuse  # noqa: E402

jax_ps = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pv = importlib.import_module("partitionedarrays_tpu.pvector")
jax_kr = importlib.import_module("partitionedarrays_tpu.solvers.krylov")

jax_config.use_pallas = False


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield


def _newton_problem(pkg):
    """A x + x^3 = b on the (6, 6) FDM Laplacian on (2, 2) parts, with a
    known solution; the Jacobian is a new matrix each time (centralized
    and re-split), as in the reference's test."""
    gal = gallery if pkg == "port" else jax_gallery
    I, J, V, rows, cols = gal.laplacian_fdm((6, 6), (2, 2))
    if pkg == "port":
        A = ps.psparse(I, J, V, rows, cols, SerialBackend(4), assembled=True, device="cpu")
        pr = A.row_prange
        vec = lambda g: pvector_from_own([g[li.own_to_global] for li in pr.parts], pr, A.backend,
                                         device="cpu")
        spmv = ps.spmv
        diag = lambda d: ps.sparse_diag_matrix(d, pr)
        from_global = lambda G: ps.psparse_from_global(G, pr, pr, A.backend, device="cpu")
    else:
        A = jax_ps.psparse(I, J, V, JaxPRange(rows), JaxPRange(cols), JaxSerialBackend(4),
                           assembled=True)
        pr = A.row_prange
        vec = lambda g: jax_pv.pvector_from_own([g[li.own_to_global] for li in pr.partition()],
                                                pr, A.backend, dtype=np.float64)
        spmv = lambda A_, x: jax_ps.spmv(A_, jax_kr._as_col_vector(A_, x))
        diag = lambda d: jax_ps.sparse_diag_matrix(d, pr)
        from_global = lambda G: jax_ps.psparse_from_global(G, pr, pr, A.backend)
    G = (ps if pkg == "port" else jax_ps).to_global_scipy(A)
    x_star = np.linspace(-0.5, 0.5, A.shape[0])
    b = vec(G @ x_star + x_star ** 3)

    def residual(x):
        Ax = spmv(A, x)
        return type(x)(Ax.own + x.own ** 3 - b.own, Ax.ghost, Ax.layout, Ax.backend)

    def jacobian(x):
        D = diag(type(x)(3.0 * x.own ** 2, x.ghost * 0, x.layout, x.backend))
        return from_global(G + (ps if pkg == "port" else jax_ps).to_global_scipy(D))

    return residual, jacobian, vec(np.zeros(A.shape[0])), x_star


def test_newton_raphson_matches_jax():
    res, jac, x0, x_star = _newton_problem("port")
    x, info = nonlinear.newton_raphson(interfaces.NonlinearProblem(res, jac, x0), rtol=1e-12,
                                       maxiters=30)
    res_r, jac_r, x0_r, _ = _newton_problem("jax")
    x_r, info_r = jax_nl.newton_raphson(jax_if.NonlinearProblem(res_r, jac_r, x0_r), rtol=1e-12,
                                        maxiters=30)
    assert info.converged and info_r.converged
    assert info.iterations == info_r.iterations < 15
    assert np.linalg.norm(collect(x) - x_star) < 1e-8
    np.testing.assert_allclose(collect(x), np.asarray(jax_pv.collect(x_r)), rtol=0, atol=1e-12)
    assert [t[0] for t in info.trace] == [t[0] for t in info_r.trace]
    np.testing.assert_allclose([t[1] for t in info.trace], [t[1] for t in info_r.trace],
                               rtol=0, atol=1e-10 * info.trace[0][1])


def test_newton_refilled_jacobian_refactors():
    """The Jacobian refilled in place through ``psparse_refill`` each
    Newton step: the default host LU sees the new values
    (``values_version``), and Newton converges as with new matrices."""
    I, J, V, rows, cols = gallery.laplacian_fdm((6, 6), (2, 2))
    A, cache = ps.psparse(I, J, V, rows, cols, SerialBackend(4), assembled=True, reuse=True,
                          device="cpu")
    G = ps.to_global_scipy(A)
    x_star = np.linspace(-0.5, 0.5, A.shape[0])
    pr = A.row_prange
    b = pvector_from_own([(G @ x_star + x_star ** 3)[li.own_to_global] for li in pr.parts], pr,
                         A.backend, device="cpu")
    K = ps.psparse(I, J, V, rows, cols, SerialBackend(4), assembled=True, device="cpu")
    is_diag = [np.asarray(i) == np.asarray(j) for i, j in zip(I, J)]

    def residual(x):
        Ax = ps.spmv(K, x)
        return PVector(Ax.own + x.own ** 3 - b.own, Ax.ghost, Ax.layout, Ax.backend)

    def jacobian(x):
        xg = collect(x)
        pt.psparse_refill(A, [v + d * 3.0 * xg[np.asarray(i)] ** 2
                              for i, v, d in zip(I, V, is_diag)], cache)
        return A

    x, info = pt.newton_raphson(interfaces.NonlinearProblem(
        residual, jacobian, pzeros(pr, A.backend, dtype=torch.float64, device="cpu")),
        rtol=1e-12, maxiters=30)
    res0, jac0, x0, _ = _newton_problem("port")
    _, info0 = nonlinear.newton_raphson(interfaces.NonlinearProblem(res0, jac0, x0), rtol=1e-12,
                                        maxiters=30)
    assert info.converged and info.iterations == info0.iterations
    assert np.linalg.norm(collect(x) - x_star) < 1e-8


def test_backward_euler_matches_jax():
    """du/dt = -u, u(0) = 1: u_N = (1 + dt)^-N exactly, in both packages."""
    dt = 0.05
    out = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            pr = PRange(uniform_partition((4,), (16,)))
            u0 = pt.pones(pr, SerialBackend(4), dtype=torch.float64, device="cpu")
            fill = lambda c: pvector_from_own([np.full(li.n_own, c) for li in pr.parts], pr,
                                              u0.backend, device="cpu")
            diag, Prob, be, coll = ps.sparse_diag_matrix, interfaces.ODEProblem, \
                pt.backward_euler, collect
        else:
            from partitionedarrays_tpu.parallel.p_range import uniform_partition as jax_up

            pr = JaxPRange(jax_up(4, 16))
            u0 = jax_pv.pones(pr, JaxSerialBackend(4), dtype=np.float64)
            fill = lambda c: jax_pv.pvector_from_own([np.full(li.n_own, c)
                                                      for li in pr.partition()], pr, u0.backend,
                                                     dtype=np.float64)
            diag, Prob, be, coll = jax_ps.sparse_diag_matrix, jax_if.ODEProblem, \
                jax_ode.backward_euler, jax_pv.collect

        def residual(t, x, v):
            return type(x)(v.own + x.own, x.ghost * 0, x.layout, x.backend)

        def jacobian(t, x, v, coeffs, fill=fill, diag=diag, pr=pr):
            return diag(fill(coeffs[0] + coeffs[1]), pr)

        steps = list(be(Prob(residual, jacobian, u0, (0.0, 1.0)), dt))
        out.append((steps, np.asarray(coll(steps[-1][1]))))
    (steps, u), (steps_r, u_r) = out
    assert len(steps) == len(steps_r) == 20
    np.testing.assert_allclose(u, (1 + dt) ** -20, atol=1e-10)
    np.testing.assert_allclose(u, u_r, rtol=0, atol=1e-15)
    np.testing.assert_allclose([t for t, _ in steps], [t for t, _ in steps_r], rtol=0, atol=0)


def test_reaction_diffusion_matches_jax():
    """The implicit reaction-diffusion run at 8^3 on (2,2,2) parts: the
    AMG built at the first Jacobian and updated at every later one; the
    same Newton and CG iterations as the reference (whose CG is compiled
    anew for each solve: a cached one keeps a box level's old D^-1, ROADMAP
    Queue 3), the state within 1e-10, every linear solve's true residual
    within 1e-9."""
    kw = dict(nodes=(8, 8, 8), parts=(2, 2, 2))
    got = implicit_reuse.reaction_diffusion(implicit_reuse.port("cpu"), **kw)
    want = implicit_reuse.reaction_diffusion(implicit_reuse.reference(), **kw)
    assert got["newton"] == want["newton"] and len(got["newton"]) == 3
    assert got["cg"] == want["cg"] and len(got["cg"]) == sum(got["newton"])
    assert max(got["relres"]) < 1e-9
    assert len(got["seconds"]["update"]) == len(got["cg"]) - 1
    u, u_ref = collect(got["u"]), np.asarray(jax_pv.collect(want["u"]))
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-10 * np.abs(u_ref).max())
    M = got["M"]
    assert M.levels[0].A is got["J"] and all(lev.struct is not None for lev in M.levels[:-1])
