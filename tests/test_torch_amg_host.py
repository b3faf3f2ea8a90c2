"""The host setup of the port's SA-AMG (``solvers/amg.py``) against the JAX
reference's, function by function, on small gallery problems built by both
packages from bit-equal triplets: ``strength_graph``, ``aggregate`` (the
port's Python copy against the reference's, which may run its native
library), ``tentative_prolongator`` with and without a nullspace,
``spectral_radius``, ``smoothed_prolongator``, ``default_nullspace`` and a
hierarchy with the constant nullspace.  All of it is the same numpy/scipy
work, so the results must be equal bit for bit (omega to 1e-12).

Then the device cycle's remaining branches against the reference, float64
at 1e-10 of the largest entry: the W-cycle, and the LU coarse solve (a
coarsest level above 512 rows).  Where the reference's
``box_aggregate_psparse`` succeeds, the port builds the same structured
levels (their cycles: ``test_torch_amg_box_{f64,f32}.py``); with the
Schwarz level smoother the same box operator keeps no structured
transfer, and its levels and V-cycle match the reference's (1e-10).
"""
import importlib

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.solvers import amg as jax_amg

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.psparse import psparse
from partitionedarrays_tpu_torch.pvector import pvector_from_own
from partitionedarrays_tpu_torch.solvers import amg

import torch_amg_cases as cases

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)


# numpy's BLAS on one thread in this module: its idle threads spin, and
# beside the suite's other workers its small dense factorizations (tile
# inverses, QR, LU) then run up to ~30x slower
@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with threadpool_limits(limits=1):
        yield
    jax_config.use_pallas = saved


def build(name, nodes, dtype=np.float64):
    parts = (1,) * len(nodes)
    I, J, V, rows, cols = getattr(gallery, name)(nodes, parts, dtype=dtype)
    A = psparse(I, J, V, rows, cols, SerialBackend(1), device="cpu")
    Ir, Jr, Vr, rows_r, cols_r = getattr(jax_gallery, name)(nodes, parts, dtype=dtype)
    A_ref = jax_psparse.psparse(Ir, Jr, Vr, JaxPRange(rows_r), JaxPRange(cols_r), JaxSerialBackend(1))
    return A, A_ref


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("epsilon", [None, 0.0, 0.3, 2.0])
def test_strength_graph_matches(epsilon):
    A, _ = build("linear_elasticity_fem", (5, 4, 4))
    oo = A.blocks[0]["oo"]
    _same_csr(amg.strength_graph(oo, 3, epsilon), jax_amg.strength_graph(oo, 3, epsilon))
    _same_csr(amg.strength_graph(oo, 1, epsilon), jax_amg.strength_graph(oo, 1, epsilon))


@pytest.mark.parametrize("epsilon", [0.0, 0.05, 0.3])
@pytest.mark.parametrize("case", [("laplacian_fem", (9, 8)), ("linear_elasticity_fem", (5, 5, 4))])
def test_aggregates_match(case, epsilon):
    A, _ = build(*case)
    bs = len(case[1]) if case[0] == "linear_elasticity_fem" else 1
    G = amg.strength_graph(A.blocks[0]["oo"], bs)
    np.testing.assert_array_equal(amg.aggregate(G, epsilon), jax_amg.aggregate(G, epsilon))
    aggs, coarse = amg.aggregate_psparse(A, epsilon, bs)
    aggs_ref, coarse_ref = jax_amg.aggregate_psparse(build(*case)[1], epsilon, bs)
    np.testing.assert_array_equal(aggs[0], aggs_ref[0])
    assert coarse.n_global == coarse_ref.n_global


@pytest.mark.parametrize("with_nullspace", [False, True])
def test_prolongators_and_omega_match(with_nullspace):
    A, A_ref = build("linear_elasticity_fem", (5, 5, 4))
    ns = ns_ref = None
    if with_nullspace:
        coords, _ = gallery.node_coordinates_unit_cube((5, 5, 4), (1, 1, 1))
        ns = ns_ref = gallery.nullspace_linear_elasticity(coords)
    aggs, coarse = amg.aggregate_psparse(A, 0.0, 3)
    aggs_ref, coarse_ref = jax_amg.aggregate_psparse(A_ref, 0.0, 3)
    P0, cns, cdofs = amg.tentative_prolongator(A, aggs, coarse, ns)
    P0_ref, cns_ref, cdofs_ref = jax_amg.tentative_prolongator(A_ref, aggs_ref, coarse_ref, ns_ref)
    _same_csr(P0.blocks[0]["oo"], P0_ref.blocks[0]["oo"])
    assert cdofs.n_global == cdofs_ref.n_global
    if with_nullspace:
        for a, b in zip(cns[0], cns_ref[0]):
            np.testing.assert_array_equal(a, b)
    rho = amg.spectral_radius(A)
    assert rho == jax_amg.spectral_radius(A_ref)
    P, omega = amg.smoothed_prolongator(A, P0, return_omega=True)
    P_ref, omega_ref = jax_amg.smoothed_prolongator(A_ref, P0_ref, return_omega=True)
    assert abs(omega - omega_ref) <= 1e-12 * omega_ref
    _same_csr(P.blocks[0]["oo"], P_ref.blocks[0]["oo"])
    for a, b in zip(amg.default_nullspace(A)[0], jax_amg.default_nullspace(A_ref)[0]):
        np.testing.assert_array_equal(a, b)


def test_hierarchy_with_the_constant_nullspace_matches():
    A, A_ref = build("laplacian_fem", (20, 20))
    params = dict(coarse_size=20, max_levels=4)
    M = amg.AMGPreconditioner(A, amg.AMGParams(**params), nullspace=amg.default_nullspace(A))
    M_ref = jax_amg.AMGPreconditioner(A_ref, jax_amg.AMGParams(**params),
                                      nullspace=jax_amg.default_nullspace(A_ref))
    cases.check_hierarchy(M, M_ref)


def _cycle_pair(name, nodes, params, nullspace=True):
    A, A_ref = build(name, nodes)
    ns = None
    if nullspace:
        coords, _ = gallery.node_coordinates_unit_cube(nodes, (1,) * len(nodes))
        ns = gallery.nullspace_linear_elasticity(coords)
    M = amg.AMGPreconditioner(A, amg.AMGParams(**params), nullspace=ns)
    M_ref = jax_amg.AMGPreconditioner(A_ref, jax_amg.AMGParams(**params), nullspace=ns)
    own = [np.random.default_rng(9).standard_normal(A.shape[0])]
    z = M(pvector_from_own(own, A.row_prange, A.backend, device="cpu"))
    z_ref = M_ref(jax_pvector.pvector_from_own(own, A_ref.row_prange, A_ref.backend))
    return M, M_ref, cases.own(z, A.shape[0]), cases.own(z_ref, A.shape[0])


def test_w_cycle_matches_jax():
    M, M_ref, z, z_ref = _cycle_pair(
        "linear_elasticity_fem", (8, 7), dict(coarse_size=10, block_size=2, cycle="w"))
    assert len(M.levels) >= 3
    np.testing.assert_allclose(z, z_ref, rtol=0, atol=1e-10 * np.abs(z_ref).max())


def test_lu_coarse_solve_matches_jax():
    """One level: the whole 578-row operator is the coarsest, above the
    512-row limit of the explicit inverse, so both packages apply its LU
    factors (torch takes LAPACK's 1-based pivots, scipy gives 0-based)."""
    M, M_ref, z, z_ref = _cycle_pair("linear_elasticity_fem", (17, 17), dict(max_levels=1))
    assert M.coarse_kind == M_ref.coarse_kind == "lu"
    np.testing.assert_allclose(z, z_ref, rtol=0, atol=1e-10 * np.abs(z_ref).max())


def test_unported_branches_raise():
    A, A_ref = build("laplacian_fdm", (6, 6, 6))
    M_ref = jax_amg.AMGPreconditioner(A_ref, jax_amg.AMGParams(coarse_size=10))
    assert M_ref.levels[0].struct is not None, "the reference takes box aggregation here"
    M_box = amg.AMGPreconditioner(A, amg.AMGParams(coarse_size=10))
    assert [lev.struct is not None for lev in M_box.levels] == [lev.struct is not None
                                                                for lev in M_ref.levels]
    assert M_box.levels[0].struct.fine == (6, 6, 6) and M_box._flat_ok(0)
    # update is ported: it refills the hierarchy in place, never re-setting up
    galerkin = list(M_box._galerkin)
    assert M_box.update(A) is M_box and M_box._galerkin == galerkin
    # the Schwarz level smoother (dense tier on these small levels): no
    # struct, P applied as a matrix, the reference's levels and cycle
    params = dict(coarse_size=10, smoother="schwarz")
    S = amg.AMGPreconditioner(A, amg.AMGParams(**params))
    S_ref = jax_amg.AMGPreconditioner(A_ref, jax_amg.AMGParams(**params))
    assert S.statistics() == S_ref.statistics()
    assert all(lev.struct is None for lev in S.levels) and not S._flat_ok(0)
    assert ([getattr(lev.smoother, "mode", None) for lev in S.levels]
            == [getattr(lev.smoother, "mode", None) for lev in S_ref.levels][: len(S.levels)])
    own = [np.random.default_rng(9).standard_normal(A.shape[0])]
    z = cases.own(S(pvector_from_own(own, A.row_prange, A.backend, device="cpu")), A.shape[0])
    z_ref = cases.own(S_ref(jax_pvector.pvector_from_own(own, A_ref.row_prange, A_ref.backend)),
                      A.shape[0])
    np.testing.assert_allclose(z, z_ref, rtol=0, atol=1e-10 * np.abs(z_ref).max())
    M = amg.AMGPreconditioner(A, amg.AMGParams(coarse_size=10), nullspace=amg.default_nullspace(A))
    M._galerkin.pop()
    with pytest.raises(RuntimeError, match="no reuse plans"):
        M.update(A)
