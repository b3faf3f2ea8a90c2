"""Shared cases of the box-stencil SA-AMG parity tests
(``test_torch_amg_box_{f64,f32}.py``): the 7-point ``laplacian_fdm`` on one
part, built by both packages from their (bit-equal) galleries, the port on
the CPU (plain kernel versions) and the JAX reference on the CPU with Pallas
off, both with the default ``AMGParams`` but for ``coarse_size``.

The case is a ragged box, (10, 11, 12) = 1,320 rows: no axis but the last
is a multiple of 3, so the last 3x3x3 aggregate of the first two axes is
short.  Its hierarchy: 1,320 rows (7 offsets, m = 5) -> 64 rows, a 4^3 box
(27 offsets, m = 9) -> 8 rows, the coarse inverse; both smoothed levels
take the flat cycle.

The host setup (box aggregation, omega, the Galerkin products) is the same
numpy/scipy work in both packages, so the hierarchy is held equal bit for
bit (omega to 1e-12); the transfers, cycles and CG are device work, held to
the dtype's tolerance.  The reference's float32 AMG runs with JAX's x64
mode off (``torch_amg_cases.reference_mode``).
"""
import importlib

import numpy as np

from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.solvers import amg as jax_amg

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.psparse import psparse
from partitionedarrays_tpu_torch.pvector import pvector_from_own
from partitionedarrays_tpu_torch.solvers import amg

import torch_amg_cases

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

RAGGED = (10, 11, 12)
EXACT = (9, 9, 9)
PARAMS = dict(coarse_size=10)
# agreement relative to the largest entry: the transfers (against the
# reference's and against P), and the cycles
ATOL = {np.float64: 1e-12, np.float32: 1e-5}
CYCLE_ATOL = {np.float64: 1e-10, np.float32: 1e-5}


def operators(nodes, dtype):
    """The port's and the reference's ``laplacian_fdm`` on one part."""
    I, J, V, rows, cols = gallery.laplacian_fdm(nodes, (1, 1, 1), dtype=dtype)
    A = psparse(I, J, V, rows, cols, SerialBackend(1), device="cpu")
    I, J, V, rows, cols = jax_gallery.laplacian_fdm(nodes, (1, 1, 1), dtype=dtype)
    A_ref = jax_psparse.psparse(I, J, V, JaxPRange(rows), JaxPRange(cols), JaxSerialBackend(1),
                                assembled=True)
    return A, A_ref


def vectors(A, A_ref, own):
    return (pvector_from_own(own, A.row_prange, A.backend, device="cpu"),
            jax_pvector.pvector_from_own(own, A_ref.row_prange, A_ref.backend))


def build(dtype, nodes=RAGGED, seed=3, **params):
    """((A, M, b), (A_ref, M_ref, b_ref)) with a rhs made with numpy."""
    A, A_ref = operators(nodes, dtype)
    params = {**PARAMS, **params}
    M = amg.AMGPreconditioner(A, amg.AMGParams(**params))
    M_ref = jax_amg.AMGPreconditioner(A_ref, jax_amg.AMGParams(**params))
    own = [np.random.default_rng(seed).standard_normal(A.shape[0]).astype(dtype)]
    b, b_ref = vectors(A, A_ref, own)
    return (A, M, b), (A_ref, M_ref, b_ref)


def same_csr(a, b):
    torch_amg_cases._same_csr(a, b)


def check_hierarchy(M, M_ref):
    """Every level equal to the reference's: rows, the operator bit for bit
    with the same frozen DIA offsets, omega, the box shapes, aggregates and
    D^-1 of the transfers, P, the smoother tier and its colors, and the
    coarse solve's kind."""
    assert M.statistics() == M_ref.statistics()
    assert len(M.levels) == len(M_ref.levels)
    for l, (lev, lev_ref) in enumerate(zip(M.levels, M_ref.levels)):
        same_csr(lev.A.blocks[0]["oo"], lev_ref.A.blocks[0]["oo"])
        oo, oo_ref = lev.A.device().oo, lev_ref.A.device().oo
        assert oo.kind == oo_ref.kind
        if oo.kind == "dia":
            assert tuple(oo.offsets) == tuple(int(o) for o in oo_ref.offsets)
        if lev.P is None:
            assert lev_ref.P is None
            continue
        assert lev.struct is not None and lev_ref.struct is not None
        assert (lev.struct.fine, lev.struct.coarse) == tuple(lev_ref.struct[:2])
        aggs, coarse = M.aggregates[l]
        aggs_ref, coarse_ref, shapes_ref = M_ref._aggs[l]
        assert shapes_ref == tuple(lev_ref.struct[:2])
        np.testing.assert_array_equal(aggs[0], aggs_ref[0])
        assert coarse.n_global == coarse_ref.n_global
        omega_ref = M_ref._galerkin[l].omega
        assert lev.struct.omega == M.omegas[l]
        assert abs(M.omegas[l] - omega_ref) <= 1e-12 * abs(omega_ref)
        np.testing.assert_array_equal(lev.struct.dinv.numpy(), np.asarray(lev_ref.struct[3]))
        same_csr(lev.P.blocks[0]["oo"], lev_ref.P.blocks[0]["oo"])
        gs, gs_ref = lev.smoother, lev_ref.smoother
        assert (gs.colored is None) == (gs_ref.colored is None)
        assert (gs.tile_gs is None) == (gs_ref.slot_gs is None)
        assert gs.n_colors == gs_ref.n_colors
        assert M._flat_ok(l) == M_ref._flat_ok(l)
    assert M.coarse_kind == M_ref.coarse_kind


def own(v, n):
    return torch_amg_cases.own(v, n)


def close(got, want, atol_rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_rel * np.abs(want).max())


def check_transfers(port, ref, dtype, seed=4):
    """On every box level: ``_restrict_struct`` and ``_restrict_flat``
    against the reference's and against P^T r by the materialized P,
    ``_prolong_struct`` and ``_prolong_flat`` against the reference's and
    against P e."""
    (A, M, _), (A_ref, M_ref, _) = port, ref
    rng = np.random.default_rng(seed)
    for l, (lev, lev_ref) in enumerate(zip(M.levels[:-1], M_ref.levels[:-1])):
        n, nc = lev.A.shape[0], M.levels[l + 1].A.shape[0]
        P64 = lev.P.blocks[0]["oo"].astype(np.float64)
        r_own = [rng.standard_normal(n).astype(dtype)]
        e_own = [rng.standard_normal(nc).astype(dtype)]
        r, r_ref = vectors(lev.A, lev_ref.A, r_own)
        e, e_ref = vectors(M.levels[l + 1].A, M_ref.levels[l + 1].A, e_own)
        cl, cl_ref = M.levels[l + 1].A.row_layout(), M_ref.levels[l + 1].A.row_layout()
        via_P = P64.T @ r_own[0].astype(np.float64)
        up_P = P64 @ e_own[0].astype(np.float64)
        rc = own(M._restrict_struct(lev, r, cl), nc)
        rc_ref = own(M_ref._restrict_struct(lev_ref, r_ref, cl_ref), nc)
        gs, gs_ref = lev.smoother, lev_ref.smoother
        rcf = own(M._restrict_flat(lev, gs.flat_deinterleave(r.own), cl), nc)
        rcf_ref = own(M_ref._restrict_flat(lev_ref, gs_ref.flat_deinterleave(r_ref.own), cl_ref), nc)
        ep = M._prolong_struct(lev, e)[0, :n].numpy()
        ep_ref = np.asarray(M_ref._prolong_struct(lev_ref, e_ref))[0, :n]
        epf = gs.flat_interleave(M._prolong_flat(lev, e))[0, :n].numpy()
        epf_ref = np.asarray(gs_ref.flat_interleave(M_ref._prolong_flat(lev_ref, e_ref)))[0, :n]
        for got in (rc, rc_ref, rcf, rcf_ref):
            close(got, via_P, ATOL[dtype])
        for got in (ep, ep_ref, epf, epf_ref):
            close(got, up_P, ATOL[dtype])
        close(rc, rc_ref, ATOL[dtype])
        close(rcf, rcf_ref, ATOL[dtype])
        close(ep, ep_ref, ATOL[dtype])
        close(epf, epf_ref, ATOL[dtype])


def force_tile_tier(M, M_ref, l):
    """Level ``l`` of both hierarchies smoothed by the tile tier instead of
    its colored sweep: the cycle then takes the structured branch that is
    not flat (standard-order transfers by K1 around the level's
    smoother)."""
    from partitionedarrays_tpu.solvers.gs_slot import NaturalTileGS as JaxNaturalTileGS

    from partitionedarrays_tpu_torch.solvers.gs_slot import NaturalTileGS

    gs, gs_ref = M.levels[l].smoother, M_ref.levels[l].smoother
    gs.colored, gs.tile_gs, gs.n_colors = None, NaturalTileGS.build(gs.A), 1
    gs_ref.colored, gs_ref.slot_gs, gs_ref.n_colors = None, JaxNaturalTileGS.build(gs_ref.A), 1
    assert not M._flat_ok(l) and not M_ref._flat_ok_ghosted(l)
