"""Elasticity SA-AMG of the PyTorch port against the JAX reference, float64:
3-D Q1 elasticity at 7^3 nodes (cases in ``tests/torch_amg_cases.py``).

The hierarchy equals the reference's bit for bit (aggregates, P, the coarse
operators; omega to 1e-12) with the same smoother tiers (colored on the
99-diagonal fine level, the tile tier on level 1); one V-cycle agrees to
1e-10 and the CG residual histories to rtol 1e-10 with the same iteration
count (only the summation order of the device sums differs); the port's
``cg`` takes that count and reaches the same solution.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import torch_amg_cases as cases
from partitionedarrays_tpu import config as jax_config

from partitionedarrays_tpu_torch.solvers.krylov import cg

torch.set_num_threads(1)

DTYPE = np.float64


# numpy's BLAS on one thread in this module: its idle threads spin, and
# beside the suite's other workers its small dense factorizations (tile
# inverses, QR, LU) then run up to ~30x slower
@pytest.fixture(scope="module")
def built():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with cases.reference_mode(DTYPE), threadpool_limits(limits=1):
        yield cases.build(cases.CASE_3D, DTYPE)
    jax_config.use_pallas = saved


def test_hierarchy_matches_jax(built):
    (A, M, b), (A_ref, M_ref, b_ref) = built
    cases.check_hierarchy(M, M_ref)
    assert cases.tiers(M) == ["colored", "tile", None]
    assert M.levels[0].smoother.n_colors == 27
    assert M.levels[0].A.device().oo.kind == "dia" and len(M.levels[0].A.device().oo.offsets) == 99


def test_vcycle_matches_jax(built):
    (A, M, b), (A_ref, M_ref, b_ref) = built
    n = A.shape[0]
    want = cases.own(M_ref(b_ref), n)
    np.testing.assert_allclose(cases.own(M(b), n), want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_cg_history_matches_jax(built):
    port, ref = built
    (x, h), (x_ref, h_ref) = cases.histories(port, ref)
    assert len(h) == len(h_ref) and 5 <= len(h) - 1 <= 12
    np.testing.assert_allclose(h, h_ref, rtol=1e-10)
    A, M, b = port
    n = A.shape[0]
    x_cg, info = cg(A, b, M=M, rtol=cases.RTOL_CG, maxiter=cases.MAXITER)
    assert info.iterations == len(h_ref) - 1
    want = cases.own(x_ref, n)
    scale = np.abs(want).max()
    np.testing.assert_allclose(cases.own(x_cg, n), want, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(cases.own(x, n), want, rtol=0, atol=1e-9 * scale)
