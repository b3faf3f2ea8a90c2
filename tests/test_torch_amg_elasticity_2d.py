"""Elasticity SA-AMG of the PyTorch port against the JAX reference in 2-D,
float64: 12 x 12 nodes, block size 2, three rigid-body modes (cases in
``tests/torch_amg_cases.py``; the float32 case is in
``test_torch_amg_elasticity_f32.py``).

The hierarchy equals the reference's bit for bit; one V-cycle agrees to
1e-10 and the CG residual histories to rtol 1e-10 with the same iteration
count; the port's ``cg`` takes that count and reaches the same solution to
1e-9 of its largest entry.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import torch_amg_cases as cases
from partitionedarrays_tpu import config as jax_config

from partitionedarrays_tpu_torch.solvers.krylov import cg

torch.set_num_threads(1)


# numpy's BLAS on one thread in this module: its idle threads spin, and
# beside the suite's other workers its small dense factorizations (tile
# inverses, QR, LU) then run up to ~30x slower
@pytest.fixture(scope="module")
def built():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with threadpool_limits(limits=1):
        yield cases.build(cases.CASE_2D, np.float64)
    jax_config.use_pallas = saved


def test_hierarchy_matches_jax(built):
    (A, M, b), (A_ref, M_ref, b_ref) = built
    cases.check_hierarchy(M, M_ref)
    assert M.statistics()["rows_per_level"] == [288, 48, 9]
    assert cases.tiers(M)[-1] is None


def test_vcycle_matches_jax(built):
    (A, M, b), (A_ref, M_ref, b_ref) = built
    n = A.shape[0]
    want = cases.own(M_ref(b_ref), n)
    np.testing.assert_allclose(cases.own(M(b), n), want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_cg_matches_jax(built):
    (x, h), (x_ref, h_ref) = cases.histories(*built)
    assert len(h) == len(h_ref) and len(h) - 1 > 3
    np.testing.assert_allclose(h, h_ref, rtol=1e-10)
    A, M, b = built[0]
    x_cg, info = cg(A, b, M=M, rtol=cases.RTOL_CG, maxiter=cases.MAXITER)
    assert info.iterations == len(h_ref) - 1
    n = A.shape[0]
    want = cases.own(x_ref, n)
    np.testing.assert_allclose(cases.own(x_cg, n), want, rtol=0, atol=1e-9 * np.abs(want).max())
