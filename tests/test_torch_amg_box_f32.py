"""Box-stencil SA-AMG of the PyTorch port against the JAX reference, float32
(cases in ``tests/torch_amg_box_cases.py``).  The reference runs with JAX's
x64 mode off, as on its TPU.

- The hierarchy of the ragged (10, 11, 12) box bit for bit, every level
  frozen in float32 (D^-1 of the transfers too); the same for the AMG of
  the float32 copy (``astype``) of a float64 operator.
- The structured and flat transfers against the reference's and against
  the materialized P, one V-cycle, one W-cycle and the structured branch
  that is not flat, to 1e-5 of the largest entry (float32 sums in another
  order).
- The PCG residual histories with the same iteration count, to rtol 1e-3
  while the relative residual is above 1e-5 (the rule of the float32 HPCG
  and elasticity histories, ROADMAP Queue 3).
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import torch_amg_box_cases as cases
import torch_amg_cases
from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.solvers import amg as jax_amg

from partitionedarrays_tpu_torch.solvers import amg, krylov

torch.set_num_threads(1)

DTYPE = np.float32


# numpy's BLAS on one thread in this module: its idle threads spin, and
# beside the suite's other workers its small dense factorizations then run
# up to ~30x slower
@pytest.fixture(scope="module", autouse=True)
def reference_mode():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with torch_amg_cases.reference_mode(DTYPE), threadpool_limits(limits=1):
        yield
    jax_config.use_pallas = saved


@pytest.fixture(scope="module")
def built():
    return cases.build(DTYPE)


def test_hierarchy_matches_jax(built):
    (A, M, b), (A_ref, M_ref, b_ref) = built
    cases.check_hierarchy(M, M_ref)
    assert torch_amg_cases.tiers(M) == ["colored", "colored", None]
    assert [lev.A.dtype for lev in M.levels] == [torch.float32] * 3
    assert [lev.struct.dinv.dtype for lev in M.levels[:-1]] == [torch.float32] * 2
    assert [lev.smoother.colored.vals_d.dtype for lev in M.levels[:-1]] == [torch.float32] * 2


def test_hierarchy_of_a_float32_copy_matches_jax():
    """``astype(np.float32)`` of a float64 operator: a float32 device copy,
    whose AMG freezes every level in float32 and equals the reference's
    AMG of its own copy."""
    A, A_ref = cases.operators(cases.RAGGED, np.float64)
    A32 = A.astype(np.float32)
    assert A32.dtype == torch.float32 and A32.blocks[0]["oo"].dtype == np.float32
    M = amg.AMGPreconditioner(A32, amg.AMGParams(**cases.PARAMS))
    M_ref = jax_amg.AMGPreconditioner(A_ref.astype(np.float32), jax_amg.AMGParams(**cases.PARAMS))
    cases.check_hierarchy(M, M_ref)
    assert [lev.A.dtype for lev in M.levels] == [torch.float32] * 3
    assert all(lev.A.blocks[0]["oo"].dtype == np.float32 for lev in M.levels)


def test_transfers_match_jax_and_P(built):
    cases.check_transfers(*built, DTYPE)


def test_vcycle_matches_jax(built):
    (A, M, b), (A_ref, M_ref, b_ref) = built
    n = A.shape[0]
    z, z_ref = M(b), M_ref(b_ref)
    assert z.own.dtype == torch.float32 and np.asarray(z_ref.own).dtype == np.float32
    cases.close(cases.own(z, n), cases.own(z_ref, n), cases.CYCLE_ATOL[DTYPE])


def test_wcycle_matches_jax(built):
    (A, M, b), (A_ref, M_ref, b_ref) = built
    n = A.shape[0]
    z, z_ref = M._cycle(0, b, True), M_ref._cycle(0, b_ref, True)
    cases.close(cases.own(z, n), cases.own(z_ref, n), cases.CYCLE_ATOL[DTYPE])


def test_cg_history_matches_jax(built):
    port, ref = built
    (x, h), (x_ref, h_ref) = torch_amg_cases.histories(port, ref)
    assert len(h) == len(h_ref) and 5 <= len(h) - 1 <= 15
    above = h_ref / h_ref[0] > 1e-5
    np.testing.assert_allclose(h[above], h_ref[above], rtol=1e-3)
    A, M, b = port
    _, info = krylov.cg(A, b, M=M, rtol=torch_amg_cases.RTOL_CG, maxiter=torch_amg_cases.MAXITER)
    assert abs(info.iterations - (len(h_ref) - 1)) <= 1


def test_structured_branch_that_is_not_flat_matches_jax():
    port, ref = cases.build(DTYPE, coarse_size=100, max_levels=2)
    (A, M, b), (A_ref, M_ref, b_ref) = port, ref
    cases.force_tile_tier(M, M_ref, 0)
    n = A.shape[0]
    cases.close(cases.own(M(b), n), cases.own(M_ref(b_ref), n), cases.CYCLE_ATOL[DTYPE])
