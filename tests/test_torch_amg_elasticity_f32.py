"""Elasticity SA-AMG of the PyTorch port against the JAX reference, float32
(cases in ``tests/torch_amg_cases.py``).  The reference runs with JAX's x64
mode off, as on its TPU: its float64 host prolongators and coarse operators
become float32 device arrays, as the port's do.

- 3-D Q1 elasticity at 7^3 nodes: the hierarchy equals the reference's bit
  for bit (omega to 1e-12) with the same smoother tiers (colored, tile)
  and float32 device levels.  Its cycle is held in float64
  (``test_torch_amg_elasticity_f64.py``) and on the card (``chip_smoke.py``);
  the reference's float32 V-cycle here would compile its 27-color XLA
  sweep again.
- 2-D elasticity at 12 x 12 nodes (288 -> 48 -> 9 rows): one V-cycle
  agrees to 1e-4 of its largest entry (float32 sums in another order,
  through three levels); the CG residual histories agree to rtol 1e-3
  while the relative residual is above 1e-5 (as the float32 HPCG
  histories, ROADMAP Queue 3), the iteration counts within one.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import torch_amg_cases as cases
from partitionedarrays_tpu import config as jax_config

from partitionedarrays_tpu_torch.solvers.krylov import cg

torch.set_num_threads(1)

DTYPE = np.float32


# numpy's BLAS on one thread in this module: its idle threads spin, and
# beside the suite's other workers its small dense factorizations (tile
# inverses, QR, LU) then run up to ~30x slower
@pytest.fixture(scope="module", autouse=True)
def reference_mode():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with cases.reference_mode(DTYPE), threadpool_limits(limits=1):
        yield
    jax_config.use_pallas = saved


def test_hierarchy_matches_jax():
    (A, M, b), (A_ref, M_ref, b_ref) = cases.build(cases.CASE_3D, DTYPE)
    cases.check_hierarchy(M, M_ref)
    assert cases.tiers(M) == ["colored", "tile", None]
    # the float64 host products run in float32 on the device
    assert [lev.A.dtype for lev in M.levels] == [torch.float32] * 3
    assert M.levels[1].A.blocks[0]["oo"].dtype == np.float64


@pytest.fixture(scope="module")
def built_2d():
    return cases.build(cases.CASE_2D, DTYPE)


def test_vcycle_matches_jax(built_2d):
    (A, M, b), (A_ref, M_ref, b_ref) = built_2d
    n = A.shape[0]
    z, z_ref = M(b), M_ref(b_ref)
    assert z.own.dtype == torch.float32 and np.asarray(z_ref.own).dtype == np.float32
    want = cases.own(z_ref, n)
    np.testing.assert_allclose(cases.own(z, n), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_cg_history_matches_jax(built_2d):
    (x, h), (x_ref, h_ref) = cases.histories(*built_2d)
    assert abs(len(h) - len(h_ref)) <= 1 and 5 <= len(h_ref) - 1 <= 12
    k = min(len(h), len(h_ref))
    above = h_ref[:k] / h_ref[0] > 1e-5
    np.testing.assert_allclose(h[:k][above], h_ref[:k][above], rtol=1e-3)
    A, M, b = built_2d[0]
    _, info = cg(A, b, M=M, rtol=cases.RTOL_CG, maxiter=cases.MAXITER)
    assert abs(info.iterations - (len(h_ref) - 1)) <= 1
    assert float(info.residual) <= cases.RTOL_CG * h[0]
