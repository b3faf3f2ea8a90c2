"""Additive Schwarz of the PyTorch port against the JAX reference's, float32
(cases in ``tests/torch_schwarz_cases.py``; the reference with JAX's x64
mode off, as on its TPU).  The float32 device values of the ILU(0)
factors come from the same float64 host factorization in both packages.

- The level schedules, W and B of the ILU(0) factors equal the
  reference's, the one-direction packs bit for bit; the triangular
  solves (plain K6, one direction each) match the reference's twin to
  1e-5 of the largest entry.
- ``AdditiveSchwarz`` in each mode, ``apply`` with ``iterations=2`` and
  ``refresh_values``: against the reference to 1e-5 of the largest entry,
  the refreshed operands against a fresh build bit for bit.
- CG with each tier and AMG with Schwarz level smoothers: the iteration
  counts within one of the reference's, the residual histories to rtol
  1e-3 while the relative residual is above 1e-5 (ROADMAP Queue 3, the
  float32 rule), a V-cycle to 1e-4 of its largest entry (float32 sums in
  another order through the levels), and after ``update`` with 3 V the
  V-cycle against the reference's update and a fresh setup (1e-4).
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import torch_schwarz_cases as cases
from partitionedarrays_tpu import config as jax_config

from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
from partitionedarrays_tpu_torch.solvers.smoothers import AdditiveSchwarz

torch.set_num_threads(1)

DTYPE = np.float32
RTOL = cases.RTOL[DTYPE]
RTOL_CYCLE = 1e-4
RTOL_HISTORY = 1e-3
LIVE_RELRES = 1e-5


# numpy's BLAS on one thread in this module: its idle threads spin, and
# beside the suite's other workers its small dense factorizations (tile
# inverses, LU) then run up to ~30x slower
@pytest.fixture(scope="module", autouse=True)
def reference_mode():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with cases.reference_mode(DTYPE), threadpool_limits(limits=1):
        yield
    jax_config.use_pallas = saved


def _histories_agree(h, h_ref):
    live = h_ref > LIVE_RELRES * h_ref[0]
    n = min(int(live.sum()), len(h))
    np.testing.assert_allclose(h[:n], h_ref[:n], rtol=RTOL_HISTORY, atol=0)


@pytest.mark.parametrize("case", [cases.FEM_TRI, ("laplacian_fdm", (16, 16, 16), (2, 2, 1))])
def test_triangular_solves_match_jax(case):
    A, A_ref = cases.pair(case, DTYPE)
    S, S_ref = cases.schwarz_pair(A, A_ref, mode="ilu0")
    for tg, tg_ref in ((S.sgsL, S_ref.sgsL), (S.sgsU, S_ref.sgsU)):
        assert tg.schedules == tg_ref.schedules and (tg.W, tg.B) == (tg_ref.W, tg_ref.B)
        assert tg.pack.dtype == torch.float32
        dpack = np.asarray(tg_ref.arrs[6])
        for k, waves in enumerate(tg.schedules):
            for w, wave in enumerate(waves):
                for j, t in enumerate(wave):
                    np.testing.assert_array_equal(tg.pack[k, 0, t].numpy(),
                                                  dpack[k, w, j * 128:(j + 1) * 128])
    r, r_ref = cases.vectors(A, A_ref, DTYPE, 31)
    cases.assert_close(cases.own(S(r), A), cases.own(S_ref(r_ref), A), RTOL)


@pytest.mark.parametrize("mode", ["dense", "ilu0", "auto", "custom"])
def test_schwarz_modes_match_jax(mode):
    A, A_ref = cases.pair(cases.FEM_TRI, DTYPE)
    kw = dict(iterations=2)
    if mode == "custom":
        from partitionedarrays_tpu.solvers.smoothers import AdditiveSchwarz as JaxSchwarz
        from partitionedarrays_tpu.solvers.smoothers import JacobiCorrection as JaxJacobi

        from partitionedarrays_tpu_torch.solvers.smoothers import JacobiCorrection

        S = AdditiveSchwarz(A, local_solver=JacobiCorrection(A), **kw)
        S_ref = JaxSchwarz(A_ref, local_solver=JaxJacobi(A_ref), **kw)
    else:
        S, S_ref = cases.schwarz_pair(A, A_ref, mode=mode, **kw)
    assert S.mode == S_ref.mode == {"auto": "dense"}.get(mode, mode)
    r, r_ref = cases.vectors(A, A_ref, DTYPE, 11)
    x, x_ref = cases.vectors(A, A_ref, DTYPE, 12)
    cases.assert_close(cases.own(S(r), A), cases.own(S_ref(r_ref), A), RTOL)
    cases.assert_close(cases.own(S.apply(x, r), A), cases.own(S_ref.apply(x_ref, r_ref), A),
                       RTOL)
    if mode == "custom":
        return
    A3, A3_ref = cases.scaled(cases.FEM_TRI, DTYPE, 3.0)
    S.refresh_values(A3)
    S_ref.refresh_values(A3_ref)
    cases.assert_close(cases.own(S.apply(x, r), A), cases.own(S_ref.apply(x_ref, r_ref), A),
                       RTOL)
    fresh = AdditiveSchwarz(A3, mode=mode, iterations=2)
    for got, want in zip(cases.smoother_operands(S), cases.smoother_operands(fresh)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["dense", "ilu0"])
def test_cg_with_schwarz_matches_jax_iterations(mode):
    A, A_ref = cases.pair(cases.FDM_CG, DTYPE, assembled=True)
    b, b_ref = cases.rhs(A, A_ref, DTYPE)
    S, S_ref = cases.schwarz_pair(A, A_ref, mode=mode)
    (its, h), (its_ref, h_ref) = cases.pcg_iterations(A, A_ref, S, S_ref, b, b_ref, 1e-6)
    assert abs(its - its_ref) <= 1 and its > 0
    _histories_agree(h, h_ref)


@pytest.mark.parametrize("name", list(cases.AMG_CASES))
def test_amg_schwarz_matches_jax(name):
    A, A_ref, M, M_ref = cases.amg_pair(name, DTYPE)
    cases.check_hierarchy(M, M_ref)
    assert [lev.A.dtype for lev in M.levels] == [torch.float32] * len(M.levels)
    r, r_ref = cases.vectors(A, A_ref, DTYPE, 21)
    cases.assert_close(cases.own(M(r), A), cases.own(M_ref(r_ref), A), RTOL_CYCLE)
    b, b_ref = cases.rhs(A, A_ref, DTYPE)
    (its, h), (its_ref, h_ref) = cases.pcg_iterations(A, A_ref, M, M_ref, b, b_ref, 1e-6)
    assert abs(its - its_ref) <= 1 and its > 0
    _histories_agree(h, h_ref)
    A3, A3_ref = cases.scaled(cases.AMG_CASES[name][0], DTYPE, 3.0)
    M.update(A3)
    M_ref.update(A3_ref)
    got = cases.own(M(r), A)
    cases.assert_close(got, cases.own(M_ref(r_ref), A), RTOL_CYCLE)
    fresh = AMGPreconditioner(A3, AMGParams(smoother="schwarz", **cases.AMG_CASES[name][1]))
    cases.assert_close(got, cases.own(fresh(r), A), RTOL_CYCLE)
