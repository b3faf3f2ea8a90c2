"""SA-AMG of the PyTorch port across parts against the JAX reference,
float32 (cases in ``tests/torch_amg_parts_cases.py``; the reference with
JAX's x64 mode off, its TPU semantics).  The hierarchy of every case bit
for bit (the float64 host products of the elasticity levels, frozen in
float32), every level's operator carried across by ``convert`` and one
cycle from the fine level to 1e-5 of the largest entry, and the
PCG histories of the 2-D elasticity and the box Laplacian (V and W) to
rtol 1e-3 while the relres is above 1e-5 (float32 rounding, as
``tests/test_torch_amg_elasticity_f32.py``), with iteration counts within
one.  The 3-D cycle is held in float64 (``test_torch_amg_parts_f64.py``).
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import torch_amg_cases
import torch_amg_parts_cases as cases
from partitionedarrays_tpu import config as jax_config

torch.set_num_threads(1)

DTYPE = np.float32


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with threadpool_limits(limits=1), torch_amg_cases.reference_mode(DTYPE):
        yield
    jax_config.use_pallas = saved


@pytest.fixture(scope="module")
def built():
    return {}


def _get(built, name):
    if name not in built:
        built[name] = cases.build(name, DTYPE)
    return built[name]


@pytest.mark.parametrize("name", list(cases.CASES))
def test_hierarchy_matches_jax(built, name):
    port, ref = _get(built, name)
    cases.check_hierarchy(port[1], ref[1])
    M = port[1]
    assert all(lev.A.dtype == torch.float32 for lev in M.levels)
    if name != "box":  # the float64 nullspace: float64 host products below level 0
        assert M.levels[1].A.blocks[0]["oo"].dtype == np.float64


@pytest.mark.parametrize("name", ["2d", "box"])
def test_cycle_level_by_level_matches_jax(built, name):
    """Every level's operator through ``convert``; one cycle from the
    fine level (the float64 file holds a cycle from every level)."""
    port, ref = _get(built, name)
    cases.check_levels(port[1], ref[1], DTYPE, cycle_levels=(0,))


@pytest.mark.parametrize("name,cycle", [("2d", "v"), ("box", "v"), ("box", "w")])
def test_cg_history_matches_jax(built, name, cycle):
    port, ref = _get(built, name)
    (x, h), (x_ref, h_ref) = cases.histories(port, ref, cycle)
    assert abs(len(h) - len(h_ref)) <= 1 and h[-1] <= cases.RTOL_CG * h[0]
    rtol, floor = cases.F32_HISTORY
    n = min(len(h), len(h_ref))
    keep = h_ref[:n] / h_ref[0] > floor
    np.testing.assert_allclose(h[:n][keep], h_ref[:n][keep], rtol=rtol)
    assert cases.true_relres(port[0], x, port[2]) <= 1e-5
