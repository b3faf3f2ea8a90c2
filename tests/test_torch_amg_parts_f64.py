"""SA-AMG of the PyTorch port across parts against the JAX reference,
float64 (cases in ``tests/torch_amg_parts_cases.py``): 2-D elasticity on
(2,2) parts and 3-D elasticity on (2,2,2) parts of unequal size (the
generic cycle; the 3-D fine level on the tile tier with P = 8), and the
box Laplacian on (2,2,2) parts (the ghosted flat cycle, V and W).

- The hierarchy: rows and nnz per level, every part's blocks, ghosts and
  aggregates bit for bit, omega to 1e-12, the smoother tiers.
- One cycle level by level, every level's operator carried across from the
  reference by ``convert.psparse_from_host_blocks``: to 1e-10 of the
  largest reference entry.
- The PCG residual histories to rtol 1e-8 with the same iteration count,
  and the true residual of the solution.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import torch_amg_parts_cases as cases
from partitionedarrays_tpu import config as jax_config

torch.set_num_threads(1)

DTYPE = np.float64


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with threadpool_limits(limits=1):
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
    if name == "3d":
        M = port[1]
        assert cases.tiers(M) == ["tile", None]
        assert M.levels[0].smoother.tile_gs.wave_tiles.shape[0] == 8
        assert len({li.n_own for li in M.levels[0].A.row_prange.parts}) > 1
        assert len({li.n_own for li in M.levels[1].A.row_prange.parts}) > 1
    if name == "box":
        assert [lev.struct is not None for lev in port[1].levels[:-1]] == [True, True]
        # ghosted: the flat cycle couples in the core, with the structured transfers
        assert not any(port[1]._flat_ok(l) for l in range(2))


@pytest.mark.parametrize("name", list(cases.CASES))
def test_cycle_level_by_level_matches_jax(built, name):
    port, ref = _get(built, name)
    cases.check_levels(port[1], ref[1], DTYPE)
    if name == "box":
        cases.check_levels(port[1], ref[1], DTYPE, w=True)


@pytest.mark.parametrize("name,cycle", [("2d", "v"), ("3d", "v"), ("box", "v"), ("box", "w")])
def test_cg_history_matches_jax(built, name, cycle):
    port, ref = _get(built, name)
    (x, h), (x_ref, h_ref) = cases.histories(port, ref, cycle)
    assert len(h) == len(h_ref) and h[-1] <= cases.RTOL_CG * h[0]
    np.testing.assert_allclose(h, h_ref, rtol=1e-8)
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-8 * np.abs(x_ref).max())
    assert cases.true_relres(port[0], x, port[2]) <= 2e-8
