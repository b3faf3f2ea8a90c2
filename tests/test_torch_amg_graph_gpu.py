"""The AMG cycle replayed from its CUDA graph (``AMGPreconditioner.__call__``)
against the eager cycle (``M._cycle(0, r, w)`` called directly), on the card:

- 3-D elasticity at 16^3 nodes with the rigid-body modes (K3 on the banded
  fine level, K6 on the tile level, K5 in the transfers, the dense coarse
  inverse), a V- and a W-cycle;
- the same with additive Schwarz ILU(0) level smoothers (K6's one-direction
  triangular solves);
- the box Laplacian at 24^3 on one part (the flat cycle: K3, K4, K1);
- the box Laplacian at 18^3 on (2,2,2) parts of the serial backend (the
  ghosted flat cycle, its exchanges);
- the 16^3 elasticity hierarchy after ``update`` with scaled values, and
  after its tile-tier smoothers are swapped for the sorted tier (each a
  new capture).

Each key's first call captures (and returns its warm-up cycle), the later
ones replay; every output is held to the eager cycle (float64 1e-14 and
float32 1e-6 of the largest entry) and owns its storage.  Every call, the
capturing one too, counts exactly the eager cycle's launches
(``launches.<entry>``) and exchanges.  The level-0 spans of a profiled run
read "capture", then "replay".  On the 40^3 elasticity hierarchy of the
benchmark no capture fails (K3's cooperative and K6's cluster launches are
captured) and the calls replay.  An AMG-CG through ``__call__`` takes the
iterations and the final residual of one whose preconditioner calls
``_cycle`` directly, and so does ``cg_df64`` on the 24^3 Laplacian with the
AMG of its float32 copy.

Every test is marked ``gpu`` and skips without a CUDA card (decided in the
fixture).  This module imports torch and the port only (no JAX):

    python -m pytest --noconftest -p no:randomly tests/test_torch_amg_graph_gpu.py -q
"""
import warnings

import numpy as np
import pytest
import torch

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.gallery import (
    laplacian_fdm, linear_elasticity_fem, node_coordinates_unit_cube,
    nullspace_linear_elasticity)
from partitionedarrays_tpu_torch.psparse import psparse, psparse_refill, spmv, to_global_scipy
from partitionedarrays_tpu_torch.pvector import pones, prandn, pvector_df64
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner, _CycleGraph
from partitionedarrays_tpu_torch.solvers.krylov import cg, cg_df64
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel
from partitionedarrays_tpu_torch.utils import profiling
from torch.profiler import ProfilerActivity, profile

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.float64]
RTOL = {torch.float32: 1e-6, torch.float64: 1e-14}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph captures the kernels of the card")
    return torch.device("cuda")


def _np(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _elasticity(nodes, dtype, device, cycle="v", reuse=False, coarse_size=400, smoother="gs"):
    I, J, V, rows, cols = linear_elasticity_fem(nodes, (1, 1, 1), dtype=_np(dtype))
    out = psparse(I, J, V, rows, cols, SerialBackend(1), reuse=reuse, device=device)
    A, cache = out if reuse else (out, None)
    coords, _ = node_coordinates_unit_cube(nodes, (1, 1, 1))
    M = AMGPreconditioner(A, AMGParams(coarse_size=coarse_size, block_size=3, max_levels=4,
                                       cycle=cycle, smoother=smoother),
                          nullspace=nullspace_linear_elasticity(coords, A.row_prange))
    return A, M, (V, cache)


def _box(nodes, parts, dtype, device):
    I, J, V, rows, cols = laplacian_fdm(nodes, parts, dtype=_np(dtype))
    A = psparse(I, J, V, rows, cols, SerialBackend(int(np.prod(parts))), assembled=True,
                device=device)
    return A, AMGPreconditioner(A, AMGParams(coarse_size=20))


def _rhs(A, dtype, device, seed=3):
    return prandn(torch.Generator().manual_seed(seed), A.row_prange, A.backend, dtype, device)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= RTOL[dtype] * want.abs().max().item(), err


def _counts(prefixes=("launches", "exchange")):
    return {k: n for k, n in profiling.COUNTS.items() if k.startswith(prefixes)}


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(before) | set(after)
            if after.get(k, 0) != before.get(k, 0)}


def _hold(M, r, dtype, w=False, calls=4):
    """M(r) ``calls`` times against the eager cycle; returns the outputs and
    the counters' change of each call.  Every key of ``M`` captured."""
    want = M._cycle(0, r, w)
    outs, deltas = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a refused capture warns
        for _ in range(calls):
            before = _counts()
            outs.append(M(r))
            deltas.append(_delta(before, _counts()))
    for z in outs:
        _close(z.own, want.own, dtype)
    assert M._graphs and all(isinstance(g, _CycleGraph) for g in M._graphs.values())
    return outs, deltas


def _eager_counts(M, r, w=False):
    before = _counts()
    M._cycle(0, r, w)
    return _delta(before, _counts())


def _assert_fresh(outs):
    ptrs = [z.own.untyped_storage().data_ptr() for z in outs]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cycle", ["v", "w"])
def test_elasticity_replay_matches_the_eager_cycle(cuda, dtype, cycle):
    A, M, _ = _elasticity((16, 16, 16), dtype, cuda, cycle)
    r = _rhs(A, dtype, cuda)
    w = cycle == "w"
    outs, deltas = _hold(M, r, dtype, w)
    _assert_fresh(outs)
    eager = _eager_counts(M, r, w)
    assert eager["launches.gs_sweeps"] > 0 and eager["launches.tile_gs_sweeps"] > 0
    assert deltas == [eager] * len(deltas)


@pytest.mark.parametrize("dtype", DTYPES)
def test_schwarz_replay_matches_the_eager_cycle(cuda, dtype):
    A, M, _ = _elasticity((16, 16, 16), dtype, cuda, smoother="schwarz")
    assert any(lev.smoother is not None and lev.smoother.mode == "ilu0" for lev in M.levels)
    r = _rhs(A, dtype, cuda)
    outs, deltas = _hold(M, r, dtype)
    _assert_fresh(outs)
    eager = _eager_counts(M, r)
    assert eager["launches.tile_gs_sweeps"] > 0
    assert deltas == [eager] * len(deltas)


def test_profiled_calls_are_tagged_capture_then_replay(cuda):
    dtype = torch.float64
    A, M, _ = _elasticity((16, 16, 16), dtype, cuda)
    r = _rhs(A, dtype, cuda)
    first = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        outs, _ = _hold(M, r, dtype, calls=3)
    tags = [s.attrs["graph"] for s in profiling.spans()[first:]
            if s.name == "amg.cycle" and s.attrs["level"] == 0 and "graph" in s.attrs]
    assert tags == ["capture", "replay", "replay"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("parts", [(1, 1, 1), (2, 2, 2)], ids=["one_part", "parts8"])
def test_box_replay_matches_the_eager_cycle(cuda, dtype, parts):
    A, M = _box((24, 24, 24) if parts == (1, 1, 1) else (18, 18, 18), parts, dtype, cuda)
    assert all(M._flat_ok(l) == (parts == (1, 1, 1)) for l in range(len(M.levels) - 1))
    r = _rhs(A, dtype, cuda)
    outs, deltas = _hold(M, r, dtype)
    _assert_fresh(outs)
    eager = _eager_counts(M, r)
    if parts != (1, 1, 1):
        assert eager["exchanges.set"] > 0
    assert deltas == [eager] * len(deltas)


@pytest.mark.parametrize("dtype", DTYPES)
def test_update_captures_anew(cuda, dtype):
    A, M, (V, cache) = _elasticity((16, 16, 16), dtype, cuda, reuse=True)
    r = _rhs(A, dtype, cuda)
    _hold(M, r, dtype)
    old = list(M._graphs.values())
    psparse_refill(A, [v * 1.5 for v in V], cache)
    M.update(A)
    assert M.n_resetups == 0 and M._graphs == {}
    outs, deltas = _hold(M, r, dtype)
    assert len(M._graphs) == 1 and list(M._graphs.values())[0] is not old[0]
    _assert_fresh(outs)
    assert deltas == [_eager_counts(M, r)] * len(deltas)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swapped_smoothers_capture_anew(cuda, dtype):
    """The tile-tier level smoothers replaced by the sorted tier after a
    capture (as ``chip_smoke.py`` phase 4n does): the next call captures
    the new hierarchy, whose cycle it then replays; the older graph, which
    reads the replaced smoothers' freed tables, never replays."""
    A, M, _ = _elasticity((16, 16, 16), dtype, cuda)
    r = _rhs(A, dtype, cuda)
    _hold(M, r, dtype)
    old = list(M._graphs.values())
    swapped = 0
    for lev in M.levels:
        if lev.smoother is not None and lev.smoother.tile_gs is not None:
            lev.smoother = GaussSeidel(lev.A, lev.smoother.iterations, "symmetric", _sorted=True)
            swapped += 1
    assert swapped
    torch.cuda.empty_cache()
    outs, deltas = _hold(M, r, dtype)
    assert len(M._graphs) == 1 and list(M._graphs.values())[0] is not old[0]
    eager = _eager_counts(M, r)
    assert eager.get("launches.tile_gs_sweeps", 0) == 0
    assert deltas == [eager] * len(deltas)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cg_through_the_graph_takes_the_eager_iterations(cuda, dtype):
    A, M, _ = _elasticity((16, 16, 16), dtype, cuda)
    b = spmv(A, pones(A.col_prange, A.backend, dtype=dtype, device=cuda))
    rtol = 1e-8 if dtype == torch.float64 else 1e-5
    _, want = cg(A, b, M=lambda r: M._cycle(0, r, False), rtol=rtol, maxiter=200)
    _, got = cg(A, b, M=M, rtol=rtol, maxiter=200)
    assert M._graphs and all(isinstance(g, _CycleGraph) for g in M._graphs.values())
    assert int(got.iterations) == int(want.iterations)
    assert float(got.residual) == pytest.approx(float(want.residual),
                                                rel=1e-6 if dtype == torch.float64 else 1e-3)


def test_cg_df64_with_a_float32_amg_takes_the_eager_iterations(cuda):
    """``cg_df64`` preconditioned by the AMG of the float32 copy: M's input
    is a float32 vector on the card, so its cycle replays."""
    I, J, V, rows, cols = laplacian_fdm((24, 24, 24), (1, 1, 1))
    A = psparse(I, J, V, rows, cols, SerialBackend(1), device=cuda)
    xg = np.random.default_rng(7).standard_normal(A.shape[0])
    b = pvector_df64([to_global_scipy(A) @ xg], A.row_prange, A.backend, device=cuda)
    M = AMGPreconditioner(A.astype(np.float32), AMGParams(coarse_size=200))
    _, want = cg_df64(A, b, M=lambda r: M._cycle(0, r, False), rtol=1e-10, maxiter=300)
    before = _counts()
    _, got = cg_df64(A, b, M=M, rtol=1e-10, maxiter=300)
    assert len(M._graphs) == 1 and isinstance(list(M._graphs.values())[0], _CycleGraph)
    assert list(M._graphs)[0][1] == torch.float32
    assert int(got.iterations) == int(want.iterations)
    assert float(got.residual) == pytest.approx(float(want.residual), rel=1e-3)
    assert _delta(before, _counts())["launches.dia_spmv_df"] > 0


def test_benchmark_hierarchy_captures_every_launch(cuda):
    """The 40^3 elasticity hierarchy of ``amg_elasticity.40`` (float64): the
    fine level's K3 cooperative launch and level 1's K6 cluster launch are
    captured, no capture fails, and the calls replay."""
    dtype = torch.float64
    A, M, _ = _elasticity((40, 40, 40), dtype, cuda)
    r = _rhs(A, dtype, cuda)
    _, deltas = _hold(M, r, dtype, calls=5)
    eager = _eager_counts(M, r)
    assert eager["launches.gs_sweeps"] > 0 and eager["launches.tile_gs_sweeps"] > 0
    assert deltas == [eager] * len(deltas)
