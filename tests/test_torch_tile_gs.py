"""The tile Gauss-Seidel tier of the PyTorch port (``NaturalTileGS``, kernel
K6's plain version) against the JAX reference's (``solvers/gs_slot.py``,
its XLA twin with Pallas off).

Operators, one part each, built by both packages from the same triplets:

- "banded": the one-part counterpart of ``tests/test_slot_spmv.py``'s
  batched-wave case, 1024 rows in 8 tiles whose tiles couple only to
  neighbours (so B > 1);
- "elasticity_level1": the level-1 Galerkin operator of the reference's
  SA-AMG hierarchy of 3-D elasticity at 10^3 nodes (rigid-body nullspace,
  block size 3), re-assembled from its host blocks.

Every test asserts that the reference took the tile tier.  The schedules,
W and B must be identical; the sweeps (forward, backward, symmetric, from a
zero and a nonzero guess) agree to rtol 1e-12 (float64) and 1e-5 (float32)
of the largest reference entry, and equal exact pointwise Gauss-Seidel in
the wave-major row order (scipy's triangular solve, float64, 1e-10).
"""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits
from scipy.sparse.linalg import spsolve_triangular

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.parallel.p_range import variable_partition as jax_variable_partition
from partitionedarrays_tpu.solvers import gs_slot as jax_gs_slot
from partitionedarrays_tpu.solvers.amg import AMGParams as JaxAMGParams
from partitionedarrays_tpu.solvers.amg import AMGPreconditioner as JaxAMG
from partitionedarrays_tpu.solvers.smoothers import GaussSeidel as JaxGaussSeidel

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.parallel.partition import variable_partition
from partitionedarrays_tpu_torch.psparse import psparse
from partitionedarrays_tpu_torch.pvector import pvector_from_own
from partitionedarrays_tpu_torch.solvers import gs_slot
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
SWEEPS = ["forward", "backward", "symmetric"]


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


def _banded():
    """1024 rows, 9 entries per row within a 200-wide band, symmetrised and
    made diagonally dominant."""
    n = 1024
    rng = np.random.default_rng(100)
    rows, cols, vals = [], [], []
    for r in range(n):
        lo, hi = max(0, r - 100), min(n, r + 101)
        c = rng.choice(np.arange(lo, hi), size=9, replace=False)
        rows += [r] * 9
        cols += list(c)
        vals += list(rng.standard_normal(9))
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A = A + A.T
    return (A + sp.diags(np.abs(A).sum(1).A1 + 1.0)).tocsr()


def _elasticity_level1():
    nodes = (10, 10, 10)
    I, J, V, rows, cols = jax_gallery.linear_elasticity_fem(nodes, (1, 1, 1))
    A = jax_psparse.psparse(I, J, V, JaxPRange(rows), JaxPRange(cols), JaxSerialBackend(1))
    coords, _ = jax_gallery.node_coordinates_unit_cube(nodes, (1, 1, 1))
    ns = jax_gallery.nullspace_linear_elasticity(coords, A.row_prange)
    M = JaxAMG(A, JaxAMGParams(coarse_size=100, block_size=3, max_levels=3), nullspace=ns)
    return jax_psparse.to_global_scipy(M.levels[1].A)


OPERATORS = {"banded": _banded, "elasticity_level1": _elasticity_level1}
_cache = {}


def operators(name, dtype):
    """(port A, reference A) on one part, from the same host matrix."""
    key = (name, dtype)
    if key not in _cache:
        G = OPERATORS[name]().tocoo()
        n = G.shape[0]
        tri = ([G.row.astype(np.int64)], [G.col.astype(np.int64)], [G.data.astype(dtype)])
        A = psparse(*tri, variable_partition([n]), variable_partition([n]), SerialBackend(1),
                    device="cpu")
        A_ref = jax_psparse.psparse(*tri, JaxPRange(jax_variable_partition([n])),
                                    JaxPRange(jax_variable_partition([n])), JaxSerialBackend(1),
                                    assembled=True)
        _cache[key] = (A, A_ref)
    return _cache[key]


def smoothers(name, dtype, sweep, iterations=1):
    A, A_ref = operators(name, dtype)
    gs = GaussSeidel(A, iterations, sweep)
    gs_ref = JaxGaussSeidel(A_ref, iterations, sweep)
    assert gs_ref.colored is None and gs_ref.slot_gs is not None, "the reference took the tile tier"
    assert gs.colored is None and gs.tile_gs is not None
    return A, A_ref, gs, gs_ref


def vectors(A, A_ref, dtype, seed):
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    own = [rng.standard_normal(n).astype(dtype)]
    return (
        own,
        pvector_from_own(own, A.row_prange, A.backend, device="cpu"),
        jax_pvector.pvector_from_own(own, A_ref.row_prange, A_ref.backend),
    )


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def test_wave_schedule_is_the_reference_s():
    rng = np.random.default_rng(3)
    for nt, B in ((1, 8), (12, 8), (40, 3), (40, 8)):
        adj = [set() for _ in range(nt)]
        for a, b in rng.integers(0, nt, size=(2 * nt, 2)):
            if a != b:
                adj[a].add(int(b))
                adj[b].add(int(a))
        for topo in (False, True):
            assert gs_slot._wave_schedule(adj, nt, B, topo) == jax_gs_slot._wave_schedule(adj, nt, B, topo)


@pytest.mark.parametrize("name", list(OPERATORS))
def test_schedules_w_and_b_match(name):
    A, A_ref, gs, gs_ref = smoothers(name, np.float64, "symmetric")
    tg, ref = gs.tile_gs, gs_ref.slot_gs
    assert tg.schedules == ref.schedules
    assert (tg.W, tg.B, tg.n_real_tiles, tg.Rp) == (ref.W, ref.B, ref.n_real_tiles, ref.Rp)
    if name == "banded":
        assert tg.B > 1 and tg.W < tg.n_real_tiles, "the waves batch uncoupled tiles"


@pytest.mark.parametrize("guess", ["zero", "nonzero"])
@pytest.mark.parametrize("sweep", SWEEPS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(OPERATORS))
def test_sweeps_match_the_reference(name, dtype, sweep, guess):
    A, A_ref, gs, gs_ref = smoothers(name, dtype, sweep, iterations=2 if sweep == "forward" else 1)
    n = A.shape[0]
    _, b, b_ref = vectors(A, A_ref, dtype, 11)
    if guess == "zero":
        got, want = gs(b), gs_ref(b_ref)
    else:
        _, x, x_ref = vectors(A, A_ref, dtype, 12)
        got, want = gs.apply(x, b), gs_ref.apply(x_ref, b_ref)
    _close(got.own.numpy()[0, :n], np.asarray(want.own)[0, :n], RTOL[dtype])


def _wave_major_perm(tg, n):
    return np.concatenate([
        np.arange(t * 128, min((t + 1) * 128, n)) for wave in tg.schedules[0] for t in wave if t * 128 < n
    ])


def _pointwise_gs(A, b, x0, order):
    """Pointwise Gauss-Seidel in an explicit row order (float64)."""
    x = x0.copy()
    for i in order:
        lo, hi = A.indptr[i], A.indptr[i + 1]
        x[i] += (b[i] - A.data[lo:hi] @ x[A.indices[lo:hi]]) / A[i, i]
    return x


@pytest.mark.parametrize("name", list(OPERATORS))
def test_sweeps_are_exact_gs_in_wave_major_order(name):
    A, A_ref, gs, gs_ref = smoothers(name, np.float64, "forward")
    n = A.shape[0]
    G = A.blocks[0]["oo"].tocsr()
    perm = _wave_major_perm(gs.tile_gs, n)
    own, b, _ = vectors(A, A_ref, np.float64, 21)
    # forward from a zero guess: the lower-triangular solve in the permuted order
    Gp = G[perm][:, perm]
    xperm = spsolve_triangular(sp.tril(Gp).tocsr(), own[0][perm], lower=True)
    want = np.empty(n)
    want[perm] = xperm
    _close(gs(b).own.numpy()[0, :n], want, 1e-10)
    # symmetric from a nonzero guess: forward then backward in that order
    gs_sym = GaussSeidel(A, 1, "symmetric")
    x_own, x, _ = vectors(A, A_ref, np.float64, 22)
    want = _pointwise_gs(G, own[0], x_own[0], perm)
    want = _pointwise_gs(G, own[0], want, perm[::-1])
    _close(gs_sym.apply(x, b).own.numpy()[0, :n], want, 1e-10)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_on_a_non_banded_block_matches(dtype):
    """``JacobiCorrection`` takes a non-banded own block's diagonal from
    the host blocks, as the reference always does."""
    from partitionedarrays_tpu.solvers.smoothers import JacobiCorrection as JaxJacobi

    from partitionedarrays_tpu_torch.solvers.smoothers import JacobiCorrection

    A, A_ref = operators("banded", dtype)
    assert A.device().oo.kind == "ell"
    n = A.shape[0]
    _, r, r_ref = vectors(A, A_ref, dtype, 31)
    _close(JacobiCorrection(A)(r).own.numpy()[0, :n], np.asarray(JaxJacobi(A_ref)(r_ref).own)[0, :n],
           RTOL[dtype])
