"""The ghost layer of the PyTorch port against the JAX reference: partition
ghosts, exchange plans, the own-ghost block (K5), ``spmv`` with ghosts, the
standalone colored sweep (K2) and the ghosted Gauss-Seidel.

The HPCG operator at (2,2,2) parts of 8^3 is built by both packages in
closed form (JAX on the CPU, Pallas off; the port on the CPU, where every
kernel wrapper runs its plain PyTorch version).  Inputs are made with numpy
from a seed.  Index tables must agree exactly; values agree to rtol 1e-12 in
float64 (only the summation order differs) and 1e-5 in float32, relative to
the largest reference entry where entries can cancel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem as jax_build
from partitionedarrays_tpu.ops.ell import ell_spmv as jax_ell_spmv
from partitionedarrays_tpu.ops.slot_spmv import slot_spmv_ref as jax_slot_spmv_ref
from partitionedarrays_tpu.psparse import to_global_scipy as jax_to_global_scipy
from partitionedarrays_tpu.pvector import PVector as JaxPVector
from partitionedarrays_tpu.solvers.smoothers import GaussSeidel as JaxGaussSeidel

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.ops.blocks import freeze_block
from partitionedarrays_tpu_torch.ops.dia import dia_spmv_plain
from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv_strided
from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv, ghost_spmv_plain
from partitionedarrays_tpu_torch.psparse import spmv
from partitionedarrays_tpu_torch.pvector import PVector
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel
from partitionedarrays_tpu_torch.utils import profiling

torch.set_num_threads(1)

LOCAL = (8, 8, 8)
PARTS = (2, 2, 2)
P = 8
RTOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    yield
    jax_config.use_pallas = saved


@pytest.fixture(scope="module")
def problems():
    """dtype -> ((A_ref, b_ref), (A, b)) at (2,2,2) x 8^3."""
    out = {}
    for dtype in DTYPES:
        ref = jax_build(LOCAL, PARTS, JaxSerialBackend(P), dtype=dtype)
        mine = build_hpcg_problem(LOCAL, PARTS, SerialBackend(P), dtype=dtype, device="cpu")
        out[dtype] = (ref, mine)
    return out


def _close(got, ref, dtype):
    ref = np.asarray(ref)
    rtol = RTOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _random_parts(rng, counts, width, dtype):
    """[P, width] values, random on the first counts[p] lanes, zero after."""
    out = np.zeros((len(counts), width), dtype=dtype)
    for p, n in enumerate(counts):
        out[p, :n] = rng.standard_normal(int(n))
    return out


def test_partition_ghosts_match_jax(problems):
    """Own ids, ghost ids and ghost owners, part by part, and the padded
    sizes of both layouts."""
    (A_ref, _), (A, _) = problems[np.float64]
    for pr, pr_ref in ((A.row_prange, A_ref.row_prange), (A.col_prange, A_ref.col_prange)):
        assert pr.n_parts == pr_ref.n_parts and pr.n_global == pr_ref.n_global
        for mine, ref in zip(pr.parts, pr_ref.partition()):
            np.testing.assert_array_equal(mine.own_to_global, ref.own_to_global)
            np.testing.assert_array_equal(mine.ghost_to_global, ref.ghost_to_global)
            np.testing.assert_array_equal(mine.ghost_to_owner, ref.ghost_to_owner)
    for lay, ref in ((A.row_layout(), A_ref.row_layout()), (A.col_layout(), A_ref.col_layout())):
        assert (lay.n_own_pad, lay.n_ghost_pad) == (ref.n_own_pad, ref.n_ghost_pad)
        np.testing.assert_array_equal(lay.n_ghost, ref.n_ghost)
    assert A.col_layout().n_ghost_pad == 224
    assert A.nnz() == A_ref.nnz()


@pytest.mark.parametrize("which", ["consistent_plan", "assemble_plan"])
def test_exchange_tables_match_jax(problems, which):
    """Rounds and padded index tables, table for table (7 rounds)."""
    (A_ref, _), (A, _) = problems[np.float64]
    plan = getattr(A.col_layout(), which)
    ref = getattr(A_ref.col_layout(), which)
    assert plan.n_rounds == ref.n_rounds == 7
    assert plan.perms == ref.perms
    for mine, theirs in zip(plan.snd_idx + plan.rcv_idx, ref.snd_idx + ref.rcv_idx):
        np.testing.assert_array_equal(mine, np.asarray(theirs))


@pytest.mark.parametrize("combine", ["set", "add"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_exchange_apply_matches_jax(problems, combine, dtype):
    """"set" (consistent: own -> ghost slots) and "add" (assemble: ghost ->
    own slots) on random data, against the reference's rounds."""
    (A_ref, _), (A, _) = problems[dtype]
    lay, lay_ref = A.col_layout(), A_ref.col_layout()
    rng = np.random.default_rng(40)
    own = _random_parts(rng, lay.n_own, lay.n_own_pad, dtype)
    ghost = _random_parts(rng, lay.n_ghost, lay.n_ghost_pad, dtype)
    if combine == "set":
        plan, plan_ref, src, dst = lay.consistent_plan, lay_ref.consistent_plan, own, ghost
    else:
        plan, plan_ref, src, dst = lay.assemble_plan, lay_ref.assemble_plan, ghost, own
    ref = JaxSerialBackend(P).spmd(lambda s, d, pl: pl.apply(s, d, combine))(
        jnp.asarray(src), jnp.asarray(dst), plan_ref
    )
    dst_t = torch.from_numpy(dst)
    got = plan.apply(torch.from_numpy(src), dst_t, combine)
    np.testing.assert_array_equal(dst_t.numpy(), dst)  # the input is left alone
    if combine == "set":
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        _close(got.numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ghost_spmv_plain_matches_ell_and_slot(problems, dtype):
    """K5's plain version on the port's compressed rows against the
    reference's ELL gather and its slot-kernel twin (``slot_spmv_ref`` on the
    frozen block's slot arrays)."""
    (A_ref, _), (A, _) = problems[dtype]
    oh, oh_ref = A.device().oh, A_ref.device().oh
    assert oh.kind == "ell" and oh_ref.slot is not None
    lay = A.col_layout()
    g = _random_parts(np.random.default_rng(41), lay.n_ghost, lay.n_ghost_pad, dtype)
    got = ghost_spmv_plain(
        oh.rows, oh.cols, oh.vals, torch.from_numpy(g), torch.zeros(P, oh.n_rows, dtype=oh.vals.dtype)
    ).numpy()
    ell = jax.vmap(jax_ell_spmv)(oh_ref.cols, oh_ref.vals, jnp.asarray(g))
    s_idx, s_vals, s_srow, _, s_base = oh_ref.slot
    slot = jax.vmap(lambda i, v, s, b, x: jax_slot_spmv_ref(i, v, s, b, x, oh_ref.slot_meta))(
        s_idx, s_vals, s_srow, s_base, jnp.asarray(g)
    )
    _close(got, ell, dtype)
    _close(got, slot, dtype)
    # only the rows with nonzeros are stored
    nonempty = [np.count_nonzero(np.diff(b["oh"].indptr)) for b in A_ref.blocks]
    assert oh.rows.shape[1] == -(-max(nonempty) // 8) * 8
    assert int((oh.rows >= 0).sum()) == sum(nonempty)


@pytest.mark.parametrize("home", ["row", "col"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_spmv_with_ghosts_matches_global(problems, home, dtype):
    """``spmv`` (exchange, K1 and K5) against the reference's global matrix
    times the same global x, from either layout."""
    (A_ref, _), (A, _) = problems[dtype]
    A_glob = jax_to_global_scipy(A_ref)
    x = np.random.default_rng(42).standard_normal(A.shape[1]).astype(dtype)
    lay = A.row_layout() if home == "row" else A.col_layout()
    own = np.zeros((P, lay.n_own_pad), dtype=dtype)
    for p, part in enumerate(lay.pr.parts):
        own[p, : part.n_own] = x[part.own_to_global]
    own_t = torch.from_numpy(own)
    xv = PVector(own_t, own_t.new_zeros(P, lay.n_ghost_pad), lay, A.backend)
    y = spmv(A, xv).own.numpy()
    want = A_glob @ x.astype(np.float64)
    got = np.concatenate(
        [y[p, : part.n_own] for p, part in enumerate(A.row_prange.parts)]
    )
    order = np.concatenate([part.own_to_global for part in A.row_prange.parts])
    _close(got, want[order], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_matches_jax(problems, dtype):
    """``ColoredDIAGS.sweep`` (K2's plain version per color) against the
    reference's standalone sweep, symmetric order, with a ghost
    contribution."""
    (A_ref, _), (A, _) = problems[dtype]
    col = GaussSeidel(A).colored
    col_ref = JaxGaussSeidel(A_ref).colored
    n_own_pad = A.row_layout().n_own_pad
    rng = np.random.default_rng(43)
    xo, bo, gc = (rng.standard_normal((P, n_own_pad)).astype(dtype) for _ in range(3))
    order = tuple(range(col.m)) + tuple(reversed(range(col.m)))
    ref = jax.vmap(lambda x, b, g, v, i: col_ref.sweep(x, b, g, v, i, order))(
        xo, bo, gc, col_ref.vals_d, col_ref.invd_d
    )
    t = torch.from_numpy
    got = col.sweep(t(xo), t(bo), t(gc), col.vals_d, col.invd_d, order)
    _close(got.numpy(), ref, dtype)


@pytest.mark.parametrize("zero_guess", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gauss_seidel_with_ghosts_matches_jax(problems, zero_guess, dtype):
    """``GaussSeidel.apply`` from a nonzero guess, and the preconditioner
    call from zero, with ghosts: one exchange, K5, then the sweeps."""
    (A_ref, b_ref), (A, b) = problems[dtype]
    gs, gs_ref = GaussSeidel(A), JaxGaussSeidel(A_ref)
    lay = A.row_layout()
    own = _random_parts(np.random.default_rng(44), lay.n_own, lay.n_own_pad, dtype)
    if zero_guess:
        ref, got = gs_ref(b_ref), gs(b)
    else:
        zg = np.zeros((P, lay.n_ghost_pad), dtype=dtype)
        x_ref = JaxPVector(jnp.asarray(own), jnp.asarray(zg), A_ref.row_layout(), b_ref.backend)
        ref = gs_ref.apply(x_ref, b_ref)
        got = gs.apply(PVector(torch.from_numpy(own), torch.from_numpy(zg), lay, A.backend), b)
    _close(got.own.numpy(), ref.own, dtype)
    assert got.layout is lay


@pytest.mark.parametrize("dtype", DTYPES)
def test_ghost_contrib_matches_jax(problems, dtype):
    (A_ref, _), (A, _) = problems[dtype]
    lay = A.row_layout()
    own = _random_parts(np.random.default_rng(45), lay.n_own, lay.n_own_pad, dtype)
    ref = JaxGaussSeidel(A_ref).ghost_contrib(jnp.asarray(own))
    _close(GaussSeidel(A).ghost_contrib(torch.from_numpy(own)).numpy(), ref, dtype)


def test_freeze_block_picks_dia_for_bands_and_rows_for_the_rest():
    """A banded block freezes to DIA (K1), a scattered one to the
    compressed rows (K5); both multiply as scipy does."""
    rng = np.random.default_rng(46)
    band = [sp.diags([rng.standard_normal(40) for _ in range(3)], [-1, 0, 1], shape=(40, 40)).tocsr()]
    scattered = [sp.random(40, 30, density=0.05, random_state=s, format="csr") for s in (1, 2)]
    dia = freeze_block(band, 40, 40, device="cpu")
    ell = freeze_block(scattered, 40, 30, device="cpu")
    assert dia.kind == "dia" and dia.offsets == (-1, 0, 1)
    assert ell.kind == "ell" and ell.rows.dtype == torch.int32
    for blk, mats, n_cols in ((dia, band, 40), (ell, scattered, 30)):
        x = rng.standard_normal((len(mats), n_cols))
        got = blk.spmv(torch.from_numpy(x)).numpy()
        for p, m in enumerate(mats):
            np.testing.assert_allclose(got[p], m @ x[p], rtol=1e-12, atol=1e-12)


def test_dia_spmv_strided_plain_on_views():
    """K2's CPU route is ``dia_spmv_plain`` on the strided views: equal to
    the product of contiguous copies, and no launch is counted."""
    rng = np.random.default_rng(47)
    vals_d = torch.from_numpy(rng.standard_normal((3, 4, 5, 64)))  # [P, m, n_off, Lq]
    core = torch.from_numpy(rng.standard_normal((3, 4 * 64)))
    offsets = (-70, -1, 0, 3, 130)
    before = profiling.launches("dia_spmv_strided")
    got = dia_spmv_strided(offsets, vals_d[:, 2], core)
    assert profiling.launches("dia_spmv_strided") == before
    want = dia_spmv_plain(offsets, vals_d[:, 2].contiguous(), core.contiguous())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_ghost_spmv_accumulates_in_place_on_cpu():
    """The CPU route adds into the given output and counts no launch;
    padding rows and lanes contribute nothing."""
    rows = torch.tensor([[2, 0, -1]], dtype=torch.int32)
    cols = torch.tensor([[[1, 0, -1], [-1, 2, -1]]], dtype=torch.int32)  # [1, K=2, Nr=3]
    vals = torch.tensor([[[2.0, 3.0, 0.0], [0.0, 5.0, 0.0]]], dtype=torch.float64)
    x = torch.tensor([[10.0, 20.0, 30.0]], dtype=torch.float64)
    y = torch.ones(1, 4, dtype=torch.float64)
    before = profiling.launches("ghost_spmv")
    out = ghost_spmv(rows, cols, vals, x, y)
    assert out is y and profiling.launches("ghost_spmv") == before
    np.testing.assert_array_equal(y.numpy(), [[1 + 3 * 10 + 5 * 30, 1, 1 + 2 * 20, 1]])
