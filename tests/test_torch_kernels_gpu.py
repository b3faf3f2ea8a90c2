"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 ``dia_spmv``, K4 ``ax_core`` and K3 ``gs_sweeps`` run on CUDA tensors of
the 32^3 HPCG operator (K4 also on every level of its 4-level hierarchy
under every lane count), K5 ``ghost_spmv`` and K2 ``dia_spmv_strided`` (every
color; a view that is not 16-byte aligned raises) on those of the (2,2,2) x
16^3 one, and are compared with their plain versions on the same tensors.
K3 runs each whole color sequence in one launch; it is also held at 27
colors and 99 diagonals (7^3-node elasticity), on a small coarse level
(8^3), on the levels of the 64^3 and 48^3 Laplacians' box-AMG
hierarchies (with K4 under every lane count, and K1 on their fine
operators), and at every lane count: forward, backward, symmetric and twice
symmetric, from a guess and from a zero guess.  Tolerance: rtol 1e-5 in
float32 and 1e-12 in float64, relative to the largest plain entry, since
only FMA contraction and the order of the sums differ.  K7 ``dia_spmv_df``
runs on the (hi, lo) float32 pair of the float64 operator at both shapes
and on that of the 48^3 7-point Laplacian,
and is held to 1e-13 of ``sum_j |A_ij| |x_j|`` per row (the bound of
``tests/test_df64.py``); the kernel and its plain version round every
operation alike, so they are expected to agree exactly.  K1 also runs at the 99 diagonals of the 3-D
elasticity block (6^3 nodes, COO assembly), and K6 ``tile_gs_sweeps`` on
the tile smoother of an elasticity AMG level 1, of a banded operator, of a
level whose waves hold one tile (B = 1) and of two parts stacked
(forward, backward, symmetric and twice symmetric, from a zero and a
nonzero guess; one launch per call), at the same tolerances; a K6 launch
the card cannot take raises.  K5 also runs on the prolongators,
restrictions and coarse operators of the 8^3-node elasticity hierarchy
under every warps-per-group count.  Across parts: K6 with P = 8 clusters
on the fine tile level of 3-D elasticity on (2,2,2) parts of unequal size,
and K5 on the own-ghost blocks and their transposes (``spmtv``) of that
hierarchy and of a matrix with a part that has no ghost columns.  K6 in
one-direction mode: the triangular solves of the ILU(0) Schwarz tier on
four parts and on the 16^3 HPCG operator, against the plain version and,
in float64, against scipy's ``spsolve_triangular``.  Narrow values
(bfloat16 or float16 values with float32 or float64 vectors, float32
values with float64 vectors): K2, K3 and K4 on random values of the HPCG
stencil's pattern, against their plain versions at the vector dtype's
tolerance, K3 and K4 under every lane count; on HPCG's own values, exact
in bfloat16 and float16, equal to the full-value kernels bit for bit (the same plan, the
same order of the sums; K4 under every lane count).  K2, K3 and K4 refuse
operands that start one element into their storage (ValueError, no
launch).  K1 and K3 also run on the own-own block of a Laplacian on part
boxes of unequal shape (13 offsets, the union of the parts', with zero
diagonals and zero padding rows).  ``b_cg`` on a coupled two-field block
system (8^3 on (2,2,2) parts) runs four K1 and two K5 launches an
iteration on the card and takes the CPU's iterations to its solution.
The sorted-by-color Gauss-Seidel tier (forced by ``GaussSeidel(...,
_sorted=True)``) sweeps with K5 on each color's rows of the 8^3-node
elasticity block and of the 8^3 HPCG operator on (2,2,2) parts (ghost
columns), against its plain sweep through ``ell_spmv``.

Every test is marked ``gpu`` and skips without a CUDA card.  This module
imports torch and the port only (no JAX), so that it also runs on a
machine without JAX:

    python -m pytest --noconftest -p no:randomly tests/test_torch_kernels_gpu.py -q
"""
import pytest
import torch

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.ops.dia import dia_spmv_plain
from partitionedarrays_tpu_torch.ops import df64 as df
from partitionedarrays_tpu_torch.ops.dia_rows import AxPlan, SweepPlan, sweep_plan
from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_df, dia_spmv_strided
from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv, ghost_spmv_plain
from partitionedarrays_tpu_torch.ops.gs_dia_kernels import (
    TapTable,
    ax_core,
    ax_core_plain,
    gs_sweeps,
    gs_sweeps_plain,
)
from partitionedarrays_tpu_torch.solvers.gs_dia import ColoredDIAGS
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel
from partitionedarrays_tpu_torch.utils import profiling

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.float64]
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
AX_PLANS = [AxPlan(lanes) for lanes in (1, 2, 4, 8, 16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _operator(device, dtype):
    A, b = build_hpcg_problem((32, 32, 32), (1, 1, 1), SerialBackend(1), dtype=dtype, device=device)
    return A, b, GaussSeidel(A)


def _assert_close(got, ref, dtype):
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    assert err <= RTOL[dtype] * ref.abs().max().item(), err


@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_spmv_kernel_matches_plain(cuda, dtype):
    A, _, _ = _operator(cuda, dtype)
    oo = A.device().oo
    g = torch.Generator().manual_seed(5)
    x = torch.randn(oo.vals.shape[0], oo.n_cols_pad, generator=g, dtype=dtype).to(cuda)
    before = profiling.launches("dia_spmv")
    got = dia_spmv(oo.offsets, oo.vals, x)
    assert profiling.launches("dia_spmv") == before + 1
    _assert_close(got, dia_spmv_plain(oo.offsets, oo.vals, x), dtype)


def _hold_ax(col, dtype, device, seed, plans=(None,)):
    """K4 against its plain version on a random x, one launch per call,
    under each plan (``None``: ``ax_plan`` of the shape)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(col.vals_d.shape[0], col.m, col.Lq, generator=g, dtype=dtype).to(device)
    want = ax_core_plain(col.vals_d, x, col.taps)
    for plan in plans:
        before = profiling.launches("ax_core")
        got = ax_core(col.vals_d, x, col.taps, _plan=plan)
        assert profiling.launches("ax_core") == before + 1 and got.dtype == dtype
        _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ax_core_kernel_matches_plain(cuda, dtype):
    """K4 on every level of the 4-level 32^3 HPCG hierarchy (32^3 .. 4^3,
    9 to 10 colors, 1,024 to 4,096 rows per color) under its plan and
    every other lane count."""
    from partitionedarrays_tpu_torch.config import numpy_dtype
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner

    mg = HPCGMGPreconditioner((32, 32, 32), (1, 1, 1), SerialBackend(1), n_levels=4,
                              dtype=numpy_dtype(dtype).type, device=cuda)
    for l, gs in enumerate(reversed(mg.gss)):
        _hold_ax(gs.colored, dtype, cuda, 60 + l, [None] + AX_PLANS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gs_sweeps_kernel_matches_plain(cuda, dtype):
    _, b, gs = _operator(cuda, dtype)
    col = gs.colored
    g = torch.Generator().manual_seed(15)
    x = torch.randn(1, col.m, col.Lq, generator=g, dtype=dtype).to(cuda)
    bd = gs.make_bd(b)
    order = gs._order_seq()
    before = profiling.launches("gs_sweeps")
    got = gs_sweeps(col.vals_d, bd, col.invd_d, x, col.taps, order)
    assert profiling.launches("gs_sweeps") == before + 1  # one launch per color sequence
    _assert_close(got, gs_sweeps_plain(col.vals_d, bd, col.invd_d, x, col.taps, order), dtype)


def test_cuda_tensor_of_another_dtype_raises(cuda):
    _, _, gs = _operator(cuda, torch.float64)
    col = gs.colored
    x = torch.zeros(1, col.m, col.Lq, dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        ax_core(col.vals_d, x, col.taps)


def _orders(m):
    fwd = tuple(range(m))
    return {"forward": fwd, "backward": fwd[::-1], "symmetric": fwd + fwd[::-1],
            "symmetric x2": 2 * (fwd + fwd[::-1])}


def _hold_sweeps(col, dtype, device, seed, plans=(None,)):
    """K3 against its plain version: every order of ``_orders``, from a
    random guess and from a zero guess (plain: on a zero core), one launch
    per call, under each plan."""
    g = torch.Generator().manual_seed(seed)
    P = col.vals_d.shape[0]
    x = torch.randn(P, col.m, col.Lq, generator=g, dtype=dtype).to(device)
    bd = torch.randn(P, col.m, col.Lq, generator=g, dtype=dtype).to(device)
    for order in _orders(col.m).values():
        for start in (x, None):
            want = gs_sweeps_plain(col.vals_d, bd, col.invd_d,
                                   torch.zeros_like(x) if start is None else start, col.taps, order)
            for plan in plans:
                before = profiling.launches("gs_sweeps")
                got = gs_sweeps(col.vals_d, bd, col.invd_d, start, col.taps, order, _plan=plan)
                assert profiling.launches("gs_sweeps") == before + 1
                _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gs_sweeps_kernel_at_27_colors_99_diagonals(cuda, dtype):
    gs = GaussSeidel(_elasticity(cuda, dtype, (7, 7, 7)))
    col = gs.colored
    assert (col.m, len(col.offsets)) == (27, 99)
    _hold_sweeps(col, dtype, cuda, 21)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gs_sweeps_kernel_on_a_small_coarse_level(cuda, dtype):
    """8^3 on one part (m = 10): 1,024 rows per color, 16 lanes a row group."""
    A, _ = build_hpcg_problem((8, 8, 8), (1, 1, 1), SerialBackend(1), dtype=dtype, device=cuda)
    col = GaussSeidel(A).colored
    assert sweep_plan(1, col.m, 27, col.Lq, col.vals_d.element_size()).lanes == 16
    _hold_sweeps(col, dtype, cuda, 22)


def _box_amg(device, dtype, n):
    """The box AMG (coarse size 200) of the n^3 7-point Laplacian."""
    from partitionedarrays_tpu_torch.config import numpy_dtype
    from partitionedarrays_tpu_torch.models.gallery import laplacian_fdm
    from partitionedarrays_tpu_torch.psparse import psparse
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner

    I, J, V, rows, cols = laplacian_fdm((n, n, n), (1, 1, 1), dtype=numpy_dtype(dtype).type)
    A = psparse(I, J, V, rows, cols, SerialBackend(1), device=device)
    return A, AMGPreconditioner(A, AMGParams(coarse_size=200))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, boxes", [(64, (64, 22, 8)), (48, (48, 16, 6))])
def test_gs_sweeps_and_ax_core_on_the_box_amg_levels(cuda, dtype, n, boxes):
    """The box-AMG hierarchies of the 64^3 and 48^3 7-point Laplacians
    (coarse size 200): K3 and K4 on the 7-point fine level and on the
    27-point Galerkin levels (22^3 and 8^3 boxes; 16^3 and 6^3), whose row
    counts are no powers of two (10,648, 216), and K1 on the fine operator
    (CG's A p)."""
    A, M = _box_amg(cuda, dtype, n)
    levels = [lev for lev in M.levels if lev.smoother is not None]
    assert [lev.struct.fine for lev in levels] == [(k,) * 3 for k in boxes]
    assert [len(lev.A.device().oo.offsets) for lev in levels] == [7, 27, 27]
    g = torch.Generator().manual_seed(40)
    oo = A.device().oo
    x = torch.randn(1, oo.n_cols_pad, generator=g, dtype=dtype).to(cuda)
    before = profiling.launches("dia_spmv")
    got = dia_spmv(oo.offsets, oo.vals, x)
    assert profiling.launches("dia_spmv") == before + 1
    _assert_close(got, dia_spmv_plain(oo.offsets, oo.vals, x), dtype)
    for i, lev in enumerate(levels):
        col = lev.smoother.colored
        _hold_sweeps(col, dtype, cuda, 41 + i)
        _hold_ax(col, dtype, cuda, 44 + i, [None] + AX_PLANS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gs_sweeps_kernel_every_lane_count(cuda, dtype):
    """Every lane count, with one CTA per part and with many, on the 16^3
    level of (2,2,2) parts (8 parts) and on the 32^3 operator of one part."""
    for shape, parts in (((16, 16, 16), (2, 2, 2)), ((32, 32, 32), (1, 1, 1))):
        P = parts[0] * parts[1] * parts[2]
        A, _ = build_hpcg_problem(shape, parts, SerialBackend(P), dtype=dtype, device=cuda)
        col = GaussSeidel(A).colored
        plans = [SweepPlan(lanes, width) for lanes in (1, 2, 4, 8, 16) for width in (1, 64)]
        _hold_sweeps(col, dtype, cuda, 23, plans)


def test_gs_sweeps_refused_launch_raises(cuda):
    """A launch the kernel cannot take (a tap table over its 48 KB of
    shared memory: 128 colors x 99 taps) is refused and the wrapper raises
    (no per-color fallback); the next launch runs."""
    m, n_off, Lq = 128, 99, 4
    taps = TapTable([[0] * n_off for _ in range(m)])
    vals = torch.zeros(1, m, n_off, Lq, device=cuda)
    bd = torch.zeros(1, m, Lq, device=cuda)
    with pytest.raises(RuntimeError):
        gs_sweeps(vals, bd, torch.zeros_like(bd), None, taps, (0,))
    _, b, gs = _operator(cuda, torch.float64)
    col = gs.colored
    bd = gs.make_bd(b)
    order = gs._order_seq()
    got = gs_sweeps(col.vals_d, bd, col.invd_d, None, col.taps, order)
    _assert_close(got, gs_sweeps_plain(col.vals_d, bd, col.invd_d, torch.zeros_like(bd),
                                       col.taps, order), torch.float64)


def _ghosted(device, dtype):
    A, b = build_hpcg_problem((16, 16, 16), (2, 2, 2), SerialBackend(8), dtype=dtype, device=device)
    return A, b, GaussSeidel(A)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ghost_spmv_kernel_matches_plain(cuda, dtype):
    A, _, _ = _ghosted(cuda, dtype)
    oh = A.device().oh
    assert oh.kind == "ell"
    g = torch.Generator().manual_seed(16)
    x = torch.randn(8, A.col_layout().n_ghost_pad, generator=g, dtype=dtype).to(cuda)
    y0 = torch.randn(8, oh.n_rows, generator=g, dtype=dtype).to(cuda)
    before = profiling.launches("ghost_spmv")
    got = ghost_spmv(oh.rows, oh.cols, oh.vals, x, y0.clone())
    assert profiling.launches("ghost_spmv") == before + 1
    _assert_close(got, ghost_spmv_plain(oh.rows, oh.cols, oh.vals, x, y0.clone()), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_spmv_strided_kernel_matches_plain(cuda, dtype):
    _, _, gs = _ghosted(cuda, dtype)
    col = gs.colored
    g = torch.Generator().manual_seed(17)
    core = torch.randn(8, col.m * col.Lq, generator=g, dtype=dtype).to(cuda)
    for c in range(col.m):
        before = profiling.launches("dia_spmv_strided")
        got = dia_spmv_strided(col.taps.host[c], col.vals_d[:, c], core)
        assert profiling.launches("dia_spmv_strided") == before + 1
        _assert_close(got, dia_spmv_plain(col.taps.host[c], col.vals_d[:, c], core), dtype)
    # copies that start 1 element into their storage are not 16-byte
    # aligned: the row engine refuses them in K2, K3 and K4 (no scalar form)
    launches = profiling.launches("dia_spmv_strided"), profiling.launches("gs_sweeps"), profiling.launches("ax_core")
    with pytest.raises(ValueError):
        dia_spmv_strided(col.taps.host[1], _misaligned(col.vals_d[:, 1]), core)
    with pytest.raises(ValueError):
        gs_sweeps(col.vals_d, _misaligned(col.invd_d), col.invd_d, None, col.taps, (0,))
    with pytest.raises(ValueError):
        ax_core(_misaligned(col.vals_d), core.view(8, col.m, col.Lq), col.taps)
    with pytest.raises(ValueError):
        ax_core(col.vals_d, _misaligned(core.view(8, col.m, col.Lq)), col.taps)
    assert (profiling.launches("dia_spmv_strided"), profiling.launches("gs_sweeps"), profiling.launches("ax_core")) == launches


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 1 element into its storage."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_through_k2_matches_sweeps_core(cuda, dtype):
    """The standalone sweep (K2 per color) and the smoother's sweep
    sequence (K3) on the same input with a ghost contribution."""
    _, b, gs = _ghosted(cuda, dtype)
    col = gs.colored
    g = torch.Generator().manual_seed(18)
    x = torch.randn(8, b.own.shape[1], generator=g, dtype=dtype).to(cuda)
    gc = gs.ghost_contrib(x)
    order = gs._order_seq()
    got = col.sweep(x, b.own, gc, col.vals_d, col.invd_d, order)
    want = col.interleave_core(col.sweeps_core(
        col.deinterleave(x), col.deinterleave(b.own - gc), col.vals_d, col.invd_d, order
    ))
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("shape, parts", [((32, 32, 32), (1, 1, 1)), ((16, 16, 16), (2, 2, 2))])
def test_dia_spmv_df_kernel_matches_plain(cuda, shape, parts):
    P = parts[0] * parts[1] * parts[2]
    A, _ = build_hpcg_problem(shape, parts, SerialBackend(P), dtype=torch.float64, device=cuda)
    oo = A.device().oo
    vh, vl = df.from_f64(oo.vals)
    g = torch.Generator().manual_seed(19)
    x64 = torch.randn(P, oo.n_cols_pad, generator=g, dtype=torch.float64).to(cuda)
    x = df.from_f64(x64)
    before = profiling.launches("dia_spmv_df")
    got = dia_spmv_df(oo.offsets, vh, vl, x)
    assert profiling.launches("dia_spmv_df") == before + 1
    want = df.dia_spmv_df_plain(oo.offsets, vh, vl, x)
    torch.cuda.synchronize()
    scale = dia_spmv(oo.offsets, oo.vals.abs(), x64.abs()) + 1e-30
    err = (df.to_f64(*got) - df.to_f64(*want)).abs() / scale
    assert err.max().item() <= 1e-13, err.max().item()
    exact = dia_spmv(oo.offsets, oo.vals, x64)  # K1 in float64
    assert ((df.to_f64(*got) - exact).abs() / scale).max().item() <= 1e-13


def test_dia_spmv_df_kernel_on_the_7_point_laplacian(cuda):
    """K7 on the (hi, lo) split of the 48^3 7-point Laplacian (cg_df64's
    A p in the box-AMG df64 solve)."""
    A, _ = _box_amg(cuda, torch.float64, 48)
    oo = A.device().oo
    assert len(oo.offsets) == 7
    vh, vl = df.from_f64(oo.vals)
    g = torch.Generator().manual_seed(20)
    x64 = torch.randn(1, oo.n_cols_pad, generator=g, dtype=torch.float64).to(cuda)
    x = df.from_f64(x64)
    before = profiling.launches("dia_spmv_df")
    got = df.to_f64(*dia_spmv_df(oo.offsets, vh, vl, x))
    assert profiling.launches("dia_spmv_df") == before + 1
    want = df.to_f64(*df.dia_spmv_df_plain(oo.offsets, vh, vl, x))
    torch.cuda.synchronize()
    scale = dia_spmv(oo.offsets, oo.vals.abs(), x64.abs()) + 1e-30
    assert ((got - want).abs() / scale).max().item() <= 1e-13
    assert ((got - dia_spmv(oo.offsets, oo.vals, x64)).abs() / scale).max().item() <= 1e-13


def _elasticity(device, dtype, nodes=(6, 6, 6)):
    import numpy as np

    from partitionedarrays_tpu_torch.models import gallery
    from partitionedarrays_tpu_torch.psparse import psparse

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    I, J, V, rows, cols = gallery.linear_elasticity_fem(nodes, (1, 1, 1), dtype=np_dtype)
    return psparse(I, J, V, rows, cols, SerialBackend(1), device=device)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_spmv_kernel_at_99_diagonals(cuda, dtype):
    oo = _elasticity(cuda, dtype).device().oo
    assert oo.kind == "dia" and len(oo.offsets) == 99
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, oo.n_cols_pad, generator=g, dtype=dtype).to(cuda)
    before = profiling.launches("dia_spmv")
    got = dia_spmv(oo.offsets, oo.vals, x)
    assert profiling.launches("dia_spmv") == before + 1
    _assert_close(got, dia_spmv_plain(oo.offsets, oo.vals, x), dtype)


def _amg(device, dtype):
    """SA-AMG of 3-D elasticity at 8^3 nodes."""
    from partitionedarrays_tpu_torch.models import gallery
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner

    A = _elasticity(device, dtype, (8, 8, 8))
    coords, _ = gallery.node_coordinates_unit_cube((8, 8, 8), (1, 1, 1))
    return AMGPreconditioner(A, AMGParams(coarse_size=100, block_size=3),
                             nullspace=gallery.nullspace_linear_elasticity(coords))


def _one_part(G, device, dtype):
    """A one-part psparse matrix from a scipy matrix."""
    import numpy as np

    from partitionedarrays_tpu_torch.parallel.partition import variable_partition
    from partitionedarrays_tpu_torch.psparse import psparse

    G = G.tocoo()
    n = G.shape[0]
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return psparse([G.row], [G.col], [G.data.astype(np_dtype)], variable_partition([n]),
                   variable_partition([n]), SerialBackend(1), device=device)


def _banded(n, width, seed):
    """n rows, 9 entries per row within +-width, symmetrised, diagonally
    dominant."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 9)
    cols = np.clip(rows + rng.integers(-width, width + 1, size=rows.size), 0, n - 1)
    B = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n))
    return B + B.T + sp.diags(np.abs(B + B.T).sum(1).A1 + 1.0)


def _tile_smoothers(device, dtype):
    """The tile tier of an elasticity AMG level 1 (8^3 nodes), of a banded
    operator of 1,024 rows in 8 tiles, and of 384 rows whose 3 tiles all
    couple (waves of one tile: B = 1)."""
    return [_amg(device, dtype).levels[1].smoother.tile_gs,
            GaussSeidel(_one_part(_banded(1024, 100, 100), device, dtype)).tile_gs,
            GaussSeidel(_one_part(_banded(384, 300, 101), device, dtype)).tile_gs]


def _stacked(tgs):
    """The K6 operands of several one-part tile smoothers of as many tiles,
    stacked as parts: the off-tile lanes and rows padded to the largest
    (column -1, row -1), the waves to the most and the widest (-1)."""
    import torch.nn.functional as F

    Nr = max(tg.rows.shape[1] for tg in tgs)
    K = max(tg.cols.shape[1] for tg in tgs)
    W = max(tg.W for tg in tgs)
    B = max(tg.B for tg in tgs)

    def pad(t, *widths, value):
        return F.pad(t, [a for w in reversed(widths) for a in (0, w)], value=value)

    return dict(
        pack=torch.cat([tg.pack for tg in tgs]),
        rows=torch.cat([pad(tg.rows, 0, Nr - tg.rows.shape[1], value=-1) for tg in tgs]),
        cols=torch.cat([pad(tg.cols, 0, K - tg.cols.shape[1], Nr - tg.cols.shape[2], value=-1)
                        for tg in tgs]),
        vals=torch.cat([pad(tg.vals, 0, K - tg.vals.shape[1], Nr - tg.vals.shape[2], value=0)
                        for tg in tgs]),
        tile_ptr=torch.cat([tg.tile_ptr for tg in tgs]),
        wave_tiles=torch.cat([pad(tg.wave_tiles, 0, W - tg.W, B - tg.B, value=-1) for tg in tgs]),
        tile_lanes=torch.cat([tg.tile_lanes for tg in tgs]),
    )


def _operands(tg):
    return dict(pack=tg.pack, rows=tg.rows, cols=tg.cols, vals=tg.vals, tile_ptr=tg.tile_ptr,
                wave_tiles=tg.wave_tiles, tile_lanes=tg.tile_lanes)


DIR_SEQS = [("f",), ("b",), ("f", "b"), ("f", "b", "f", "b")]


def _hold_tile(ops, dtype, device, seed):
    """K6 against its plain version on the operands ``ops``: every order
    of ``DIR_SEQS`` from a zero and a nonzero guess, with x in shared
    memory and in L2, one launch per call."""
    from partitionedarrays_tpu_torch.ops.tile_gs import tile_gs_sweeps, tile_gs_sweeps_plain

    g = torch.Generator().manual_seed(seed)
    P, nt = ops["pack"].shape[0], ops["pack"].shape[2]
    b = torch.randn(P, nt * 128, generator=g, dtype=dtype).to(device)
    x0 = torch.randn(P, nt * 128, generator=g, dtype=dtype).to(device)
    args = [ops[k] for k in ("pack", "rows", "cols", "vals", "tile_ptr", "wave_tiles")]
    for dirs in DIR_SEQS:
        for zero in (True, False):
            start = torch.zeros_like(x0) if zero else x0
            want = tile_gs_sweeps_plain(*args, start.clone(), b, dirs, zero_guess=zero)
            for x_in_smem in (True, False):
                before = profiling.launches("tile_gs_sweeps")
                got = tile_gs_sweeps(*args, start.clone(), b, dirs, zero_guess=zero,
                                     tile_lanes=ops["tile_lanes"], _x_in_smem=x_in_smem)
                assert profiling.launches("tile_gs_sweeps") == before + 1  # one launch per sequence
                _assert_close(got, want, dtype)
            # without its lane counts the wrapper derives them
            got = tile_gs_sweeps(*args, start.clone(), b, dirs, zero_guess=zero)
            _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_gs_kernel_matches_plain(cuda, dtype):
    tgs = _tile_smoothers(cuda, dtype)
    assert tgs[2].B == 1 and tgs[1].B > 1
    for tg in tgs:
        _hold_tile(_operands(tg), dtype, cuda, 16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_gs_kernel_on_stacked_parts(cuda, dtype):
    """Two parts in one launch: banded operators of 8 tiles each, from two
    seeds (other off-tile lanes, waves and widths per part)."""
    tgs = [GaussSeidel(_one_part(_banded(1024, w, seed), cuda, dtype)).tile_gs
           for w, seed in ((100, 102), (250, 103))]
    assert (tgs[0].W, tgs[0].B) != (tgs[1].W, tgs[1].B)
    _hold_tile(_stacked(tgs), dtype, cuda, 17)


def test_tile_gs_refused_launch_raises(cuda):
    """A launch the card cannot take raises (no per-wave-step fallback),
    and the next launch runs: a wave of 9 tiles (a cluster beyond the
    portable 8 CTAs), and x forced into shared memory that it does not fit
    (240 tiles of float64: 240 KB)."""
    from partitionedarrays_tpu_torch.ops.tile_gs import tile_gs_sweeps, tile_gs_sweeps_plain

    def synthetic(nt, B, dtype):
        return dict(
            pack=torch.zeros(1, 2, nt, 128, 128, dtype=dtype, device=cuda),
            rows=torch.full((1, 8), -1, dtype=torch.int32, device=cuda),
            cols=torch.full((1, 1, 8), -1, dtype=torch.int32, device=cuda),
            vals=torch.zeros(1, 1, 8, dtype=dtype, device=cuda),
            tile_ptr=torch.zeros(1, nt + 1, dtype=torch.int32, device=cuda),
            wave_tiles=torch.arange(B, dtype=torch.int32, device=cuda).view(1, 1, B),
            tile_lanes=torch.zeros(1, nt, dtype=torch.int32, device=cuda),
        )

    for ops, x_in_smem in ((synthetic(9, 9, torch.float32), None),
                           (synthetic(240, 8, torch.float64), True)):
        x = torch.zeros(1, ops["pack"].shape[2] * 128, dtype=ops["pack"].dtype, device=cuda)
        args = [ops[k] for k in ("pack", "rows", "cols", "vals", "tile_ptr", "wave_tiles")]
        with pytest.raises(RuntimeError):
            tile_gs_sweeps(*args, x, x.clone(), ("f",), tile_lanes=ops["tile_lanes"],
                           _x_in_smem=x_in_smem)
    tg = _tile_smoothers(cuda, torch.float64)[1]
    b = torch.ones(1, tg.Rp, dtype=torch.float64, device=cuda)
    got = tile_gs_sweeps(*tg.operands(), torch.zeros_like(b), b, ("f", "b"), zero_guess=True,
                         tile_lanes=tg.tile_lanes)
    _assert_close(got, tile_gs_sweeps_plain(*tg.operands(), torch.zeros_like(b), b, ("f", "b")),
                  torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ghost_spmv_kernel_on_amg_blocks_every_g(cuda, dtype):
    """K5 on the compressed-row blocks of the 8^3 elasticity hierarchy (P
    and P^T of every level, the coarse operators), accumulating into y,
    under every warps-per-group count and the block's own plan."""
    from partitionedarrays_tpu_torch.ops.ell_rows import LANES_MAX

    M = _amg(cuda, dtype)
    blocks = []
    for l, lev in enumerate(M.levels):
        if lev.P is not None:
            blocks += [lev.P.device().oo, lev.P.device_transpose()[0]]
        if l > 0:
            blocks.append(lev.A.device().oo)
    blocks = [blk for blk in blocks if blk.kind == "ell"]
    assert len(blocks) >= 4
    g = torch.Generator().manual_seed(24)
    for blk in blocks:
        x = torch.randn(1, blk.n_cols_pad, generator=g, dtype=dtype).to(cuda)
        y0 = torch.randn(1, blk.n_rows, generator=g, dtype=dtype).to(cuda)
        want = ghost_spmv_plain(blk.rows, blk.cols, blk.vals, x, y0.clone())
        lanes = [1 << i for i in range(LANES_MAX.bit_length())]
        for plan in [blk.plan] + [blk.plan._replace(lanes=G) for G in lanes]:
            before = profiling.launches("ghost_spmv")
            got = ghost_spmv(blk.rows, blk.cols, blk.vals, x, y0.clone(), plan)
            assert profiling.launches("ghost_spmv") == before + 1
            _assert_close(got, want, dtype)


def _schwarz_ilu0(device, dtype):
    """The ILU(0) Schwarz smoothers of the 2-D FEM Laplacian on (4,1) parts
    (576 rows a part: W >= 3 for both factors, four clusters) and of the
    16^3 HPCG operator on one part (32 tiles, waves of one tile)."""
    import numpy as np

    from partitionedarrays_tpu_torch.models import gallery
    from partitionedarrays_tpu_torch.psparse import psparse
    from partitionedarrays_tpu_torch.solvers.smoothers import AdditiveSchwarz

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    A = psparse(*gallery.laplacian_fem((48, 48), (4, 1), dtype=np_dtype), SerialBackend(4),
                device=device)
    H, _ = build_hpcg_problem((16, 16, 16), (1, 1, 1), SerialBackend(1), dtype=dtype,
                              device=device, structured=False)
    return [AdditiveSchwarz(M, mode="ilu0") for M in (A, H)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_gs_kernel_triangular_solves(cuda, dtype):
    """K6 in one-direction mode (D = 1, the level schedule): the forward
    solve with L and the backward solve with U from a zero guess, one
    launch each, with x in shared memory and in L2, against the plain
    version; in float64 the two solves are also scipy's
    ``spsolve_triangular`` to 1e-10 of the largest entry."""
    import numpy as np
    from scipy.sparse.linalg import spsolve_triangular

    from partitionedarrays_tpu_torch.ops.native import ilu0
    from partitionedarrays_tpu_torch.ops.tile_gs import tile_gs_sweeps, tile_gs_sweeps_plain

    g = torch.Generator().manual_seed(18)
    for S in _schwarz_ilu0(cuda, dtype):
        assert S.sgsL.W >= 3 and S.sgsU.W >= 3
        P, n = S.sgsL.pack.shape[0], S.sgsL.Rp
        b = torch.randn(P, n, generator=g, dtype=dtype).to(cuda)
        for tg, d in ((S.sgsL, "f"), (S.sgsU, "b")):
            assert tg.pack.shape[1] == 1 and tg.directions == (d,)
            want = tile_gs_sweeps_plain(*tg.operands(), torch.zeros_like(b), b, (d,),
                                        zero_guess=True)
            for x_in_smem in (True, False):
                before = profiling.launches("tile_gs_sweeps")
                got = tile_gs_sweeps(*tg.operands(), torch.zeros_like(b), b, (d,),
                                     zero_guess=True, tile_lanes=tg.tile_lanes,
                                     _x_in_smem=x_in_smem)
                assert profiling.launches("tile_gs_sweeps") == before + 1
                _assert_close(got, want, dtype)
        if dtype != torch.float64:
            continue
        bo = b[:, : S.A.row_layout().n_own_pad]
        z = S.sgsU.sweeps(None, S.sgsL.sweeps(None, bo, ("f",)), ("b",)).cpu().numpy()
        for p, (blk, li) in enumerate(zip(S.A.blocks, S.A.row_prange.parts)):
            L, U = ilu0(blk["oo"])
            r = bo[p, : li.n_own].cpu().numpy()
            xe = spsolve_triangular(U.tocsr(), spsolve_triangular(L.tocsr(), r, lower=True),
                                    lower=False)
            assert np.abs(z[p, : li.n_own] - xe).max() < 1e-10 * max(np.abs(xe).max(), 1.0)


def _elasticity_parts(device, dtype, n):
    """SA-AMG of 3-D elasticity at n^3 nodes on (2,2,2) parts."""
    import numpy as np

    from partitionedarrays_tpu_torch.models import gallery
    from partitionedarrays_tpu_torch.psparse import psparse
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    I, J, V, rows, cols = gallery.linear_elasticity_fem((n, n, n), (2, 2, 2), dtype=np_dtype)
    A = psparse(I, J, V, rows, cols, SerialBackend(8), device=device)
    coords, _ = gallery.node_coordinates_unit_cube((n, n, n), (2, 2, 2))
    return AMGPreconditioner(A, AMGParams(coarse_size=30, block_size=3, max_levels=4),
                             nullspace=gallery.nullspace_linear_elasticity(coords, A.row_prange))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [7, 9])
def test_tile_gs_kernel_across_parts(cuda, dtype, n):
    """K6 with P = 8 clusters: the tile tier of the fine level of 3-D
    elasticity on (2,2,2) parts of unequal size (3 or 4 nodes per
    direction at 7^3, 4 or 5 at 9^3), so the parts' off-tile lanes and
    waves differ."""
    M = _elasticity_parts(cuda, dtype, n)
    tg = M.levels[0].smoother.tile_gs
    assert tg is not None and tg.wave_tiles.shape[0] == 8
    assert len({li.n_own for li in M.levels[0].A.row_prange.parts}) > 1
    _hold_tile(_operands(tg), dtype, cuda, 18)


def _with_an_empty_part(device, dtype):
    """30 rows on 3 parts: each row of parts 0 and 1 couples to two
    scattered rows of the other (an own-ghost block that is not banded),
    part 2 holds only its diagonal, so it has no ghost columns (its
    own-ghost block and that block's transpose are empty)."""
    import numpy as np

    from partitionedarrays_tpu_torch.parallel.partition import variable_partition
    from partitionedarrays_tpu_torch.psparse import psparse

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    I, J, V = [], [], []
    for p in range(3):
        r = np.arange(10 * p, 10 * p + 10)
        i, j = [r], [r]
        if p < 2:
            other = 10 * (1 - p)
            i += [r, r]
            j += [other + (3 * r) % 10, other + (7 * r + 2) % 10]
        I.append(np.concatenate(i))
        J.append(np.concatenate(j))
        V.append(np.linspace(1.0, 2.0, I[-1].size).astype(np_dtype))
    rows = variable_partition([10, 10, 10])
    return psparse(I, J, V, rows, rows, SerialBackend(3), assembled=True, device=device)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ghost_spmv_kernel_across_parts(cuda, dtype):
    """K5 on the own-ghost blocks and the own-ghost transposes (``spmtv``)
    across parts: of a matrix with a part that has no ghost columns, and of
    every level of the 7^3-node elasticity hierarchy on (2,2,2) parts
    (with P and P^T), into y, with the block's own plan."""
    A = _with_an_empty_part(cuda, dtype)
    assert A.col_prange.parts[2].n_ghost == 0 and A.col_prange.parts[0].n_ghost == 10
    blocks = [A.device().oh, A.device_transpose()[1]]
    M = _elasticity_parts(cuda, dtype, 7)
    for lev in M.levels:
        blocks.append(lev.A.device().oh)
        if lev.P is not None:
            blocks += [lev.P.device().oh, *lev.P.device_transpose()]
    blocks = [blk for blk in blocks if blk is not None and blk.kind == "ell"]
    assert len(blocks) >= 6
    g = torch.Generator().manual_seed(25)
    for blk in blocks:
        P = blk.vals.shape[0]
        x = torch.randn(P, blk.n_cols_pad, generator=g, dtype=dtype).to(cuda)
        y0 = torch.randn(P, blk.n_rows, generator=g, dtype=dtype).to(cuda)
        want = ghost_spmv_plain(blk.rows, blk.cols, blk.vals, x, y0.clone())
        before = profiling.launches("ghost_spmv")
        got = ghost_spmv(blk.rows, blk.cols, blk.vals, x, y0.clone(), blk.plan)
        assert profiling.launches("ghost_spmv") == before + 1
        _assert_close(got, want, dtype)


# -- the reuse tier: kernels on refreshed operands -----------------------------

def _box_updated(device, dtype):
    """The box AMG of the 7-point Laplacian at 12^3 on (2,2,2) parts, set
    up, refilled with a diagonal shift through the psparse cache and
    updated: every operand of its kernels refreshed."""
    import numpy as np

    from partitionedarrays_tpu_torch.models import gallery
    from partitionedarrays_tpu_torch.psparse import psparse, psparse_refill
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    I, J, V, rows, cols = gallery.laplacian_fdm((12, 12, 12), (2, 2, 2), dtype=np_dtype)
    A, cache = psparse(I, J, V, rows, cols, SerialBackend(8), assembled=True, reuse=True,
                       device=device)
    M = AMGPreconditioner(A, AMGParams(coarse_size=10))
    psparse_refill(A, [(v + (i == j) * (0.5 + (i % 7) / 7.0) * v).astype(np_dtype)
                       for i, j, v in zip(I, J, V)], cache)
    return A, M.update(A)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_on_refreshed_box_hierarchy(cuda, dtype):
    """After ``update``: K3 and K4 on every colored level's refreshed
    values (equal to a fresh smoother's), K1 on the refilled operator, K5
    on the refilled own-ghost blocks and their transposes."""
    A, M = _box_updated(cuda, dtype)
    g = torch.Generator().manual_seed(31)
    for l, lev in enumerate(M.levels[:-1]):
        col = lev.smoother.colored
        fresh = GaussSeidel(lev.A.copy()).colored
        assert torch.equal(col.vals_d, fresh.vals_d) and torch.equal(col.invd_d, fresh.invd_d)
        _hold_sweeps(col, dtype, cuda, 32 + l)
        x = torch.randn(col.vals_d.shape[0], col.m, col.Lq, generator=g, dtype=dtype).to(cuda)
        _assert_close(ax_core(col.vals_d, x, col.taps), ax_core_plain(col.vals_d, x, col.taps),
                      dtype)
    oo = A.device().oo
    x = torch.randn(oo.vals.shape[0], oo.n_cols_pad, generator=g, dtype=dtype).to(cuda)
    _assert_close(dia_spmv(oo.offsets, oo.vals, x), dia_spmv_plain(oo.offsets, oo.vals, x), dtype)
    blocks = [A.device().oh, *A.device_transpose()]
    blocks = [b for b in blocks if b is not None and b.kind == "ell"]
    assert blocks
    for blk in blocks:
        P = blk.vals.shape[0]
        x = torch.randn(P, blk.n_cols_pad, generator=g, dtype=dtype).to(cuda)
        y0 = torch.randn(P, blk.n_rows, generator=g, dtype=dtype).to(cuda)
        _assert_close(ghost_spmv(blk.rows, blk.cols, blk.vals, x, y0.clone(), blk.plan),
                      ghost_spmv_plain(blk.rows, blk.cols, blk.vals, x, y0.clone()), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_on_refreshed_tile_level(cuda, dtype):
    """3-D elasticity on (2,2,2) parts of unequal size, refilled with a
    mass-like shift and updated: K6 on the refreshed tile tier (equal to a
    fresh build's planes), K5 on the refilled P and P^T."""
    import numpy as np

    from partitionedarrays_tpu_torch.models import gallery
    from partitionedarrays_tpu_torch.psparse import psparse, psparse_refill
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
    from partitionedarrays_tpu_torch.solvers.gs_slot import NaturalTileGS

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    I, J, V, rows, cols = gallery.linear_elasticity_fem((7, 7, 7), (2, 2, 2), dtype=np_dtype)
    A, cache = psparse(I, J, V, rows, cols, SerialBackend(8), reuse=True, device=cuda)
    coords, _ = gallery.node_coordinates_unit_cube((7, 7, 7), (2, 2, 2))
    M = AMGPreconditioner(A, AMGParams(coarse_size=30, block_size=3, max_levels=4),
                          nullspace=gallery.nullspace_linear_elasticity(coords, A.row_prange))
    psparse_refill(A, [(v + 0.1 * (i == j)).astype(np_dtype) for i, j, v in zip(I, J, V)], cache)
    M.update(A)
    tg = M.levels[0].smoother.tile_gs
    fresh = NaturalTileGS.build(A.copy())
    assert torch.equal(tg.pack, fresh.pack) and torch.equal(tg.vals, fresh.vals)
    _hold_tile(_operands(tg), dtype, cuda, 33)
    g = torch.Generator().manual_seed(34)
    lev = M.levels[0]
    for blk in (lev.P.device().oo, *lev.P.device_transpose()):
        if blk is None or blk.kind != "ell":
            continue
        P = blk.vals.shape[0]
        x = torch.randn(P, blk.n_cols_pad, generator=g, dtype=dtype).to(cuda)
        y0 = torch.randn(P, blk.n_rows, generator=g, dtype=dtype).to(cuda)
        _assert_close(ghost_spmv(blk.rows, blk.cols, blk.vals, x, y0.clone(), blk.plan),
                      ghost_spmv_plain(blk.rows, blk.cols, blk.vals, x, y0.clone()), dtype)


@pytest.mark.parametrize("case", ["dia", "ell"])
def test_device_refill_on_the_card(cuda, case):
    """``DeviceRefill`` on CUDA tensors: each slot summed in the host
    refill's order by unique-index scatters, so it equals the host refill
    and refreeze bit for bit, duplicates included (disassembled
    elasticity)."""
    import numpy as np

    from partitionedarrays_tpu_torch.models import gallery
    from partitionedarrays_tpu_torch.psparse import device_refill_plan, psparse, psparse_refill

    if case == "dia":
        I, J, V, rows, cols = gallery.laplacian_fdm((12, 12, 12), (2, 2, 2))
        A, cache = psparse(I, J, V, rows, cols, SerialBackend(8), assembled=True, reuse=True,
                           device=cuda)
    else:
        I, J, V, rows, cols = gallery.linear_elasticity_fem((7, 7, 7), (2, 2, 2))
        A, cache = psparse(I, J, V, rows, cols, SerialBackend(8), reuse=True, device=cuda)
    plan = device_refill_plan(A, cache)
    rng = np.random.default_rng(6)
    V2 = [rng.standard_normal(v.size) for v in V]
    dev = plan(plan.stack_values(V2))
    psparse_refill(A, V2, cache)
    for name in ("oo", "oh"):
        assert torch.equal(getattr(dev, name).vals, getattr(A.device(), name).vals)


# -- narrow values: (values dtype, vector dtype) -----------------------------

NARROW = [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.float64),
          (torch.float32, torch.float64), (torch.float16, torch.float32),
          (torch.float16, torch.float64)]
NARROW_IDS = ["bf16-f32", "bf16-f64", "f32-f64", "f16-f32", "f16-f64"]


def _random_colored(device, pair, shape, parts, seed):
    """The HPCG stencil's pattern with random values (off-diagonals in
    [-1, -0.5], the diagonal in [26, 39]), stored narrow."""
    values, dtype = pair
    P = parts[0] * parts[1] * parts[2]
    A, _ = build_hpcg_problem(shape, parts, SerialBackend(P), dtype=dtype, device=device)
    oo = A.device().oo
    g = torch.Generator().manual_seed(seed)
    scale = (0.5 + 0.5 * torch.rand(oo.vals.shape, generator=g, dtype=dtype)).to(device)
    k0 = oo.offsets.index(0)
    scale[:, k0] += 0.5
    vals = oo.vals * scale
    return ColoredDIAGS.from_device(oo.offsets, vals, vals[:, k0].contiguous(), values)


@pytest.mark.parametrize("pair", NARROW, ids=NARROW_IDS)
def test_narrow_values_kernels_match_plain(cuda, pair):
    """K4 (under every lane count) and K3 (every order, from a guess and a
    zero guess) on the 32^3 pattern; K2 on every color, K3 under every
    lane count, with one CTA per part and with many, and K4 under every
    lane count on (2,2,2) parts of 16^3."""
    values, dtype = pair
    col = _random_colored(cuda, pair, (32, 32, 32), (1, 1, 1), 31)
    assert col.vals_d.dtype == values and col.invd_d.dtype == dtype
    g = torch.Generator().manual_seed(32)
    _hold_ax(col, dtype, cuda, 32, [None] + AX_PLANS)
    _hold_sweeps(col, dtype, cuda, 33)
    col = _random_colored(cuda, pair, (16, 16, 16), (2, 2, 2), 34)
    _hold_ax(col, dtype, cuda, 39, [None] + AX_PLANS)
    core = torch.randn(8, col.m * col.Lq, generator=g, dtype=dtype).to(cuda)
    for c in range(col.m):
        before = profiling.launches("dia_spmv_strided")
        got = dia_spmv_strided(col.taps.host[c], col.vals_d[:, c], core)
        assert profiling.launches("dia_spmv_strided") == before + 1 and got.dtype == dtype
        _assert_close(got, dia_spmv_plain(col.taps.host[c], col.vals_d[:, c], core), dtype)
    plans = [SweepPlan(lanes, width) for lanes in (1, 2, 4, 8, 16) for width in (1, 64)]
    _hold_sweeps(col, dtype, cuda, 35, plans)


@pytest.mark.parametrize("pair", NARROW, ids=NARROW_IDS)
def test_narrow_values_refuse_what_the_engine_cannot_read(cuda, pair):
    """Values (or K4's x) that start one element into their storage are
    not a whole load: K2, K3 and K4 raise before any launch."""
    values, dtype = pair
    col = _random_colored(cuda, pair, (16, 16, 16), (2, 2, 2), 36)
    bd = torch.zeros(8, col.m, col.Lq, dtype=dtype, device=cuda)
    launches = profiling.launches("dia_spmv_strided"), profiling.launches("gs_sweeps"), profiling.launches("ax_core")
    core = torch.zeros(8, col.m * col.Lq, dtype=dtype, device=cuda)
    with pytest.raises(ValueError):
        dia_spmv_strided(col.taps.host[1], _misaligned(col.vals_d[:, 1]), core)
    with pytest.raises(ValueError):
        gs_sweeps(_misaligned(col.vals_d), bd, col.invd_d, None, col.taps, (0,))
    with pytest.raises(ValueError):
        ax_core(_misaligned(col.vals_d), bd, col.taps)
    with pytest.raises(ValueError):
        ax_core(col.vals_d, _misaligned(bd), col.taps)
    assert (profiling.launches("dia_spmv_strided"), profiling.launches("gs_sweeps"), profiling.launches("ax_core")) == launches


@pytest.mark.parametrize("pair", NARROW, ids=NARROW_IDS)
def test_narrow_values_on_hpcg_equal_full_values(cuda, pair):
    """HPCG's 26 and -1 are exact in bfloat16 and float16: under the same plan the
    narrow-value kernels give the full-value kernels' results bit for bit
    (one level of 32^3 and one of (2,2,2) x 16^3)."""
    values, dtype = pair
    for shape, parts in (((32, 32, 32), (1, 1, 1)), ((16, 16, 16), (2, 2, 2))):
        P = parts[0] * parts[1] * parts[2]
        A, b = build_hpcg_problem(shape, parts, SerialBackend(P), dtype=dtype, device=cuda)
        full, narrow = GaussSeidel(A), GaussSeidel(A, values_dtype=values)
        assert narrow.colored.vals_d.dtype == values
        assert torch.equal(narrow.colored.vals_d.to(dtype), full.colored.vals_d)
        bd = full.make_bd(b)
        order = full._order_seq()
        g = torch.Generator().manual_seed(37)
        x = torch.randn(P, full.colored.m, full.colored.Lq, generator=g, dtype=dtype).to(cuda)

        def outputs(gs):  # K4, K3 from a zero guess and from x, K2 per color
            col = gs.colored
            return (gs.flat_ax(x), gs.smooth_bd(None, bd), gs.smooth_bd(x, bd),
                    col.sweep_flat(x.clone(), bd, col.vals_d, col.invd_d, order))

        for got, want in zip(outputs(narrow), outputs(full)):
            assert torch.equal(got, want)
        for plan in AX_PLANS:  # K4 under every lane count
            assert torch.equal(ax_core(narrow.colored.vals_d, x, full.colored.taps, _plan=plan),
                               ax_core(full.colored.vals_d, x, full.colored.taps, _plan=plan))


def test_unsupported_value_pairs_raise(cuda):
    """float64 values under float32 vectors have no kernel: TypeError,
    naming the pairs there are."""
    col = _random_colored(cuda, (torch.float32, torch.float32), (16, 16, 16), (1, 1, 1), 38)
    x = torch.zeros(1, col.m, col.Lq, device=cuda)
    vals = col.vals_d.double()
    with pytest.raises(TypeError, match="bf16 values with f32 vectors"):
        ax_core(vals, x, col.taps)
    with pytest.raises(TypeError, match="supported pairs"):
        gs_sweeps(vals, x, col.invd_d, None, col.taps, (0,))
    with pytest.raises(TypeError, match="supported pairs"):
        dia_spmv_strided(col.taps.host[0], vals[:, 0], x.view(1, -1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_on_unequal_part_boxes(cuda, dtype):
    """K1 and K3 (every order and lane count) on the own-own block of the
    17^3 Laplacian on (2,2,2) parts of 8 or 9 nodes per axis: the union of
    the parts' offsets (13), each part's zero diagonals, padding rows of
    the smaller parts (zero values, zero inverse diagonal); x and the
    swept core keep zero padding."""
    from partitionedarrays_tpu_torch.models.gallery import plaplacian_fdm

    A = plaplacian_fdm((17, 17, 17), (2, 2, 2), SerialBackend(8),
                       dtype={torch.float32: "float32", torch.float64: "float64"}[dtype],
                       device=cuda)
    oo = A.device().oo
    assert len(oo.offsets) == 13 and len({li.n_own for li in A.row_prange.parts}) == 4
    g = torch.Generator().manual_seed(41)
    x = torch.randn(8, oo.n_cols_pad, generator=g, dtype=dtype).to(cuda)
    before = profiling.launches("dia_spmv")
    got = dia_spmv(oo.offsets, oo.vals, x)
    assert profiling.launches("dia_spmv") == before + 1
    _assert_close(got, dia_spmv_plain(oo.offsets, oo.vals, x), dtype)
    col = GaussSeidel(A).colored
    assert col.m == 5 and not col.interleave_core(col.invd_d)[0, 512:].any()
    _hold_sweeps(col, dtype, cuda, 42, [None] + [SweepPlan(lanes, 1) for lanes in (1, 2, 4, 8, 16)])


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_cg_on_the_card_runs_k1_and_k5(cuda, dtype):
    """``b_cg`` on the coupled two-field system [[A, C], [C, S]] at 8^3 on
    (2,2,2) parts (A the 7-point Laplacian, S = A + 0.5 I, C = 0.1 I):
    each block product is the block's own ``spmv``, K1 on the DIA blocks
    and K5 on the ghost blocks, and the card takes the CPU's iterations to
    the CPU's solution (rtol 1e-5 in float32, 1e-12 in float64)."""
    import numpy as np

    from partitionedarrays_tpu_torch.block_arrays import BMatrix, BVector, b_cg, b_collect
    from partitionedarrays_tpu_torch.models.gallery import plaplacian_fdm
    from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv
    from partitionedarrays_tpu_torch.ops.stencil import stencil_psparse
    from partitionedarrays_tpu_torch.psparse import sparse_diag_matrix
    from partitionedarrays_tpu_torch.pvector import pfill, pvector_from_own

    npdtype = np.float32 if dtype == torch.float32 else np.float64
    out = {}
    for device in ("cpu", cuda):
        A = plaplacian_fdm((8, 8, 8), (2, 2, 2), SerialBackend(8), dtype=npdtype, device=device)
        stencil = [((0, 0, 0), 6 * 729.0 + 0.5)] + [
            (tuple(s if k == d else 0 for k in range(3)), -729.0) for d in range(3)
            for s in (-1, 1)]
        S = stencil_psparse((2, 2, 2), (8, 8, 8), stencil, A.backend, dtype=npdtype,
                            device=device)
        C = sparse_diag_matrix(pfill(0.1, A.row_prange, A.backend, npdtype, device=device))
        rng = np.random.default_rng(8)
        own = [[rng.standard_normal(li.n_own).astype(npdtype) for li in A.row_prange.parts]
               for _ in range(2)]
        b = BVector([pvector_from_own(o, A.row_prange, A.backend, device=device) for o in own])
        before = profiling.launches("dia_spmv"), profiling.launches("ghost_spmv")
        x, iters, relres = b_cg(BMatrix([[A, C], [C, S]]), b, rtol=1e-8)
        launched = profiling.launches("dia_spmv") - before[0], profiling.launches("ghost_spmv") - before[1]
        out[str(device)] = (b_collect(x), iters, launched)
    (x_cpu, it_cpu, _), (x_gpu, it_gpu, (k1, k5)) = out["cpu"], out[str(cuda)]
    assert it_gpu == it_cpu > 10 and (k1, k5) == (4 * it_gpu, 2 * it_gpu)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert np.abs(x_gpu - x_cpu).max() <= tol * np.abs(x_cpu).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_products_tangents_are_the_kernels(cuda, dtype):
    """Forward-mode AD through ``DeviceBlock.spmv``/``spmv_add`` on the
    card: the tangent of K1 (the own-own DIA block) and of K5 (the
    own-ghost block) of the (2,2,2) x 16^3 HPCG operator is the same
    kernel launched on the tangent (one launch for the primal, one for the
    tangent), held against the plain product of the tangent."""
    import torch.autograd.forward_ad as fwAD

    A, _ = build_hpcg_problem((16, 16, 16), (2, 2, 2), SerialBackend(8), dtype=dtype,
                              device=cuda)
    dev = A.device()
    g = torch.Generator().manual_seed(21)
    for block, entry in ((dev.oo, "dia_spmv"), (dev.oh, "ghost_spmv")):
        P = block.vals.shape[0]
        x = torch.randn(P, block.n_cols_pad, generator=g, dtype=dtype).to(cuda)
        v = torch.randn(P, block.n_cols_pad, generator=g, dtype=dtype).to(cuda)
        y = torch.randn(P, block.n_rows, generator=g, dtype=dtype).to(cuda)
        w = torch.randn(P, block.n_rows, generator=g, dtype=dtype).to(cuda)
        before = profiling.launches(entry)
        with fwAD.dual_level():
            t1 = fwAD.unpack_dual(block.spmv(fwAD.make_dual(x, v))).tangent
            out = block.spmv_add(fwAD.make_dual(x, v), fwAD.make_dual(y.clone(), w.clone()))
            p2, t2 = fwAD.unpack_dual(out)
        assert profiling.launches(entry) == before + 4
        if block.kind == "dia":
            plain = dia_spmv_plain(block.offsets, block.vals, v)
        else:
            plain = ghost_spmv_plain(block.rows, block.cols, block.vals, v,
                                     v.new_zeros((P, block.n_rows)))
        _assert_close(t1, plain, dtype)
        _assert_close(t2, w + plain, dtype)
        _assert_close(p2, y + block.spmv(x), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_newton_krylov_on_the_card_matches_the_cpu(cuda, dtype):
    """``newton_krylov`` on the card, both products, with a Gauss-Seidel
    preconditioner, on the reference's test problem at 12^3 on (2,2,2):
    the CPU's outer iterations and x within 1e-5 (float32) / 1e-10."""
    import numpy as np

    from partitionedarrays_tpu_torch.models.gallery import plaplacian_fdm
    from partitionedarrays_tpu_torch.psparse import spmv
    from partitionedarrays_tpu_torch.pvector import PVector, collect, pvector_from_own
    from partitionedarrays_tpu_torch.solvers.nonlinear import newton_krylov

    npdtype = np.float32 if dtype == torch.float32 else np.float64
    for jvp, rtol in (("auto", 1e-6 if dtype == torch.float32 else 1e-10), ("fd", 1e-4)):
        out = {}
        for device in ("cpu", cuda):
            A = plaplacian_fdm((12, 12, 12), (2, 2, 2), SerialBackend(8), dtype=npdtype,
                               device=device)
            pr = A.row_prange
            rng = np.random.default_rng(0)
            xs = pvector_from_own([(0.3 * rng.standard_normal(li.n_own)).astype(npdtype)
                                   for li in pr.parts], pr, A.backend, device=device)
            b = spmv(A, xs).own + xs.own ** 3

            def residual(x, A=A, b=b):
                ax = spmv(A, x)
                return PVector(ax.own + x.own ** 3 - b, torch.zeros_like(ax.ghost), ax.layout,
                               ax.backend)

            x, iters, rn = newton_krylov(residual, xs * 0.0, M=GaussSeidel(A, 1, "symmetric"),
                                         rtol=rtol, inner_rtol=1e-4, inner_maxiter=300, jvp=jvp)
            out[str(device)] = (collect(x), int(iters))
        (x_cpu, it_cpu), (x_gpu, it_gpu) = out["cpu"], out[str(cuda)]
        assert it_gpu == it_cpu
        tol = 1e-5 if dtype == torch.float32 else (1e-10 if jvp == "auto" else 1e-6)
        assert np.abs(x_gpu - x_cpu).max() <= tol * np.abs(x_cpu).max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["elasticity", "ghosted"])
def test_sorted_tier_sweep_matches_plain(cuda, dtype, case):
    """Every color step of the sorted tier launches K5 (two with ghost
    columns); the sweep agrees with the plain tier-2 sweep on the card."""
    import numpy as np

    from partitionedarrays_tpu_torch.models.gallery import linear_elasticity_fem
    from partitionedarrays_tpu_torch.psparse import psparse
    from partitionedarrays_tpu_torch.pvector import PVector, _own_mask

    if case == "elasticity":
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        A = psparse(*linear_elasticity_fem((8, 8, 8), (1, 1, 1), dtype=np_dtype),
                    SerialBackend(1), device=cuda)
    else:
        A, _ = build_hpcg_problem((8, 8, 8), (2, 2, 2), SerialBackend(8), dtype=dtype,
                                  device=cuda)
    gs = GaussSeidel(A, 1, "symmetric", _sorted=True)
    lay = A.row_layout()
    g = torch.Generator().manual_seed(3)
    own = torch.randn(lay.n_parts, lay.n_own_pad, generator=g, dtype=dtype).to(cuda)
    b = PVector(torch.where(_own_mask(lay, cuda), own, 0),
                torch.zeros((lay.n_parts, lay.n_ghost_pad), dtype=dtype, device=cuda), lay,
                A.backend)
    before = profiling.launches("ghost_spmv")
    got = gs(b).own
    per_color = sum(1 for oo, oh in gs.sorted.blocks if oo is not None) + sum(
        1 for oo, oh in gs.sorted.blocks if oh is not None)
    assert profiling.launches("ghost_spmv") - before == 2 * per_color
    zero = PVector(torch.zeros_like(b.own), b.ghost, lay, A.backend)
    _assert_close(got, gs._apply_sorted(zero, b, plain=True).own, dtype)
