"""The ghost coupling in the core layout on the card:

- K5's subtracting entries (``pat_ghost_spmv_sub_*``) on the HPCG own-ghost
  block of (2,2,2) parts of 16^3 and on the compressed-row blocks of the 8^3
  elasticity AMG, under 1, 8 and 32 warps a row group: bit for bit the
  adding entries on the negated values, and within rounding of the plain
  version's subtraction;
- ``GaussSeidel.ghost_couple_core`` at every level of the (2,2,2)x32^3 MG,
  and a whole 50-iteration ``hpcg_cg_flat_g`` set there, bit for bit the
  standard-order composition (``tests/torch_ghost_core_cases.py``);
- the box AMG on (2,2,2) parts of 18^3: V- and W-cycles from every level,
  and the preconditioner's call (captured, then replayed from its CUDA
  graph), bit for bit the standard-order ghosted flat cycle.

Every test is marked ``gpu`` and skips without a CUDA card (decided in the
fixture).  This module imports torch and the port only (no JAX):

    python -m pytest --noconftest -p no:randomly tests/test_torch_ghost_core_gpu.py -q
"""
import pytest
import torch

import torch_ghost_core_cases as cases
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat_g
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.ops.ghost_spmv import ghost_spmv, ghost_spmv_plain
from partitionedarrays_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _blocks(device, dtype):
    """The HPCG own-ghost block and the AMG's compressed-row blocks."""
    from partitionedarrays_tpu_torch.models import gallery
    from partitionedarrays_tpu_torch.psparse import psparse
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner

    A, _ = build_hpcg_problem((16, 16, 16), (2, 2, 2), SerialBackend(8), dtype=dtype,
                              device=device)
    blocks = [A.device().oh]
    np_dtype = cases.NP_DTYPE[dtype]
    E = psparse(*gallery.linear_elasticity_fem((8, 8, 8), (1, 1, 1), dtype=np_dtype),
                SerialBackend(1), device=device)
    coords, _ = gallery.node_coordinates_unit_cube((8, 8, 8), (1, 1, 1))
    M = AMGPreconditioner(E, AMGParams(coarse_size=100, block_size=3),
                          nullspace=gallery.nullspace_linear_elasticity(coords))
    for lev in M.levels:
        if lev.P is not None:
            blocks += [lev.P.device().oo, lev.P.device_transpose()[0]]
    return [blk for blk in blocks if blk.kind == "ell"]


@pytest.mark.parametrize("G", [1, 8, 32])
@pytest.mark.parametrize("dtype", cases.DTYPES)
def test_sub_entries_equal_add_entries_on_negated_values(cuda, dtype, G):
    blocks = _blocks(cuda, dtype)
    assert len(blocks) >= 3
    g = torch.Generator().manual_seed(G)
    for blk in blocks:
        P = blk.rows.shape[0]
        x = torch.randn(P, blk.n_cols_pad, generator=g, dtype=dtype).to(cuda)
        y0 = torch.randn(P, blk.n_rows, generator=g, dtype=dtype).to(cuda)
        plan = blk.plan._replace(lanes=G)
        before = profiling.launches("ghost_spmv")
        got = ghost_spmv(blk.rows, blk.cols, blk.vals, x, y0.clone(), plan, subtract=True)
        assert profiling.launches("ghost_spmv") == before + 1
        neg = ghost_spmv(blk.rows, blk.cols, -blk.vals, x, y0.clone(), plan)
        torch.cuda.synchronize()
        assert torch.equal(got, neg)
        want = ghost_spmv_plain(blk.rows, blk.cols, blk.vals, x, y0.clone(), subtract=True)
        err = (got - want).abs().max().item()
        assert err <= RTOL[dtype] * want.abs().max().item(), err
        # b - s in one rounding: as b minus the product on a zero output
        zero = ghost_spmv(blk.rows, blk.cols, blk.vals, x, torch.zeros_like(y0), plan)
        assert torch.equal(got, y0 - zero)


@pytest.mark.parametrize("dtype", cases.DTYPES)
def test_couple_core_on_the_card_every_level(cuda, dtype):
    mg = cases.build_mg(32, (2, 2, 2), dtype, device=cuda)
    g = torch.Generator().manual_seed(5)
    for l, gs in enumerate(mg.gss):
        col = gs.colored
        lay = gs.A.row_layout()
        x = gs.flat_deinterleave(
            torch.randn(lay.n_parts, lay.n_own_pad, generator=g, dtype=dtype).to(cuda))
        y = torch.randn(lay.n_parts, col.m, col.Lq, generator=g, dtype=dtype).to(cuda)
        for subtract in (False, True):
            want = cases.std_couple(gs, x, y, subtract)
            got = gs.ghost_couple_core(x, y.clone(), subtract=subtract)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (l, subtract)


@pytest.mark.parametrize("dtype", cases.DTYPES)
def test_set_on_the_card_equals_std_composition(cuda, dtype):
    mg = cases.build_mg(32, (2, 2, 2), dtype, device=cuda)
    x_want, n_want = cases.std_cg(mg, mg.b, 50)
    x, norms = hpcg_cg_flat_g(mg, mg.b, iterations=50)
    torch.cuda.synchronize()
    assert torch.equal(norms, n_want)
    assert torch.equal(x.own, x_want)
    assert float(norms[-1] / norms[0]) < 1e-4


@pytest.mark.parametrize("w", [False, True], ids=["v", "w"])
@pytest.mark.parametrize("dtype", cases.DTYPES)
def test_amg_box_on_parts_on_the_card_equals_std_composition(cuda, dtype, w):
    A, M = cases.build_amg_box((2, 2, 2), dtype, device=cuda)
    for l in range(len(M.levels) - 1):
        b = cases.amg_rhs(M.levels[l].A, 60 + l)
        want = cases.std_amg_cycle(M, l, b, w)
        got = M._cycle(l, b, w)
        torch.cuda.synchronize()
        assert torch.equal(got.own, want.own), l
    if not w:  # capture, then replay
        b = cases.amg_rhs(A, 70)
        want = cases.std_amg_cycle(M, 0, b, False)
        for _ in range(2):
            got = M(b)
            torch.cuda.synchronize()
            assert torch.equal(got.own, want.own)
