"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 ``dia_spmv``, K4 ``ax_core`` and K3 ``gs_sweeps`` run on CUDA tensors of
the 32^3 HPCG operator and are compared with their plain versions on the
same tensors.  Tolerance: rtol 1e-5 in float32 and 1e-12 in float64,
relative to the largest plain entry, since only FMA contraction and the
order of the sums differ.

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
from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv
from partitionedarrays_tpu_torch.ops.gs_dia_kernels import (
    ax_core,
    ax_core_plain,
    gs_sweeps,
    gs_sweeps_plain,
)
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.float64]
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


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
    before = dia_spmv.launches
    got = dia_spmv(oo.offsets, oo.vals, x)
    assert dia_spmv.launches == before + 1
    _assert_close(got, dia_spmv_plain(oo.offsets, oo.vals, x), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ax_core_kernel_matches_plain(cuda, dtype):
    _, _, gs = _operator(cuda, dtype)
    col = gs.colored
    g = torch.Generator().manual_seed(14)
    x = torch.randn(1, col.m, col.Lq, generator=g, dtype=dtype).to(cuda)
    before = ax_core.launches
    got = ax_core(col.vals_d, x, col.taps)
    assert ax_core.launches == before + 1
    _assert_close(got, ax_core_plain(col.vals_d, x, col.taps), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gs_sweeps_kernel_matches_plain(cuda, dtype):
    _, b, gs = _operator(cuda, dtype)
    col = gs.colored
    g = torch.Generator().manual_seed(15)
    x = torch.randn(1, col.m, col.Lq, generator=g, dtype=dtype).to(cuda)
    bd = gs.make_bd(b)
    order = gs._order_seq()
    before = gs_sweeps.launches
    got = gs_sweeps(col.vals_d, bd, col.invd_d, x, col.taps, order)
    assert gs_sweeps.launches == before + len(order)  # one launch per color step
    _assert_close(got, gs_sweeps_plain(col.vals_d, bd, col.invd_d, x, col.taps, order), dtype)


def test_cuda_tensor_of_another_dtype_raises(cuda):
    _, _, gs = _operator(cuda, torch.float64)
    col = gs.colored
    x = torch.zeros(1, col.m, col.Lq, dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        ax_core(col.vals_d, x, col.taps)
