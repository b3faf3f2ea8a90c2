"""K1 (standard-order DIA SpMV) of the PyTorch port against the JAX
reference.

The same inputs, made with numpy from a seed, go through
``partitionedarrays_tpu`` (JAX on the CPU, Pallas off) and through
``partitionedarrays_tpu_torch`` (the plain PyTorch version on the CPU).
Tolerances: float64 rtol 1e-10, since only the summation order may differ;
float32 rtol 1e-4 for single outputs.  Entries can cancel to near zero, so
the absolute tolerance is rtol times the largest reference entry.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem as jax_build
from partitionedarrays_tpu.ops.dia import csr_diagonals as jax_csr_diagonals
from partitionedarrays_tpu.ops.dia import dia_spmv as jax_dia_spmv
from partitionedarrays_tpu.ops.dia import stack_dia as jax_stack_dia
from partitionedarrays_tpu.psparse import spmv as jax_spmv
from partitionedarrays_tpu.pvector import PVector as JaxPVector

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.ops.dia import csr_diagonals, dia_spmv_plain, stack_dia
from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv
from partitionedarrays_tpu_torch.psparse import spmv
from partitionedarrays_tpu_torch.pvector import PVector

torch.set_num_threads(1)

RTOL = {np.float32: 1e-4, np.float64: 1e-10}


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    yield
    jax_config.use_pallas = saved


def _close(got, ref, dtype):
    ref = np.asarray(ref)
    rtol = RTOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _random_dia(seed, dtype, P=1, R=300, n_cols=320, n_off=7):
    rng = np.random.default_rng(seed)
    offsets = tuple(sorted(rng.choice(np.arange(-60, 61), n_off, replace=False).tolist()))
    vals = rng.standard_normal((P, n_off, R)).astype(dtype)
    x = rng.standard_normal((P, n_cols)).astype(dtype)
    return offsets, vals, x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1])
def test_dia_spmv_plain_matches_jax(dtype, seed):
    offsets, vals, x = _random_dia(seed, dtype, P=2)
    got = dia_spmv_plain(offsets, torch.from_numpy(vals), torch.from_numpy(x)).numpy()
    for p in range(vals.shape[0]):
        ref = jax_dia_spmv(offsets, jnp.asarray(vals[p]), jnp.asarray(x[p]), x.shape[1])
        _close(got[p], ref, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stack_dia_matches_jax(dtype):
    """Host DIA packing of per-part banded blocks: the same offsets and the
    same values as the reference's (exactly), and the packed values times x
    through the plain K1 equal the blocks' own product."""
    rng = np.random.default_rng(6)
    R, n_rows_pad = 50, 56
    blocks = [
        sp.random(R, R, density=0.1, random_state=rng, dtype=dtype, format="csr")
        .multiply(sp.diags([1] * 7, [-9, -4, -1, 0, 2, 5, 11], shape=(R, R), dtype=dtype))
        .tocsr()
        for _ in range(2)
    ]
    offsets = np.unique(np.concatenate([csr_diagonals(b) for b in blocks]))
    ref_offsets = np.unique(np.concatenate([jax_csr_diagonals(b) for b in blocks]))
    np.testing.assert_array_equal(offsets, ref_offsets)
    vals = stack_dia(blocks, n_rows_pad, offsets)
    np.testing.assert_array_equal(vals, jax_stack_dia(blocks, n_rows_pad, ref_offsets))
    x = rng.standard_normal((2, R)).astype(dtype)
    y = dia_spmv_plain(tuple(offsets.tolist()), torch.from_numpy(vals), torch.from_numpy(x))
    for p, b in enumerate(blocks):
        _close(y[p, :R].numpy(), b @ x[p], dtype)
    assert not y[:, R:].any()


def test_dia_spmv_wrapper_runs_the_plain_version_on_cpu():
    offsets, vals, x = _random_dia(2, np.float64)
    before = dia_spmv.launches
    got = dia_spmv(offsets, torch.from_numpy(vals), torch.from_numpy(x))
    ref = dia_spmv_plain(offsets, torch.from_numpy(vals), torch.from_numpy(x))
    assert torch.equal(got, ref)
    assert dia_spmv.launches == before  # no kernel launch for CPU tensors


def test_dia_spmv_wrapper_refuses_mixed_dtypes():
    offsets, vals, x = _random_dia(3, np.float64)
    with pytest.raises(TypeError):
        dia_spmv(offsets, torch.from_numpy(vals), torch.from_numpy(x.astype(np.float32)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_matches_jax_on_hpcg_operator(dtype):
    A_ref, _ = jax_build((16, 16, 16), (1, 1, 1), JaxSerialBackend(1), dtype=dtype)
    A, _ = build_hpcg_problem((16, 16, 16), (1, 1, 1), SerialBackend(1), dtype=dtype, device="cpu")
    lay = A.col_layout()
    rng = np.random.default_rng(4)
    x = np.zeros((1, lay.n_own_pad), dtype=dtype)
    x[0, : lay.n_own[0]] = rng.standard_normal(lay.n_own[0])
    clay_ref = A_ref.col_layout()
    xv_ref = JaxPVector(
        jnp.asarray(x), jnp.zeros((1, clay_ref.n_ghost_pad), dtype), clay_ref, A_ref.backend
    )
    ref = np.asarray(jax_spmv(A_ref, xv_ref).own)
    xt = torch.from_numpy(x)
    xv = PVector(xt, xt.new_zeros((1, lay.n_ghost_pad)), lay, A.backend)
    got = spmv(A, xv).own.numpy()
    _close(got, ref, dtype)


def test_dia_spmv_wrapper_runs_no_plain_version_off_the_cpu():
    """Only CPU tensors go to the plain version; others need a kernel."""
    offsets, vals, x = _random_dia(5, np.float32)
    with pytest.raises(ValueError, match="no kernel"):
        dia_spmv(offsets, torch.from_numpy(vals).to("meta"), torch.from_numpy(x).to("meta"))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fallback."""
    from partitionedarrays_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
