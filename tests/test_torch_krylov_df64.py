"""``cg_df64`` of the PyTorch port against the JAX reference, with no
preconditioner, a float32 ``JacobiCorrection`` and a float32
``GaussSeidel``, on the HPCG 27-point
operator on one part of 8^3 and on (2,2,2) parts of 4^3.

Both packages build the exact float64 operator in closed form (the
reference with ``host_only=True``) and split it into (hi, lo) pairs; the
float32 preconditioner is built from the float32 operator; right-hand
sides are made with numpy from a seed.  The reference runs as JAX on the
CPU with Pallas off.  Tolerances: iteration counts equal; solutions to
1e-10 of their largest entry (both stop at rtol 1e-10; the port's plain K7
orders each tap as the TPU kernel body does, the reference's XLA SpMV adds
a full pair product per tap, and with the preconditioner its float32
outputs differ in the last bits); the true float64 residual below 1e-9,
beyond what float32 reaches.
"""
import importlib

import numpy as np
import pytest
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.problem import STENCIL_27PT as JAX_STENCIL_27PT
from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem as jax_build
from partitionedarrays_tpu.ops.stencil import stencil_psparse as jax_stencil_psparse
from partitionedarrays_tpu.solvers import krylov as jax_krylov
from partitionedarrays_tpu.solvers import smoothers as jax_smoothers

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.problem import STENCIL_27PT, build_hpcg_problem
from partitionedarrays_tpu_torch.ops import df64 as df
from partitionedarrays_tpu_torch.ops.stencil import stencil_psparse
from partitionedarrays_tpu_torch.psparse import spmv
from partitionedarrays_tpu_torch.pvector import PVector, collect_df64, pvector_df64
from partitionedarrays_tpu_torch.solvers.krylov import cg_df64
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel, JacobiCorrection

jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)

CONFIGS = {"one_part": ((8, 8, 8), (1, 1, 1)), "ghosted": ((4, 4, 4), (2, 2, 2))}


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    yield
    jax_config.use_pallas = saved


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("pc", ["none", "jacobi", "gauss_seidel"])
def test_cg_df64_matches_jax(config, pc):
    local, parts = CONFIGS[config]
    P = int(np.prod(parts))
    gshape = tuple(s * p for s, p in zip(local, parts))
    be, be_ref = SerialBackend(P), JaxSerialBackend(P)
    A = stencil_psparse(parts, gshape, STENCIL_27PT, be, dtype=np.float64, device="cpu")
    A_ref = jax_stencil_psparse(parts, gshape, JAX_STENCIL_27PT, be_ref, dtype=np.float64,
                                host_only=True)
    rng = np.random.default_rng(42)
    own = [rng.standard_normal(part.n_own) for part in A.row_prange.parts]
    b = pvector_df64(own, A.row_prange, be, device="cpu")
    b_ref = jax_pvector.pvector_df64(own, A_ref.row_prange, be_ref)
    M = M_ref = None
    if pc != "none":
        make, make_ref = {
            "jacobi": (JacobiCorrection, jax_smoothers.JacobiCorrection),
            "gauss_seidel": (GaussSeidel, jax_smoothers.GaussSeidel),
        }[pc]
        M = make(build_hpcg_problem(local, parts, be, dtype=np.float32, device="cpu")[0])
        M_ref = make_ref(jax_build(local, parts, be_ref, dtype=np.float32)[0])
    x, info = cg_df64(A, b, M=M, rtol=1e-10, maxiter=200)
    x_ref, info_ref = jax_krylov.cg_df64(A_ref, b_ref, M=M_ref, rtol=1e-10, maxiter=200)
    assert info.iterations == int(info_ref.iterations) > 0
    xg, xg_ref = collect_df64(x), jax_pvector.collect_df64(x_ref)
    np.testing.assert_allclose(xg, xg_ref, rtol=0, atol=1e-10 * np.abs(xg_ref).max())
    # the true float64 residual, beyond float32's reach
    x64 = df.to_f64(x[0].own, x[1].own)
    xv = PVector(x64, x64.new_zeros((P, A.row_layout().n_ghost_pad)), A.row_layout(), be)
    b64 = df.to_f64(b[0].own, b[1].own)
    relres = torch.linalg.vector_norm(b64 - spmv(A, xv).own) / torch.linalg.vector_norm(b64)
    assert relres < 1e-9, relres


def test_cg_df64_takes_pvectors_and_a_start():
    """A float64 PVector b is split exactly, and a start x0 is honored:
    from the solution, a solve to an absolute tolerance takes no
    iteration."""
    local, parts = CONFIGS["ghosted"]
    be = SerialBackend(8)
    A, b64 = build_hpcg_problem(local, parts, be, dtype=np.float64, device="cpu")
    x, info = cg_df64(A, b64, rtol=1e-10)
    assert info.iterations > 0
    _, again = cg_df64(A, b64, x0=x, rtol=0.0, atol=1e-8)
    assert again.iterations == 0
    # HPCG's b = 26 - counts is A @ ones
    np.testing.assert_allclose(collect_df64(x), 1.0, rtol=0, atol=1e-9)
