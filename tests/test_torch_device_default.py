"""The port's entry points run on the card unless the caller asks for the
CPU: each defaults to ``device="cuda"``, with no fallback.  Without a CUDA
build of torch a call with no device raises torch's no-CUDA error instead
of running on the CPU."""
import inspect

import numpy as np
import pytest
import torch

from partitionedarrays_tpu_torch import convert, pvector
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import hpcg
from partitionedarrays_tpu_torch.models.gallery import laplacian_fdm, plaplacian_fdm
from partitionedarrays_tpu_torch.models.hpcg.driver import hpcg_benchmark
from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.ops.blocks import freeze_block
from partitionedarrays_tpu_torch.ops.stencil import stencil_psparse
from partitionedarrays_tpu_torch.psparse import (
    PSparseMatrix,
    device_refill_plan,
    psparse,
    psparse_from_global,
    psparse_from_blocks,
    psystem,
    repartition_matrix,
)

ENTRY_POINTS = [
    hpcg_benchmark, HPCGMGPreconditioner.__init__, build_hpcg_problem, stencil_psparse,
    freeze_block, pvector.pfill, pvector.pzeros, pvector.pones, pvector.pvector_from_own,
    pvector.pvector_df64, pvector.pvector, convert.from_jax_arrays,
    convert.psparse_from_host_blocks, psparse, psparse_from_global, PSparseMatrix.__init__,
    psystem, hpcg.build_p_matrix, hpcg.pc_setup, plaplacian_fdm, pvector.prand, pvector.prandn,
    pvector.pvector_from_local, pvector.pvector_local, psparse_from_blocks,
]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_point_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("precision", [None, "df64"])
def test_benchmark_without_device_does_not_run_on_the_cpu(precision):
    """The first device tensor of the problem build asks for CUDA, so no
    set runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(AssertionError, match="CUDA"):
        hpcg_benchmark(
            None, local_shape=(4, 4, 4), parts_per_dir=(1, 1, 1), n_levels=2,
            iterations=2, ref_sets=1, timed_sets=1, dtype=np.float64, precision=precision,
        )
    with pytest.raises(AssertionError, match="CUDA"):
        build_hpcg_problem((4, 4, 4), (1, 1, 1), SerialBackend(1))


def test_elasticity_amg_without_device_does_not_run_on_the_cpu():
    """A COO matrix built with no device freezes on the card, and so does
    the AMG hierarchy built on it: without a card the freeze raises."""
    from partitionedarrays_tpu_torch.models.gallery import (
        linear_elasticity_fem, node_coordinates_unit_cube, nullspace_linear_elasticity,
    )
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    I, J, V, rows, cols = linear_elasticity_fem((4, 4, 4), (1, 1, 1))
    A = psparse(I, J, V, rows, cols, SerialBackend(1))
    assert A.torch_device.type == "cuda"
    coords, _ = node_coordinates_unit_cube((4, 4, 4), (1, 1, 1))
    with pytest.raises(AssertionError, match="CUDA"):
        AMGPreconditioner(A, AMGParams(coarse_size=20, block_size=3),
                          nullspace=nullspace_linear_elasticity(coords))


def test_reuse_tier_without_device_does_not_run_on_the_cpu():
    """``psystem`` and ``pvector(reuse=True)`` build their vectors on the
    card, ``device_refill_plan`` freezes its matrix there, and the example's
    user code runs the port on the card: without one, each raises."""
    import os
    import sys

    from partitionedarrays_tpu_torch.models.gallery import laplacian_fdm

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    I, J, V, rows, cols = laplacian_fdm((4, 4), (1, 1))
    Ib = [np.arange(16)]
    with pytest.raises(AssertionError, match="CUDA"):
        psystem(I, J, V, Ib, [np.ones(16)], rows, cols, SerialBackend(1), reuse=True)
    with pytest.raises(AssertionError, match="CUDA"):
        pvector.pvector(Ib, [np.ones(16)], rows, SerialBackend(1), reuse=True)
    A, cache = psparse(I, J, V, rows, cols, SerialBackend(1), assembled=True, reuse=True)
    with pytest.raises(AssertionError, match="CUDA"):
        device_refill_plan(A, cache)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "examples"))
    import implicit_reuse

    assert inspect.signature(implicit_reuse.port).parameters["device"].default == "cuda"
    with pytest.raises(AssertionError, match="CUDA"):
        implicit_reuse.reaction_diffusion(implicit_reuse.port(), nodes=(4, 4, 4), steps=1)


def test_partition_utilities_without_device_do_not_run_on_the_cpu():
    """``plaplacian_fdm``, ``prand``/``prandn``, ``pvector_local`` and
    ``pvector_from_local`` put their tensors on the card: without one, each
    raises.  ``repartition`` and ``repartition_matrix`` keep their input's
    device (a vector on the "meta" device stays there; a matrix built for
    the card is rebuilt for it), never falling back to the CPU."""
    from partitionedarrays_tpu_torch.parallel.partition import PRange, variable_partition

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(AssertionError, match="CUDA"):
        plaplacian_fdm((5, 6, 7), (2, 2, 2), SerialBackend(8))
    I, J, V, rows, cols = laplacian_fdm((4, 4), (2, 1))
    pr = PRange(rows)
    for draw in (pvector.prand, pvector.prandn):
        with pytest.raises(AssertionError, match="CUDA"):
            draw(torch.Generator(), pr, SerialBackend(2))
    with pytest.raises(AssertionError, match="CUDA"):
        pvector.pvector_local(I, [np.ones(i.size) for i in I], pr, SerialBackend(2))
    with pytest.raises(AssertionError, match="CUDA"):
        pvector.pvector_from_local([np.ones(li.n_local) for li in rows], pr, SerialBackend(2))
    new = PRange(variable_partition([5, 11]))
    x = pvector.pvector_from_own([np.ones(li.n_own) for li in rows], pr, SerialBackend(2),
                                 device="meta")
    assert pvector.repartition(x, new).own.device.type == "meta"
    A = psparse(I, J, V, rows, cols, SerialBackend(2), assembled=True)
    assert repartition_matrix(A, new, new).torch_device.type == "cuda"
