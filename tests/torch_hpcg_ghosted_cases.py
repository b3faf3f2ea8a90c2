"""Shared cases of the ghosted HPCG parity tests: the V-cycle through
``mg(r)`` and the ghosted flat and generic CG histories of the PyTorch port
against the JAX reference, at (2,2,2) parts of 8^3, 3 levels, 10 iterations.

``test_torch_hpcg_ghosted_f32.py`` and ``test_torch_hpcg_ghosted_f64.py``
run these cases, one dtype each, so that the two reference compilations run
on different workers under ``--dist loadfile``.

Both packages get the same state: the reference builds it (JAX on the CPU,
Pallas off) and ``convert.from_jax_arrays`` hands its arrays to the port,
which builds its own layouts and exchange plans from the ghost ids and runs
its plain PyTorch kernel versions on the CPU.  The reference's V-cycle and
both CG solves are jitted as one function.  Tolerances are those of
``torch_hpcg_cases.py``: float64 rtol 1e-10; float32 rtol 1e-4 on the
V-cycle, and ``_assert_history_close`` on the histories.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.cg import hpcg_cg as jax_hpcg_cg
from partitionedarrays_tpu.models.hpcg.cg import hpcg_cg_flat_g as jax_hpcg_cg_flat_g
from partitionedarrays_tpu.models.hpcg.mg import HPCGMGPreconditioner as JaxMG
from partitionedarrays_tpu.pvector import PVector as JaxPVector

from partitionedarrays_tpu_torch.convert import from_jax_arrays
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg, hpcg_cg_flat_g
from partitionedarrays_tpu_torch.models.hpcg.driver import cg_route
from partitionedarrays_tpu_torch.pvector import PVector
from torch_hpcg_cases import _assert_history_close, levels_of

LOCAL = (8, 8, 8)
PARTS = (2, 2, 2)
LEVELS = 3
ITERATIONS = 10


def ghosted_levels_of(mg):
    """``levels_of`` plus each level's ghosts and own-ghost CSR blocks."""
    levels = levels_of(mg)
    for lev, A in zip(levels, mg.As):
        cols = A.col_prange.partition()
        ohs = [b["oh"].tocsr() for b in A.blocks]
        lev.update(
            parts_per_dir=PARTS,
            ghost_to_global=[np.array(li.ghost_to_global) for li in cols],
            ghost_to_owner=[np.array(li.ghost_to_owner) for li in cols],
            oh_indptr=[m.indptr for m in ohs],
            oh_indices=[m.indices for m in ohs],
            oh_data=[m.data for m in ohs],
        )
    return levels


def _reference(mg, b, r_own):
    lay = mg.A.row_layout()
    r = JaxPVector(r_own, jnp.zeros((lay.n_parts, lay.n_ghost_pad), r_own.dtype), lay, b.backend)
    return (
        mg(r).own,
        jax_hpcg_cg_flat_g(mg, b, iterations=ITERATIONS)[1],
        jax_hpcg_cg(mg.A, b, M=mg, iterations=ITERATIONS)[1],
    )


def solve(dtype):
    """The reference MG, its outputs on a random r, and the port's MG built
    from the same arrays."""
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    try:
        mg = JaxMG(LOCAL, PARTS, JaxSerialBackend(8), n_levels=LEVELS, dtype=dtype)
        assert not mg.flat_viable() and mg.flat_viable_ghosted()
        lay = mg.A.row_layout()
        r_own = np.zeros((lay.n_parts, lay.n_own_pad), dtype=dtype)
        rng = np.random.default_rng(21)
        for p, n in enumerate(lay.n_own):
            r_own[p, :n] = rng.standard_normal(int(n))
        cycle, flat_g, generic = (np.array(o) for o in jax.jit(_reference)(mg, mg.b, r_own))
        levels = ghosted_levels_of(mg)
    finally:
        jax_config.use_pallas = saved
    ref = {"r_own": r_own, "cycle": cycle, "flat_g": flat_g, "generic": generic}
    return dtype, from_jax_arrays(levels, device="cpu"), ref


def check_vcycle(solved):
    """``mg(r)`` on a ghosted operator returns a PVector on the finest row
    layout whose own values are the reference's."""
    dtype, pmg, ref = solved
    lay = pmg.A.row_layout()
    r_own = torch.from_numpy(ref["r_own"])
    out = pmg(PVector(r_own, r_own.new_zeros((lay.n_parts, lay.n_ghost_pad)), lay, pmg.backend))
    assert isinstance(out, PVector) and out.layout is lay
    want = ref["cycle"]
    rtol = 1e-10 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(out.own.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


def check_cg_flat_g_history(solved):
    dtype, pmg, ref = solved
    assert cg_route(pmg) == "flat_g"
    _, norms = hpcg_cg_flat_g(pmg, pmg.b, iterations=ITERATIONS)
    _assert_history_close(norms.numpy(), ref["flat_g"], dtype)


def check_cg_generic_history(solved):
    dtype, pmg, ref = solved
    _, norms = hpcg_cg(pmg.A, pmg.b, M=pmg, iterations=ITERATIONS)
    _assert_history_close(norms.numpy(), ref["generic"], dtype)
