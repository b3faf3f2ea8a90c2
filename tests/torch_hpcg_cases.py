"""Shared cases of the HPCG solve parity tests: one V-cycle and the flat
and generic CG histories of the PyTorch port against the JAX reference, at
16^3, 3 levels, 10 iterations.

``test_torch_hpcg_cg_f32.py`` and ``test_torch_hpcg_cg_f64.py`` run these
cases, one dtype each, so that the two reference compilations (the
costliest part of the port's tests) run on different workers under
``--dist loadfile``.

Both packages get the same state: the reference builds it (JAX on the CPU,
Pallas off) and ``convert.from_jax_arrays`` hands its arrays to the port,
which runs its plain PyTorch kernel versions on the CPU.  The reference's
V-cycle and both CG solves are jitted as one function, with the
preconditioner and b as arguments.  Tolerances:

- float64 rtol 1e-10: only the summation order differs;
- float32 rtol 1e-4 on a single output (the V-cycle);
- float32 rtol 1e-3 on residual histories, where the relative residual is
  above 1e-6.  Below that the float32 recurrence is dominated by rounding:
  the last step at 16^3 (relres ~3e-7) differs by ~1e-3 between the
  packages, and the reference's own flat and generic paths differ by 2e-4.
  There both must still be below 1e-6 and agree to rtol 1e-2.
"""
import jax
import numpy as np
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.cg import hpcg_cg as jax_hpcg_cg
from partitionedarrays_tpu.models.hpcg.cg import hpcg_cg_flat as jax_hpcg_cg_flat
from partitionedarrays_tpu.models.hpcg.mg import HPCGMGPreconditioner as JaxMG

from partitionedarrays_tpu_torch.convert import from_jax_arrays
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg, hpcg_cg_flat
from partitionedarrays_tpu_torch.psparse import spmv

ITERATIONS = 10


def levels_of(mg):
    """The reference MG's state as numpy arrays, coarsest level first."""
    levels = []
    for A, b, gs, shape in zip(mg.As, mg.bs, mg.gss, mg.level_shapes):
        col = gs.colored
        assert not col.flat_vals
        levels.append(
            dict(
                local_shape=shape,
                offsets=A.device().oo.offsets,
                oo_vals=np.array(A.device().oo.vals),
                b_own=np.array(b.own),
                vals_d=np.array(col.vals_d),
                invd_d=np.array(col.invd_d),
            )
        )
    return levels


def _reference(mg, b, r_std):
    """One V-cycle on the de-interleaved r_std, then both CG solves."""
    rd = mg.gss[-1].colored.deinterleave(r_std)[None]
    return (
        rd,
        mg.apply_flat(rd),
        jax_hpcg_cg_flat(mg, b, iterations=ITERATIONS)[1],
        jax_hpcg_cg(mg.A, b, M=mg, iterations=ITERATIONS)[1],
    )


def solve(dtype):
    """The reference MG at 16^3, 3 levels, its outputs, and the port's MG
    built from the same arrays."""
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    try:
        mg = JaxMG((16, 16, 16), (1, 1, 1), JaxSerialBackend(1), n_levels=3, dtype=dtype)
        r_std = np.random.default_rng(20).standard_normal(mg.gss[-1].colored.R).astype(dtype)
        out = jax.jit(_reference)(mg, mg.b, r_std)
        rd, cycle, flat, generic = (np.array(o) for o in out)
        levels = levels_of(mg)
    finally:
        jax_config.use_pallas = saved
    ref = {"rd": rd, "cycle": cycle, "flat": flat, "generic": generic}
    return dtype, from_jax_arrays(levels), ref


def _assert_history_close(got, want, dtype):
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-10)
        return
    rel = want / want[0]
    above = rel > 1e-6
    np.testing.assert_allclose(got[above], want[above], rtol=1e-3)
    assert (got[~above] / got[0] < 1e-6).all()
    np.testing.assert_allclose(got[~above], want[~above], rtol=1e-2)


def check_apply_flat(solved):
    """One V-cycle in the de-interleaved layout."""
    dtype, pmg, ref = solved
    got = pmg.apply_flat(torch.from_numpy(ref["rd"])).numpy()
    want = ref["cycle"]
    rtol = 1e-10 if dtype == np.float64 else 1e-4  # a single output in float32
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def check_cg_flat_history(solved):
    dtype, pmg, ref = solved
    _, norms = hpcg_cg_flat(pmg, pmg.b, iterations=ITERATIONS)
    _assert_history_close(norms.numpy(), ref["flat"], dtype)


def check_cg_generic_history(solved):
    dtype, pmg, ref = solved
    _, norms = hpcg_cg(pmg.A, pmg.b, M=pmg, iterations=ITERATIONS)
    _assert_history_close(norms.numpy(), ref["generic"], dtype)


def check_cg_solution_solves_the_system(solved):
    """The flat solve's x, back in standard order, has the residual its
    history reports (checked through the standard-order SpMV)."""
    dtype, pmg, _ = solved
    x, norms = hpcg_cg_flat(pmg, pmg.b, iterations=ITERATIONS)
    true_norm = torch.linalg.vector_norm(pmg.b.own - spmv(pmg.A, x).own).item()
    if dtype == np.float64:
        # the recurrence and the true residual agree while far above rounding
        assert abs(true_norm - norms[-1].item()) <= 1e-6 * norms[-1].item()
    else:
        assert true_norm / norms[0].item() < 1e-5
