"""Shared cases of the df64 HPCG parity tests: ``hpcg_cg_df64`` with the
float32 MG and with no preconditioner, and the benchmark with
``precision="df64"``, of the PyTorch port against the JAX reference.

``test_torch_hpcg_df64.py`` runs them on one part at 16^3 and
``test_torch_hpcg_df64_ghosted.py`` on (2,2,2) parts of 8^3, 3 levels and
14 iterations each (the relative residual with the MG then lies between
1e-10 and 1e-8, below what a float32 CG reaches), so that the two
reference compilations run on different workers under ``--dist
loadfile``.

Both packages get the same state: the reference builds its float32 MG
(JAX on the CPU, Pallas off) and ``convert.from_jax_arrays`` hands its
arrays to the port; both build the exact float64 operator in closed form
(the reference with ``host_only=True``) and split it and ``b = 26 -
counts`` into (hi, lo) pairs.  The reference's two solves are jitted as
one function.  Tolerances:

- no preconditioner: only the df64 arithmetic runs, and the port's K7
  plain version orders each tap's terms as the TPU kernel body does, not
  as the reference's XLA ``dia_spmv_df`` (they agree to ~2^-48 of
  ``sum |A||x|``): histories (float32 norms) to rtol 1e-6, solutions to
  1e-12 of their largest entry;
- the float32 MG: its outputs differ in the last float32 bits (summation
  order), which moves the search directions; the difference grows as the
  residual falls (3e-5 at relres 4e-10, a factor of 3 at 1e-13 after 20
  iterations): histories to rtol 1e-4, solutions to 1e-8 of their
  largest entry.
"""
import jax
import numpy as np

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.cg import hpcg_cg_df64 as jax_hpcg_cg_df64
from partitionedarrays_tpu.models.hpcg.mg import HPCGMGPreconditioner as JaxMG
from partitionedarrays_tpu.models.hpcg.problem import STENCIL_27PT
from partitionedarrays_tpu.ops import df64 as jdf
from partitionedarrays_tpu.ops.stencil import stencil_psparse as jax_stencil_psparse
from partitionedarrays_tpu.ops.stencil import stencil_rhs_counts as jax_rhs_counts
from partitionedarrays_tpu.psparse import device_df64 as jax_device_df64
from partitionedarrays_tpu.pvector import PVector as JaxPVector

from partitionedarrays_tpu_torch.convert import from_jax_arrays
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_df64
from partitionedarrays_tpu_torch.models.hpcg.driver import cg_route, df64_problem, hpcg_benchmark
from partitionedarrays_tpu_torch.ops import df64 as df
from torch_hpcg_cases import levels_of
from torch_hpcg_ghosted_cases import ghosted_levels_of

LEVELS = 3
ITERATIONS = 14


def _reference(A, mg, bh, bl):
    (xh, xl), norms = jax_hpcg_cg_df64(A, (bh, bl), M=mg, iterations=ITERATIONS)
    (yh, yl), norms_id = jax_hpcg_cg_df64(A, (bh, bl), M=None, iterations=ITERATIONS)
    return xh, xl, norms, yh, yl, norms_id


def solve(local_shape, parts):
    """The reference's two df64 solves and the port's MG built from the
    reference's float32 MG."""
    P = int(np.prod(parts))
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    try:
        be = JaxSerialBackend(P)
        mg = JaxMG(local_shape, parts, be, n_levels=LEVELS, dtype=np.float32)
        gshape = tuple(s * p for s, p in zip(local_shape, parts))
        A = jax_stencil_psparse(parts, gshape, STENCIL_27PT, be, dtype=np.float64, host_only=True)
        jax_device_df64(A)
        lay = A.row_layout()
        b = np.zeros((P, lay.n_own_pad))
        offdiag = [d for d, _ in STENCIL_27PT if d != (0, 0, 0)]
        for p, c in enumerate(jax_rhs_counts(parts, gshape, offdiag)):
            b[p, : c.size] = 26.0 - c
        bh, bl = jdf.from_f64(b)
        zg = np.zeros((P, lay.n_ghost_pad), np.float32)
        out = jax.jit(_reference)(
            A, mg, JaxPVector(bh, zg, lay, be), JaxPVector(bl, zg, lay, be)
        )
        xh, xl, norms, yh, yl, norms_id = (np.array(o) for o in out)
        levels = ghosted_levels_of(mg) if P > 1 else levels_of(mg)
    finally:
        jax_config.use_pallas = saved
    ref = {
        "x": jdf.to_f64(xh, xl), "norms": norms,
        "x_id": jdf.to_f64(yh, yl), "norms_id": norms_id,
    }
    pmg = from_jax_arrays(levels, device="cpu")
    return local_shape, parts, pmg, ref


def _port_solve(solved, with_mg):
    local_shape, parts, pmg, _ = solved
    A, b = df64_problem(local_shape, parts, pmg.backend, "cpu")
    (xh, xl), norms = hpcg_cg_df64(A, b, M=pmg if with_mg else None, iterations=ITERATIONS)
    return df.to_f64(xh, xl).numpy(), norms.numpy()


def check_cg_df64_with_mg(solved):
    ref = solved[3]
    x, norms = _port_solve(solved, with_mg=True)
    assert norms[-1] / norms[0] < 1e-8  # beyond what a float32 CG reaches
    np.testing.assert_allclose(norms, ref["norms"], rtol=1e-4)
    np.testing.assert_allclose(x, ref["x"], rtol=0, atol=1e-8 * np.abs(ref["x"]).max())


def check_cg_df64_identity_keeps_both_words(solved):
    """With no preconditioner z = r in both words: x tracks the reference's
    to 1e-12, far below float32 precision (the reference's round-2 fault
    quantized z to float32 and x stalled at ~1e-7)."""
    ref = solved[3]
    x, norms = _port_solve(solved, with_mg=False)
    np.testing.assert_allclose(norms, ref["norms_id"], rtol=1e-6)
    np.testing.assert_allclose(x, ref["x_id"], rtol=0, atol=1e-12 * np.abs(ref["x_id"]).max())


def check_benchmark_df64(solved):
    """``hpcg_benchmark(precision="df64")`` on the CPU reaches the
    reference's relative residual and reports the df64 precision."""
    local_shape, parts, pmg, ref = solved
    assert cg_route(pmg, "df64") == "df64"
    report = hpcg_benchmark(
        None, local_shape=local_shape, parts_per_dir=parts, n_levels=LEVELS,
        iterations=ITERATIONS, ref_sets=1, timed_sets=1, precision="df64",
        mg=pmg, device="cpu",
    )
    s = report.summary()
    assert s["dtype"] == "float64-df64" and s["precision_bits"] == 49
    assert "Compute dtype = float64-df64 (official-precision configuration" in report.to_txt()
    assert s["validation_passed"] and s["chain_consistent"]
    want = ref["norms"][-1] / ref["norms"][0]
    np.testing.assert_allclose(s["final_relres"], want, rtol=1e-4)
