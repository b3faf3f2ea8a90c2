"""Shared cases of the reduced-precision preconditioner values: the colored
Gauss-Seidel state with values stored narrower than the vectors, and the
HPCG MG with ``precond_dtype``, of the PyTorch port against the JAX
reference (Pallas off; the port's plain kernel versions on the CPU).

``test_torch_precond_values_f32.py`` and ``test_torch_precond_values_f64.py``
run these cases, one vector dtype each, so that the reference's
compilations run on different workers under ``--dist loadfile``.

- Rounding: random values on the 27-point pattern at 16^3 (off-diagonals
  in [-1, -0.5], the diagonal in [26, 39]), stored as bfloat16 (or float32
  under float64 vectors) by both packages.  The stored bits are equal, the
  inverse diagonal (the vectors' dtype, from the unrounded diagonal) is
  within one ulp, and the sweeps and products are held to the tolerances
  of ``test_torch_gs_dia.py`` (float32 rtol 1e-4, float64 1e-10, of the
  largest reference entry).  The product and a forward sweep on the
  unrounded values differ by more than ten times that, so the checks can
  see a port that never rounds.  HPCG's own values (26 and -1) are exact
  in bfloat16 and could not.
- HPCG: the reference's MG with ``precond_dtype=bfloat16`` at 16^3, 3
  levels, handed to the port through ``convert.from_jax_arrays`` with its
  bfloat16 ``vals_d``; a CG history over 10 iterations is held to
  ``torch_hpcg_cases``' tolerances.  The reference compiles a bfloat16-
  valued CG for ~50 s, twice as long as a float32-valued one, so each
  dtype's file holds one route against it: the flat CG in float32, the
  generic CG in float64.  The other two are held through the port's own
  histories, which equal its float32-valued ones exactly (HPCG's values
  are exact in bfloat16), and those are held against the reference by
  ``test_torch_hpcg_cg_{f32,f64}.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.cg import hpcg_cg as jax_hpcg_cg
from partitionedarrays_tpu.models.hpcg.cg import hpcg_cg_flat as jax_hpcg_cg_flat
from partitionedarrays_tpu.models.hpcg.mg import HPCGMGPreconditioner as JaxMG
from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem as jax_build
from partitionedarrays_tpu.solvers.gs_dia import ColoredDIAGS as JaxColoredDIAGS

import torch_hpcg_cases
from partitionedarrays_tpu_torch.convert import from_jax_arrays
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg, hpcg_cg_flat
from partitionedarrays_tpu_torch.solvers.gs_dia import ColoredDIAGS

RTOL = {np.float32: 1e-4, np.float64: 1e-10}
ITERATIONS = torch_hpcg_cases.ITERATIONS
# the stored values' torch and JAX dtypes, and the numpy and torch dtypes
# that view their bits
VALUES = {
    "bfloat16": (torch.bfloat16, jnp.bfloat16, np.uint16, torch.int16),
    "float16": (torch.float16, jnp.float16, np.uint16, torch.int16),
    "float32": (torch.float32, jnp.float32, np.uint32, torch.int32),
}


def _close(got, ref, dtype):
    ref = np.asarray(ref)
    rtol = RTOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def colored_states(dtype, values: str):
    """The random 16^3 operator, its colored GS state in both packages with
    ``values`` storage, and the port's full-precision state."""
    A, _ = jax_build((16, 16, 16), (1, 1, 1), JaxSerialBackend(1), dtype=dtype)
    oo = A.device().oo
    rng = np.random.default_rng(40)
    vals = np.array(oo.vals) * rng.uniform(0.5, 1.0, oo.vals.shape).astype(dtype)
    k0 = oo.offsets.index(0)
    vals[:, k0] *= 1.5
    diag = np.ascontiguousarray(vals[:, k0])
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    try:
        ref = JaxColoredDIAGS(oo.offsets, vals, diag, values_dtype=VALUES[values][1])
    finally:
        jax_config.use_pallas = saved
    assert not ref.flat_vals  # [P, m, n_off, Lq] layout
    port = ColoredDIAGS.from_device(
        oo.offsets, torch.from_numpy(vals), torch.from_numpy(diag), VALUES[values][0]
    )
    full = ColoredDIAGS.from_device(oo.offsets, torch.from_numpy(vals), torch.from_numpy(diag))
    return dtype, values, ref, port, full


def check_values_bit_equal(states):
    _, values, ref, port, _ = states
    _, _, np_bits, torch_bits = VALUES[values]
    assert port.vals_d.dtype == VALUES[values][0]
    np.testing.assert_array_equal(
        port.vals_d.view(torch_bits).numpy().view(np_bits), np.asarray(ref.vals_d).view(np_bits)
    )


def check_invd_within_an_ulp(states):
    dtype, _, ref, port, _ = states
    assert port.invd_d.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    np.testing.assert_array_max_ulp(port.invd_d.numpy(), np.asarray(ref.invd_d), maxulp=1)


def _inputs(col, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, col.m, col.Lq)).astype(dtype),
            rng.standard_normal((1, col.m, col.Lq)).astype(dtype))


def _orders(m):
    fwd = tuple(range(m))
    return {"forward": fwd, "symmetric": fwd + fwd[::-1]}


def check_sweeps_core(states, start: str, order: str):
    """K3's plain version from a zero or a random guess."""
    dtype, _, ref, port, _ = states
    x0, bd = _inputs(port, dtype, 41)
    x0 = None if start == "zero" else x0
    seq = _orders(port.m)[order]
    want = jax.jit(lambda x, b, v, i: ref.sweeps_core(x, b, v, i, seq))(
        None if x0 is None else jnp.asarray(x0[0]), jnp.asarray(bd[0]),
        ref.vals_d[0], ref.invd_d[0],
    )
    xt = None if x0 is None else torch.from_numpy(x0)
    got = port.sweeps_core(xt, torch.from_numpy(bd), port.vals_d, port.invd_d, seq)
    _close(got[0].numpy(), want, dtype)


def check_ax_core(states):
    dtype, _, ref, port, _ = states
    x, _ = _inputs(port, dtype, 42)
    want = jax.jit(ref.ax_core)(jnp.asarray(x[0]), ref.vals_d[0])
    got = port.ax_core(torch.from_numpy(x), port.vals_d)
    assert got.dtype == port.invd_d.dtype
    _close(got[0].numpy(), want, dtype)


def check_rounding_is_visible(states, factor: float = 10.0):
    """The product and a forward sweep from a random guess on the unrounded
    values differ from the stored values' by over ``factor`` times the
    tolerance (a zero-guess sweep moves less: its first visit of a color
    reads no diagonal value)."""
    dtype, _, _, port, full = states
    x0, bd = (torch.from_numpy(a) for a in _inputs(port, dtype, 41))
    fwd = _orders(port.m)["forward"]
    for narrow, wide in (
        (port.ax_core(x0, port.vals_d), full.ax_core(x0, full.vals_d)),
        (port.sweeps_core(x0, bd, port.vals_d, port.invd_d, fwd),
         full.sweeps_core(x0, bd, full.vals_d, full.invd_d, fwd)),
    ):
        gap = (wide - narrow).abs().max().item()
        assert gap > factor * RTOL[dtype] * narrow.abs().max().item(), gap


def check_sweep_flat(states):
    """The standalone per-color sweep (K2's plain version), symmetric order."""
    dtype, _, ref, port, _ = states
    x0, bd = _inputs(port, dtype, 43)
    seq = _orders(port.m)["symmetric"]
    want = jax.jit(
        lambda x, b, v, i: ref.core_of_flat(ref.sweep_flat(ref.to_flat(x), b, v, i, seq))
    )(jnp.asarray(x0[0]), jnp.asarray(bd[0]), ref.vals_d[0], ref.invd_d[0])
    got = port.sweep_flat(torch.from_numpy(x0.copy()), torch.from_numpy(bd), port.vals_d,
                          port.invd_d, seq)
    _close(got[0].numpy(), want, dtype)


def _jax_flat(mg, b):
    return jax_hpcg_cg_flat(mg, b, iterations=ITERATIONS)[1]


def _jax_generic(mg, b):
    return jax_hpcg_cg(mg.A, b, M=mg, iterations=ITERATIONS)[1]


_JAX_ROUTES = {"flat": _jax_flat, "generic": _jax_generic}


def hpcg_solve(dtype, route: str):
    """The reference's bfloat16-valued MG at 16^3, 3 levels, the history of
    its ``route`` CG ("flat" or "generic") over 10 iterations, and the
    port's MG built from the same arrays (the storage dtype stated in the
    levels for float64, read off the arrays for float32)."""
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    try:
        mg = JaxMG((16, 16, 16), (1, 1, 1), JaxSerialBackend(1), n_levels=3, dtype=dtype,
                   precond_dtype=jnp.bfloat16)
        assert all(gs.colored.vals_d.dtype == jnp.bfloat16 for gs in mg.gss)
        history = np.array(jax.jit(_JAX_ROUTES[route])(mg, mg.b))
        levels = torch_hpcg_cases.levels_of(mg)
    finally:
        jax_config.use_pallas = saved
    if dtype == np.float64:
        for lev in levels:
            lev["values_dtype"] = "bfloat16"
    return dtype, route, from_jax_arrays(levels, device="cpu"), history


def port_history(mg, route: str) -> np.ndarray:
    if route == "flat":
        return hpcg_cg_flat(mg, mg.b, iterations=ITERATIONS)[1].numpy()
    return hpcg_cg(mg.A, mg.b, M=mg, iterations=ITERATIONS)[1].numpy()


def check_history_matches_jax(solved):
    dtype, route, pmg, history = solved
    assert pmg.values_dtype == torch.bfloat16
    torch_hpcg_cases._assert_history_close(port_history(pmg, route), history, dtype)
