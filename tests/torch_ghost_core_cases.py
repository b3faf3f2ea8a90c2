"""The HPCG ghost coupling in standard order, as ``hpcg_cg_flat_g`` and
``HPCGMGPreconditioner._cycle_flat_g`` ran it before the coupling moved into
the core layout: every coupling interleaves x, takes ``ghost_contrib`` (a
zero-filled K5 output in standard order) and de-interleaves or subtracts
the result.  The tests hold the core-layout path to it bit for bit
(``tests/test_torch_ghost_core.py``, ``tests/test_torch_ghost_core_gpu.py``).
Imports torch and the port only."""
import numpy as np
import torch

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.cg import _core_dot
from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
from partitionedarrays_tpu_torch.pvector import PVector
from partitionedarrays_tpu_torch.utils.profiling import span

PARTS = [(2, 2, 2), (1, 1, 4)]
DTYPES = [torch.float64, torch.float32]
NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def build_mg(n, parts, dtype, device="cpu", levels=4):
    P = parts[0] * parts[1] * parts[2]
    return HPCGMGPreconditioner((n, n, n), parts, SerialBackend(P), n_levels=levels,
                                dtype=NP_DTYPE[dtype], device=device)


def std_couple(gs, xcore, ycore, subtract):
    """``ycore ± deinterleave(ghost_contrib(interleave(x)))``: the
    standard-order composition of one coupling."""
    gc = gs.flat_deinterleave(gs.ghost_contrib(gs.flat_interleave(xcore)))
    return ycore - gc if subtract else ycore + gc


def _std_cycle(mg, l, b):
    """``HPCGMGPreconditioner._cycle`` with the standard-order ghosted level."""
    gs = mg.gss[l]
    if l == 0:
        with span("mg.level", level=0):
            return gs(b)
    x_own = gs.flat_interleave(std_level(mg, l, b))
    rlay = mg.As[l].row_layout()
    return PVector(x_own, x_own.new_zeros((x_own.shape[0], rlay.n_ghost_pad)), rlay, mg.backend)


def std_level(mg, l, b):
    """The ghosted V-cycle level on a standard-order rhs, in standard order
    around each ghost coupling."""
    with span("mg.level", level=l):
        gs = mg.gss[l]
        bd0 = gs.make_bd(b)
        xflat = gs.smooth_bd(None, bd0)
        gc = gs.ghost_contrib(gs.flat_interleave(xflat))
        r_std = gs.flat_interleave(gs.flat_residual(xflat, bd0)) - gc
        xc = _std_cycle(mg, l - 1, mg._restrict(l, r_std))
        xflat = gs.flat_add_std(xflat, mg._prolong(l, xc.own, r_std.shape[1]))
        gc2 = gs.ghost_contrib(gs.flat_interleave(xflat))
        return gs.smooth_bd(xflat, gs.flat_deinterleave(b.own - gc2))


def std_cg(mg, b, iterations):
    """``hpcg_cg_flat_g`` with the standard-order A-apply and
    preconditioner; returns (x core, norms)."""
    gs = mg.gss[-1]
    lay = b.layout

    def dot(u, v):
        return b.backend.allreduce(_core_dot(u, v))

    def a_apply(p):
        return gs.flat_ax(p) + gs.flat_deinterleave(gs.ghost_contrib(gs.flat_interleave(p)))

    def m_apply(r):
        r_std = gs.flat_interleave(r)
        rv = PVector(r_std, r_std.new_zeros((r_std.shape[0], lay.n_ghost_pad)), lay, b.backend)
        return std_level(mg, mg.n_levels - 1, rv)

    bf = gs.make_bd(b)
    x = torch.zeros_like(bf)
    r = bf
    norms = bf.new_zeros(iterations + 1)
    norms[0] = torch.sqrt(dot(r, r))
    z = m_apply(r)
    p = z
    rz = dot(r, z)
    for k in range(iterations):
        Ap = a_apply(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = m_apply(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        norms[k + 1] = torch.sqrt(dot(r, r))
    return gs.flat_interleave(x), norms


def random_rhs(mg, seed):
    """A random standard-order rhs PVector on the finest level (zero
    padding)."""
    A = mg.A
    lay = A.row_layout()
    g = torch.Generator().manual_seed(seed)
    dtype = mg.gss[-1].colored.invd_d.dtype
    own = torch.zeros(lay.n_parts, lay.n_own_pad, dtype=dtype)
    for p, n in enumerate(lay.n_own):
        own[p, :n] = torch.randn(int(n), generator=g, dtype=torch.float64).to(dtype)
    device = mg.gss[-1].colored.invd_d.device
    own = own.to(device)
    return PVector(own, own.new_zeros((lay.n_parts, lay.n_ghost_pad)), lay, mg.backend)
