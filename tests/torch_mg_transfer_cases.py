"""The HPCG V-cycle's level transfers through standard order, as the port ran
them before they moved into the core layout: the residual interleaved,
``_restrict`` (a stride-2 slice) and the coarse ``make_bd``; the coarse x
interleaved, ``_prolong`` (a zero fine box with a strided scatter) and
``flat_add_std``.  The tests hold ``ops/mg_transfer.py`` and the cycle to
them bit for bit (``tests/test_torch_mg_transfer.py``,
``tests/test_torch_mg_transfer_gpu.py``).  Imports torch and the port only."""
import torch

from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner


def std_restrict(mg: HPCGMGPreconditioner, l: int, rd: torch.Tensor) -> torch.Tensor:
    """The coarse core rhs of level ``l``'s core residual ``rd``."""
    return mg.gss[l - 1].make_bd(mg._restrict(l, mg.gss[l].flat_interleave(rd)))


def std_prolong_add(mg: HPCGMGPreconditioner, l: int, xflat: torch.Tensor,
                    xc: torch.Tensor) -> torch.Tensor:
    """Level ``l``'s core x plus the prolongation of the coarse core x."""
    gs = mg.gss[l]
    corr = mg._prolong(l, mg.gss[l - 1].flat_interleave(xc), gs.colored.R)
    return gs.flat_add_std(xflat, corr)


def std_vcycle(mg: HPCGMGPreconditioner, l: int, bd: torch.Tensor) -> torch.Tensor:
    """``HPCGMGPreconditioner._vcycle`` with the standard-order transfers."""
    gs = mg.gss[l]
    if l == 0:
        return gs.smooth_bd(None, gs.ghost_couple_core(None, bd, subtract=True))
    xflat = gs.smooth_bd(None, bd)
    rd = gs.ghost_couple_core(xflat, gs.flat_residual(xflat, bd), subtract=True)
    xc = std_vcycle(mg, l - 1, std_restrict(mg, l, rd))
    xflat = std_prolong_add(mg, l, xflat, xc)
    return gs.smooth_bd(xflat, gs.ghost_couple_core(xflat, bd, subtract=True))


def random_core(gs, seed: int, dtype, device="cpu") -> torch.Tensor:
    """A random core of level ``gs``, padding slots included."""
    col = gs.colored
    g = torch.Generator().manual_seed(seed)
    P = gs.A.row_layout().n_parts
    return torch.randn(P, col.m, col.Lq, generator=g, dtype=torch.float64).to(dtype).to(device)
