"""The plain reference of the HPCG configuration on a grid of parts, in
plain PyTorch.

It rebuilds from the configuration alone what the port derives across
``parts_per_dir`` equal parts of ``local_grid`` each: every level's global
box (the parts' boxes side by side, each level half the last in every
direction), the 27-point operator on it (``reference/hpcg.py``'s), and the
smoother the port runs across parts, a block (hybrid) symmetric
Gauss-Seidel:

- each part sweeps its own rows in its local ordering: rows colored by
  their index in the part's C-ordered box mod m (``part_coloring``: the
  smallest m >= 2 dividing no neighbour offset inside the part's box),
  colors 0..m-1, then m-1..0, all parts at once;
- a neighbour in another part is taken from a frozen copy of x, whose
  coupling is the global 3x3x3 box sum of the frozen x less the per-part
  box sum of it (the parts held as ``[P, n0, n1, n2]``);
- in the V-cycle the pre-smooth starts from a zero guess with zero ghosts,
  the level residual takes fresh ghosts (the global operator), the
  post-smooth takes ghosts refreshed once after the coarse correction and
  frozen through both sweeps, and the coarsest level smooths only, from
  zero with zero ghosts;
- restriction by injection of the even points, prolongation by its
  transpose (per part and globally the same points, the parts' boxes
  being even), and ``iterations`` PCG iterations from a zero guess with
  the global operator and global dots.

Where it departs from HPCG 3.1's reference code: ``ComputeSYMGS_ref``
exchanges x's halo once before each symmetric sweep, the zero-guess
pre-smooth's and the coarsest level's included.  There x is zero, so the
halo it brings is zero, and this reference (as the port) takes zero
ghosts without an exchange: the same numbers.  HPCG's reference sweeps
each rank's rows in their natural order; the mod-m colored order is one
that optimised HPCG codes may use (as ``configs/hpcg.json`` says).

``compare`` judges the port's last set of the window as
``reference/hpcg.py`` does: ``history_gap``, ``x_gap`` and
``values_bits_short``.  It imports nothing of the program.
"""
from __future__ import annotations

from itertools import product
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.precision import bits_short

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def part_coloring(local: Sequence[int]) -> int:
    """The smallest m >= 2 that divides no offset between two neighbours
    inside the part's box (``reference/hpcg.py::mod_coloring``, but a box
    one point wide along an axis has no neighbour along it)."""
    n0, n1, n2 = local
    offs = [dx * n1 * n2 + dy * n2 + dz
            for dx, dy, dz in product(*[(-1, 0, 1) if n > 1 else (0,) for n in local])
            if (dx, dy, dz) != (0, 0, 0)]
    return next(m for m in range(2, 513) if all(o % m for o in offs))


def box_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of x over each point's 3x3x3 neighbourhood inside its box;
    x is ``[B, n0, n1, n2]``, B boxes summed apart."""
    p = F.pad(x, (1, 1, 1, 1, 1, 1))
    s = p[:, :-2] + p[:, 1:-1] + p[:, 2:]
    s = s[:, :, :-2] + s[:, :, 1:-1] + s[:, :, 2:]
    return s[..., :-2] + s[..., 1:-1] + s[..., 2:]


class PartsLevel:
    """One level: ``parts`` boxes of ``local`` points, a vector held as
    ``[P, n0, n1, n2]`` with the parts in C order."""

    def __init__(self, local: Sequence[int], parts: Sequence[int], device, dtype):
        self.local = tuple(int(n) for n in local)
        self.parts = tuple(int(p) for p in parts)
        self.m = part_coloring(self.local)
        color = torch.arange(self.local[0] * self.local[1] * self.local[2],
                             device=device).reshape(self.local) % self.m
        self.colors = [color == c for c in range(self.m)]

    def join(self, xp: torch.Tensor) -> torch.Tensor:
        """``[P, n0, n1, n2]`` -> the global box, C order."""
        (p0, p1, p2), (n0, n1, n2) = self.parts, self.local
        return xp.reshape(p0, p1, p2, n0, n1, n2).permute(0, 3, 1, 4, 2, 5).reshape(
            p0 * n0, p1 * n1, p2 * n2)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """The global box -> ``[P, n0, n1, n2]``."""
        (p0, p1, p2), (n0, n1, n2) = self.parts, self.local
        return x.reshape(p0, n0, p1, n1, p2, n2).permute(0, 2, 4, 1, 3, 5).reshape(
            -1, n0, n1, n2)

    def global_box_sum(self, xp: torch.Tensor) -> torch.Tensor:
        return self.split(box_sum(self.join(xp)[None])[0])

    def apply(self, xp: torch.Tensor) -> torch.Tensor:
        """The global operator: A x = 26 x - (the neighbours' sum)."""
        return 27.0 * xp - self.global_box_sum(xp)

    def smooth(self, xp: torch.Tensor, b: torch.Tensor,
               frozen: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One symmetric block Gauss-Seidel sweep: each part's color takes
        (b + the other parts' frozen neighbours + its own part's neighbours)
        / 26; ``frozen`` None: zero ghosts."""
        if frozen is not None:
            b = b + (self.global_box_sum(frozen) - box_sum(frozen))
        for c in list(range(self.m)) + list(range(self.m - 1, -1, -1)):
            update = (b + (box_sum(xp) - xp)) / 26.0
            xp = torch.where(self.colors[c], update, xp)
        return xp


def vcycle(levels: List[PartsLevel], l: int, r: torch.Tensor) -> torch.Tensor:
    """levels[0] is the coarsest."""
    lev = levels[l]
    x = lev.smooth(torch.zeros_like(r), r)  # zero guess, zero ghosts
    if l == 0:
        return x
    res = r - lev.apply(x)  # fresh ghosts
    xc = vcycle(levels, l - 1, res[:, ::2, ::2, ::2].contiguous())
    e = torch.zeros_like(r)
    e[:, ::2, ::2, ::2] = xc
    x = x + e
    return lev.smooth(x, r, frozen=x)  # ghosts refreshed once, frozen through both sweeps


def hpcg_parts_set(local_grid: Sequence[int], parts_per_dir: Sequence[int], n_levels: int,
                   iterations: int, b: torch.Tensor):
    """(x, norms[iterations + 1]) of one set on ``parts_per_dir`` parts of
    ``local_grid``; b and x in the global box's C order, float64."""
    levels = [PartsLevel([int(n) >> l for n in local_grid], parts_per_dir, b.device, b.dtype)
              for l in range(n_levels)][::-1]
    fine = levels[-1]
    r = fine.split(b.reshape(tuple(p * n for p, n in zip(fine.parts, fine.local))))
    x = torch.zeros_like(r)
    norms = [torch.linalg.vector_norm(r)]
    z = vcycle(levels, n_levels - 1, r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iterations):
        Ap = fine.apply(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = vcycle(levels, n_levels - 1, r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        norms.append(torch.linalg.vector_norm(r))
    return fine.join(x).reshape(-1), torch.stack(norms)


def compare(config: dict, mix: dict, inputs: dict, outputs: dict, device) -> dict:
    b = inputs["rhs"][outputs["rhs_index"]].to(device=device, dtype=torch.float64)
    x_ref, n_ref = hpcg_parts_set(config["local_grid"], config["parts_per_dir"],
                                  int(config["levels"]), int(config["iterations_per_set"]), b)
    n = outputs["norms"].to(n_ref)
    x = outputs["x"].to(x_ref)
    return {
        "history_gap": float((n - n_ref).abs().max() / n_ref[0]),
        "x_gap": float(torch.linalg.vector_norm(x - x_ref) / torch.linalg.vector_norm(x_ref)),
        "values_bits_short": bits_short(config["dtype"], outputs["stored_dtypes"]),
    }
