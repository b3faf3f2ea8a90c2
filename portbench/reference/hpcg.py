"""The plain reference of the HPCG configuration, in plain PyTorch.

It rebuilds from the configuration alone what the port derives: the
27-point operator on each level's box (26 on the diagonal, -1 to each
neighbour inside the box, zero Dirichlet outside), the levels (each half
the last in every direction, restriction by injection of the even points,
prolongation by its transpose), the symmetric Gauss-Seidel on each level
in HPCG's optimised ordering (rows colored by their index mod m, the
smallest m >= 2 that divides no neighbour offset; colors 0..m-1, then
m-1..0), the V-cycle (a zero-guess smoothing, the residual to the coarser
level, its correction, a smoothing; the coarsest level smooths only) and
``iterations`` PCG iterations from a zero guess.  It works on 3-D boxes
with shifted slices, and imports nothing of the program.  It runs one part
only: across parts the port's smoother is a block (hybrid) Gauss-Seidel,
another algorithm.

``compare`` judges the port's last set of the window: the gap of its
residual history, ``max_k |n_k - n_ref_k| / n_ref_0``, and of its x,
``|x - x_ref| / |x_ref|``; and ``values_bits_short``, the bits that the
narrowest type the port stores an operator or smoother value in lacks
against the configuration's precision (HPCG's 26 and -1 are exact in every
type, so a narrower store would leave the history and x as they are).
"""
from __future__ import annotations

from itertools import product
from typing import List, Sequence

import torch

from portbench.precision import bits_short

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def mod_coloring(shape: Sequence[int]) -> int:
    nx, ny, nz = shape
    offs = [dx * ny * nz + dy * nz + dz for dx, dy, dz in product((-1, 0, 1), repeat=3)
            if (dx, dy, dz) != (0, 0, 0)]
    for m in range(2, 513):
        if all(o % m for o in offs):
            return m
    raise ValueError(f"no mod-m coloring of the box {tuple(shape)}")


class Level:
    def __init__(self, shape: Sequence[int], device, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.m = mod_coloring(self.shape)
        color = torch.arange(self.shape[0] * self.shape[1] * self.shape[2],
                             device=device).reshape(self.shape) % self.m
        self.colors = [color == c for c in range(self.m)]
        self.padded = torch.zeros(tuple(s + 2 for s in self.shape), device=device, dtype=dtype)

    def box_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over each point's 3x3x3 neighbourhood inside the box."""
        p = self.padded
        p[1:-1, 1:-1, 1:-1] = x
        s = p[:-2] + p[1:-1] + p[2:]
        s = s[:, :-2] + s[:, 1:-1] + s[:, 2:]
        return s[:, :, :-2] + s[:, :, 1:-1] + s[:, :, 2:]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A x = 26 x - (the neighbours' sum)."""
        return 27.0 * x - self.box_sum(x)

    def smooth(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One symmetric Gauss-Seidel sweep: each color's rows take
        (b + their neighbours' sum) / 26, colors 0..m-1 then m-1..0."""
        for c in list(range(self.m)) + list(range(self.m - 1, -1, -1)):
            update = (b + (self.box_sum(x) - x)) / 26.0
            x = torch.where(self.colors[c], update, x)
        return x


def vcycle(levels: List[Level], l: int, r: torch.Tensor) -> torch.Tensor:
    """levels[0] is the coarsest."""
    lev = levels[l]
    x = lev.smooth(torch.zeros_like(r), r)
    if l == 0:
        return x
    res = r - lev.apply(x)
    xc = vcycle(levels, l - 1, res[::2, ::2, ::2].contiguous())
    e = torch.zeros_like(r)
    e[::2, ::2, ::2] = xc
    return lev.smooth(x + e, r)


def hpcg_set(local_grid: Sequence[int], n_levels: int, iterations: int, b: torch.Tensor):
    """(x, norms[iterations + 1]) of one set on the box ``local_grid``; b in
    C order, float64."""
    shapes = [tuple(int(n) >> l for n in local_grid) for l in range(n_levels)][::-1]
    levels = [Level(s, b.device, b.dtype) for s in shapes]
    fine = levels[-1]
    b = b.reshape(shapes[-1])
    x = torch.zeros_like(b)
    r = b.clone()
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
    return x.reshape(-1), torch.stack(norms)


def compare(config: dict, mix: dict, inputs: dict, outputs: dict, device) -> dict:
    if tuple(config["parts_per_dir"]) != (1, 1, 1):
        raise NotImplementedError("the HPCG reference runs one part")
    b = inputs["rhs"][outputs["rhs_index"]].to(device=device, dtype=torch.float64)
    x_ref, n_ref = hpcg_set(config["local_grid"], int(config["levels"]),
                            int(config["iterations_per_set"]), b)
    n = outputs["norms"].to(n_ref)
    x = outputs["x"].to(x_ref)
    return {
        "history_gap": float((n - n_ref).abs().max() / n_ref[0]),
        "x_gap": float(torch.linalg.vector_norm(x - x_ref) / torch.linalg.vector_norm(x_ref)),
        "values_bits_short": bits_short(config["dtype"], outputs["stored_dtypes"]),
    }
