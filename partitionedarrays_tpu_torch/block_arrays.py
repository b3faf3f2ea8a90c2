"""Block-structured (multi-field) vectors and matrices over partitioned blocks.

Counterpart of ``partitionedarrays_tpu/block_arrays.py`` (the reference's
src/block_arrays.jl: ``BRange`` :2-52, ``BVector``/``BMatrix`` :54-140,
the forwarded accessors, ``consistent`` and ``assemble`` :142-174, the
reductions :201-337, the block product :393-411, and ``b_cg``, CG on a
block system, test/block_arrays_tests.jl:164-166).  Each block is a port
``PVector`` or ``PSparseMatrix`` and keeps its device: a block operation
fans out to the blocks and joins, and a block product is each block's own
``spmv``, so on the card it runs the blocks' kernels (K1 on DIA blocks, K5
on ghost blocks).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .parallel.partition import PRange
from .psparse import PSparseMatrix, spmv
from .pvector import (
    PVector,
    Task,
    assemble,
    axpy,
    collect,
    consistent,
    pall,
    pany,
    pdot,
    peuclidean,
    pfill,
    pmaximum,
    pminimum,
    psum_reduce,
    pzeros,
)


class BRange:
    """A concatenation of PRanges (reference ``BRange``)."""

    def __init__(self, blocks: Sequence[PRange]):
        self.blocks = list(blocks)

    @property
    def n_global(self) -> int:
        return sum(b.n_global for b in self.blocks)

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def blocklasts(self) -> List[int]:
        return [int(n) for n in np.cumsum([b.n_global for b in self.blocks])]

    def __len__(self) -> int:
        return self.n_global

    def __getitem__(self, i: int) -> PRange:
        return self.blocks[i]

    def __repr__(self) -> str:
        return f"BRange(1:{self.n_global}, blocklasts={self.blocklasts()})"


class BVector:
    """A vector of PVector blocks (reference ``BVector``); 0-based blocks."""

    def __init__(self, blocks: Sequence[PVector]):
        self.blocks = list(blocks)

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    # the BlockArrays interface's blocksize and blocklength
    @property
    def blocksize(self):
        return (len(self.blocks),)

    @property
    def blocklength(self) -> int:
        return len(self.blocks)

    @property
    def n_global(self) -> int:
        return sum(b.n_global for b in self.blocks)

    def __len__(self) -> int:
        return self.n_global

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def axes_brange(self) -> BRange:
        return BRange([b.layout.pr for b in self.blocks])

    def block(self, i: int) -> PVector:
        return self.blocks[i]

    def __getitem__(self, i: int) -> PVector:
        return self.blocks[i]

    def __repr__(self) -> str:
        return f"BVector({self.n_global} global, blocks={[b.n_global for b in self.blocks]})"

    # -- blockwise arithmetic ----------------------------------------------------
    def _map2(self, other: "BVector", f) -> "BVector":
        return BVector([f(a, b) for a, b in zip(self.blocks, other.blocks)])

    def __add__(self, o) -> "BVector":
        if np.isscalar(o):
            return BVector([b + o for b in self.blocks])
        return self._map2(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o) -> "BVector":
        if np.isscalar(o):
            return BVector([b - o for b in self.blocks])
        return self._map2(o, lambda a, b: a - b)

    def __rsub__(self, o) -> "BVector":
        return BVector([o - b for b in self.blocks])

    def __mul__(self, s) -> "BVector":
        return BVector([b * s for b in self.blocks])

    __rmul__ = __mul__

    def __truediv__(self, s) -> "BVector":
        return BVector([b / s for b in self.blocks])

    def __neg__(self) -> "BVector":
        return BVector([-b for b in self.blocks])

    def copy(self) -> "BVector":
        return BVector([b.copy() for b in self.blocks])

    def similar(self, dtype=None) -> "BVector":
        """The reference's ``similar``: the same layouts, zeros, on each
        block's device."""
        return BVector([pzeros(b.layout.pr, b.backend, dtype or b.dtype, device=b.own.device)
                        for b in self.blocks])

    def fill(self, value) -> "BVector":
        """The reference's ``fill!``, functional: a new BVector."""
        return BVector([pfill(value, b.layout.pr, b.backend, b.dtype, device=b.own.device)
                        for b in self.blocks])

    def own_values(self):
        return [b.own_values() for b in self.blocks]

    def ghost_values(self):
        return [b.ghost_values() for b in self.blocks]

    def local_values(self):
        return [b.local_values() for b in self.blocks]


def b_axpy(a, x: BVector, y: BVector) -> BVector:
    return BVector([axpy(a, xb, yb) for xb, yb in zip(x.blocks, y.blocks)])


def b_dot(x: BVector, y: BVector) -> torch.Tensor:
    """The sum of the blocks' dots, a 0-d tensor on their device."""
    return sum(pdot(a, b) for a, b in zip(x.blocks, y.blocks))


def b_norm(x: BVector) -> torch.Tensor:
    return torch.sqrt(b_dot(x, x))


def b_sum(x: BVector) -> torch.Tensor:
    return sum(psum_reduce(b) for b in x.blocks)


def b_maximum(x: BVector) -> float:
    return max(float(pmaximum(b)) for b in x.blocks)


def b_minimum(x: BVector) -> float:
    return min(float(pminimum(b)) for b in x.blocks)


def b_any(x: BVector, pred=lambda v: v != 0) -> bool:
    return any(pany(b, pred) for b in x.blocks)


def b_all(x: BVector, pred=lambda v: v != 0) -> bool:
    return all(pall(b, pred) for b in x.blocks)


def b_euclidean(x: BVector, y: BVector) -> torch.Tensor:
    """The reference's ``euclidean`` over the blocks."""
    return torch.sqrt(sum(peuclidean(a, b) ** 2 for a, b in zip(x.blocks, y.blocks)))


def b_consistent(x: BVector) -> Task:
    """Every block's ghosts from their owners, as one task."""
    return Task(BVector([consistent(b).wait() for b in x.blocks]))


def b_assemble(x: BVector) -> Task:
    return Task(BVector([assemble(b).wait() for b in x.blocks]))


def b_collect(x: BVector) -> np.ndarray:
    """The blocks' global vectors, one after the other, on the host."""
    return np.concatenate([collect(b) for b in x.blocks])


class BMatrix:
    """A grid of PSparseMatrix blocks, None a zero block (reference
    ``BMatrix`` and its block product)."""

    def __init__(self, blocks: Sequence[Sequence[Optional[PSparseMatrix]]]):
        self.blocks = [list(row) for row in blocks]

    @property
    def shape_blocks(self):
        return (len(self.blocks), len(self.blocks[0]))

    @property
    def blocksize(self):
        return self.shape_blocks

    def _row_block(self, i: int) -> PSparseMatrix:
        for A in self.blocks[i]:
            if A is not None:
                return A
        raise ValueError(f"BMatrix block-row {i} is all-None")

    def _col_block(self, j: int) -> PSparseMatrix:
        for row in self.blocks:
            if row[j] is not None:
                return row[j]
        raise ValueError(f"BMatrix block-col {j} is all-None")

    @property
    def shape(self):
        nr, nc = self.shape_blocks
        return (sum(self._row_block(i).shape[0] for i in range(nr)),
                sum(self._col_block(j).shape[1] for j in range(nc)))

    def row_brange(self) -> BRange:
        return BRange([self._row_block(i).row_prange for i in range(self.shape_blocks[0])])

    def col_brange(self) -> BRange:
        return BRange([self._col_block(j).col_prange for j in range(self.shape_blocks[1])])

    def nnz(self) -> int:
        return sum(A.nnz() for row in self.blocks for A in row if A is not None)

    def __repr__(self) -> str:
        return (f"BMatrix({self.shape[0]}x{self.shape[1]}, blocks={self.shape_blocks}, "
                f"nnz={self.nnz()})")

    def block(self, i: int, j: int) -> Optional[PSparseMatrix]:
        return self.blocks[i][j]

    def __getitem__(self, ij) -> Optional[PSparseMatrix]:
        i, j = ij
        return self.blocks[i][j]

    def _each(self, f):
        return [[f(A) if A is not None else None for A in row] for row in self.blocks]

    def own_own_values(self):
        return self._each(lambda A: A.own_own_values())

    def own_ghost_values(self):
        return self._each(lambda A: A.own_ghost_values())

    def ghost_own_values(self):
        return self._each(lambda A: A.ghost_own_values())

    def ghost_ghost_values(self):
        return self._each(lambda A: A.ghost_ghost_values())

    def copy(self) -> "BMatrix":
        return BMatrix(self._each(lambda A: A.copy()))

    # -- blockwise algebra -------------------------------------------------------
    def __mul__(self, s):
        if not np.isscalar(s):
            return NotImplemented
        return BMatrix(self._each(lambda A: A * s))

    __rmul__ = __mul__

    def __truediv__(self, s):
        return BMatrix(self._each(lambda A: A / s))

    def __neg__(self):
        return BMatrix(self._each(lambda A: -A))

    def __pos__(self):
        return self

    def _zip(self, other: "BMatrix", f) -> "BMatrix":
        out = []
        for ra, rb in zip(self.blocks, other.blocks):
            row = []
            for A, B in zip(ra, rb):
                if A is None and B is None:
                    row.append(None)
                elif A is None:
                    row.append(f(B * 0.0, B))
                elif B is None:
                    row.append(f(A, A * 0.0))
                else:
                    row.append(f(A, B))
            out.append(row)
        return BMatrix(out)

    def __add__(self, other):
        if not isinstance(other, BMatrix):
            return NotImplemented
        return self._zip(other, lambda A, B: A + B)

    def __sub__(self, other):
        if not isinstance(other, BMatrix):
            return NotImplemented
        return self._zip(other, lambda A, B: A - B)

    def mul(self, x: BVector) -> BVector:
        """``y_i = sum_j A_ij x_j``: each block's ``spmv`` (a vector on
        another layout of the block's column parts is re-homed there, with
        its ghosts from the exchange), the products of a block row added
        on the own values."""
        out = []
        for i, row in enumerate(self.blocks):
            acc = None
            for A, xb in zip(row, x.blocks):
                if A is None:
                    continue
                y = spmv(A, xb)
                acc = y if acc is None else PVector(acc.own + y.own, acc.ghost, acc.layout,
                                                    acc.backend)
            if acc is None:
                raise ValueError(f"BMatrix block-row {i} is all-None")
            out.append(acc)
        return BVector(out)


def b_mul(A: BMatrix, x: BVector) -> BVector:
    return A.mul(x)


def b_cg(A: BMatrix, b: BVector, x0: Optional[BVector] = None, rtol: float = 1e-6,
         maxiter: int = 1000):
    """CG on a block system (reference ``b_cg``: IterativeSolvers.cg on a
    BMatrix), a host loop over the blocks' products, dots and axpys on
    their device; it stops when ``|r| <= rtol |b|`` (the recurrence's
    residual) or after ``maxiter`` iterations.  Returns (x, iterations,
    the recurrence's relative residual)."""
    x = x0.copy() if x0 is not None else b * 0.0
    r = b - b_mul(A, x) if x0 is not None else b.copy()
    p = r.copy()
    rz = float(b_dot(r, r))
    bnorm = float(b_norm(b))
    if bnorm == 0.0:
        return x, 0, 0.0
    it = 0
    while it < maxiter and np.sqrt(rz) / bnorm > rtol:
        Ap = b_mul(A, p)
        alpha = rz / float(b_dot(p, Ap))
        x = b_axpy(alpha, p, x)
        r = b_axpy(-alpha, Ap, r)
        rz_new = float(b_dot(r, r))
        beta = rz_new / rz
        p = BVector([rb + beta * pb for rb, pb in zip(r.blocks, p.blocks)])
        rz = rz_new
        it += 1
    return x, it, float(np.sqrt(rz) / bnorm)
