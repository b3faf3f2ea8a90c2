"""Gauss-Seidel and additive Schwarz smoothing on partitioned matrices.

Counterpart of ``partitionedarrays_tpu/solvers/smoothers.py``:
``greedy_coloring`` and ``identity_solver`` (:33-58), ``JacobiCorrection``
and ``jacobi`` (:83-115), ``GaussSeidel`` with its
colored DIA tier (:123-204) and its tier 1, the wave-scheduled tile sweep
(:205-218, :537-571), ``refresh_values`` (:267-291), ``_order_seq``,
``ghost_contrib``, the flat-space methods (:313-461), ``apply``
(:463-535), ``__call__`` (:600-604) and ``gauss_seidel`` (:618), and
``AdditiveSchwarz`` with
``additive_schwarz`` (:622-811).  The
flat-space methods let the MG V-cycle keep x in the de-interleaved core
layout of ``solvers/gs_dia.py`` between smoothing steps; the names keep the
reference's "flat" although the state is the ``[P, m, Lq]`` core.

Across parts the smoother is the reference's hybrid "processor-block" GS:
the ghost values are frozen once per application (one consistent exchange)
and their contribution ``A_oh g`` is subtracted from the rhs before the
sweeps.  An own block that is a DIA band with a mod-m coloring takes the
colored tier (kernels K3, K4); any other takes the tile tier
(``solvers/gs_slot.py::NaturalTileGS``, kernel K6), built from the host
blocks.  The reference's tier 2, the sorted-by-color sweep, runs only where
its TPU gates decline the tile tier; the port has no such gates (ROADMAP
Queue 1 item 12).

``AdditiveSchwarz`` solves each part's own-own block alone and adds the
parts' corrections: with dense LU factors of the block (small parts) or
with its ILU(0) factors, applied as two exact triangular solves on K6 under
the level schedule (``NaturalTileGS.build(..., topo=True)``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..config import values_dtype as _values_dtype
from ..ops.native import greedy_coloring_native, ilu0
from ..psparse import PSparseMatrix, dense_diag, host_blocks, spmv
from ..pvector import PVector, _own_mask
from .gs_dia import ColoredDIAGS, find_mod_coloring
from .gs_slot import NaturalTileGS


def greedy_coloring(A: sp.spmatrix) -> np.ndarray:
    """Greedy coloring of the symmetrized adjacency of a local sparse
    matrix: a color per row (the native library; its plain version is
    ``ops/native.py::_greedy_coloring_python``)."""
    return greedy_coloring_native(A)


def identity_solver() -> Callable[[PVector], PVector]:
    """The reference's ``identity_solver`` (smoothers.jl:2-15): r itself."""
    return lambda r: r


def _own_diagonal(A: PSparseMatrix) -> torch.Tensor:
    """The diagonal of the own-own block, [P, n_own_pad], on its device (a
    non-banded block's from its host blocks, ``dense_diag``)."""
    oo = A.device().oo
    if oo.kind != "dia":
        return dense_diag(A).own
    if 0 not in oo.offsets:
        return torch.zeros_like(oo.vals[:, 0, :])
    return oo.vals[:, oo.offsets.index(0), :]


class JacobiCorrection:
    """dx = D^-1 r, with D the diagonal of the own-own block (zero where
    the diagonal is zero)."""

    def __init__(self, A: PSparseMatrix):
        d = _own_diagonal(A)
        self.inv_diag = torch.where(d != 0, 1.0 / torch.where(d != 0, d, torch.ones_like(d)),
                                    torch.zeros_like(d))
        self.layout = A.row_layout()
        self.backend = A.backend

    def __call__(self, r: PVector) -> PVector:
        return PVector(r.own * self.inv_diag, torch.zeros_like(r.ghost), r.layout, r.backend)


def jacobi(A, b, x, iterations: int = 1, omega: float = 1.0) -> PVector:
    """Damped Jacobi: ``richardson_iteration`` with ``JacobiCorrection``."""
    from .krylov import richardson_iteration

    return richardson_iteration(
        A, b, x, omega=omega, M=JacobiCorrection(A), iterations=iterations
    )


class GaussSeidel:
    """Gauss-Seidel smoother, ``sweep`` "forward", "backward" or
    "symmetric", ``iterations`` times per application.  Called on a vector
    it applies as a preconditioner from a zero initial guess."""

    def __init__(
        self,
        A: PSparseMatrix,
        iterations: int = 1,
        sweep: str = "symmetric",
        colored: ColoredDIAGS = None,
        values_dtype=None,
    ):
        """``colored``: sweep state built elsewhere (``convert.py``);
        by default it is built from A's DIA values.  ``values_dtype``:
        storage of the colored tier's streamed values narrower than A's
        (``torch.bfloat16`` or ``torch.float16``; ``torch.float32`` for a
        float64 A); the sweeps
        accumulate in A's dtype and only the smoother changes, not A.  The
        tile tier ignores it, as the reference's does."""
        if sweep not in ("forward", "backward", "symmetric"):
            raise ValueError(sweep)
        self.A = A
        self.iterations = iterations
        self.sweep = sweep
        self.colored = self.tile_gs = None
        oo = A.device().oo
        if oo.kind == "dia" and find_mod_coloring(oo.offsets) is not None:
            if colored is None:
                colored = ColoredDIAGS.from_device(
                    oo.offsets, oo.vals, _own_diagonal(A), _values_dtype(values_dtype)
                )
            self.colored = colored
            self.n_colors = colored.m
        elif colored is not None:
            raise ValueError("a colored sweep state for an own block without a DIA coloring")
        else:
            self.tile_gs = NaturalTileGS.build(A)
            self.n_colors = 1

    def refresh_values(self, A: PSparseMatrix) -> None:
        """The smoother for new values of a matrix of the same sparsity
        (the smoother leg of the AMG ``update``): the colored tier
        de-interleaves A's new DIA values and inverse diagonal (the
        coloring, K3's tap table and the values' storage dtype kept), the
        tile tier recomputes its
        packed inverse planes and off-tile values (``NaturalTileGS.refresh``:
        the schedule and K6's tables kept).  A matrix that would select the
        other tier, or another band, raises."""
        oo = A.device().oo
        colored = oo.kind == "dia" and find_mod_coloring(oo.offsets) is not None
        if colored != (self.colored is not None) or (
            colored and tuple(int(o) for o in oo.offsets) != self.colored.offsets
        ):
            raise ValueError(
                "refresh_values: the new matrix selects another smoother tier or band "
                "(sparsity changed?); build a new smoother instead"
            )
        self.A = A
        if self.colored is not None:
            self.colored.set_values(oo.vals, _own_diagonal(A))
        else:
            self.tile_gs.refresh(A)

    def _order_seq(self):
        fwd = list(range(self.n_colors))
        orders = {
            "forward": [fwd],
            "backward": [fwd[::-1]],
            "symmetric": [fwd, fwd[::-1]],
        }[self.sweep]
        return tuple(
            c for _ in range(self.iterations) for order in orders for c in order
        )

    def _dir_seq(self):
        """The tile tier's directions: "f"/"b" per pass, ``iterations``
        times."""
        one = {"forward": ("f",), "backward": ("b",), "symmetric": ("f", "b")}[self.sweep]
        return one * self.iterations

    def flat_viable(self) -> bool:
        """True when the flat pipeline needs no ghost exchange."""
        clay = self.A.col_layout()
        return not (clay.n_ghost_pad > 0 and clay.consistent_plan.n_rounds > 0)

    def ghost_contrib(self, x_own: torch.Tensor) -> torch.Tensor:
        """``A_oh @ consistent(x)`` in standard own order [P, n_own_pad]:
        the ghost-column contribution that the hybrid sweep freezes per
        application.  One exchange and one own-ghost SpMV (K5)."""
        A = self.A
        clay = A.col_layout()
        g = clay.consistent_plan.apply(
            x_own, x_own.new_zeros((clay.n_parts, clay.n_ghost_pad)), "set"
        )
        return A.device().oh.spmv(g)

    def apply(self, x: PVector, b: PVector) -> PVector:
        """In-solver smoothing: improve x for ``A x = b``.  With ghost
        columns the ghost values are refreshed by one exchange per
        application, then all sweeps run in the core layout."""
        return self._apply(x, b, zero_guess=False)

    def _apply(self, x: PVector, b: PVector, zero_guess: bool) -> PVector:
        col = self.colored
        bo = b.own
        if not self.flat_viable():
            bo = bo - self.ghost_contrib(x.own)
        if self.tile_gs is not None:
            xo = self.tile_gs.sweeps(None if zero_guess else x.own, bo, self._dir_seq())
            return PVector(xo, x.ghost, x.layout, x.backend)
        xc = None if zero_guess else col.deinterleave(x.own)
        xc = col.sweeps_core(xc, col.deinterleave(bo), col.vals_d, col.invd_d, self._order_seq())
        return PVector(col.interleave_core(xc), x.ghost, x.layout, x.backend)

    def __call__(self, r: PVector) -> PVector:
        """Preconditioner form: smooth ``A z = r`` from z = 0 and return z.
        With ghosts this still runs the exchange and the own-ghost SpMV on
        the zero guess, as the reference does."""
        z = PVector(torch.zeros_like(r.own), torch.zeros_like(r.ghost), r.layout, r.backend)
        return self._apply(z, r, zero_guess=True)

    # -- flat-space pipeline (colored path) ------------------------------
    def make_bd(self, b: PVector) -> torch.Tensor:
        """De-interleaved rhs [P, m, Lq]; reused by pre and post smoothing."""
        return self.flat_deinterleave(b.own)

    def smooth_bd(self, xflat, bd: torch.Tensor) -> torch.Tensor:
        """Sweeps on the core x; ``xflat=None`` means a zero guess."""
        col = self.colored
        return col.sweeps_core(xflat, bd, col.vals_d, col.invd_d, self._order_seq())

    def flat_residual(self, xflat: torch.Tensor, bd: torch.Tensor) -> torch.Tensor:
        """Level residual bd - A_oo x of the core x, as a core."""
        return bd - self.colored.ax_core(xflat, self.colored.vals_d)

    def flat_ax(self, xflat: torch.Tensor) -> torch.Tensor:
        """A_own_own @ x in the core layout: the A-apply of the flat CG.
        It reads the stored values, narrow ones too, as the reference's
        ``flat_ax`` does (``smoothers.py:403-416``), although the
        reference's MG docstring says the outer operator stays in the
        vectors' dtype: for HPCG's operator, the only one the MG builds,
        the two agree bit for bit, since 26 and -1 are exact in
        bfloat16 and float16."""
        return self.colored.ax_core(xflat, self.colored.vals_d)

    def flat_interleave(self, xflat: torch.Tensor) -> torch.Tensor:
        """Core -> standard own order [P, n_own_pad].  The reference's
        ``flat_interleave_core`` is the same map here: the core carries no
        margins."""
        return self.colored.interleave_core(xflat)

    def flat_deinterleave(self, own: torch.Tensor) -> torch.Tensor:
        """Standard own values [P, n_own_pad] -> core."""
        return self.colored.deinterleave(own)

    def flat_add_std(self, xflat: torch.Tensor, corr_own: torch.Tensor) -> torch.Tensor:
        """xflat + a standard-order correction, in the core layout."""
        return xflat + self.colored.deinterleave(corr_own)


def gauss_seidel(A: PSparseMatrix, iterations: int = 1, sweep: str = "symmetric") -> GaussSeidel:
    """The reference's constructor name (smoothers.py:618)."""
    return GaussSeidel(A, iterations, sweep)


class AdditiveSchwarz:
    """dx = sum_p R_p^T (A_p^own_own)^-1 R_p r: each part's own-own block
    solved alone (the reference's additive Schwarz, whose local solver is
    a per-part sparse LU).  The local solve, ``mode``:

    - "dense": batched dense LU factors of the blocks on A's device
      (``torch.linalg.lu_factor``; the padding rows are identity), one
      batched ``lu_solve`` an application: small parts only;
    - "ilu0": each block's ILU(0) factors (``ops/native.py::ilu0``, float64
      on the host, cast to A's dtype), applied as an exact forward solve
      with L and an exact backward solve with U, each one K6 launch on the
      level schedule (``sgsL``, ``sgsU``: ``NaturalTileGS`` of one
      direction each);
    - "auto": dense up to ``_DENSE_MAX`` padded rows a part, else ilu0;
    - a ``local_solver`` callable r -> z replaces both ("custom").

    A per-process matrix's placeholder parts (identity dense factors, zero
    ILU factors in the reference) do not arise: the port's parts are all
    real (ROADMAP Queue 1 item 15); a part with no rows keeps identity
    padding in both tiers.  The reference falls back from ilu0 to dense
    when its VMEM gates decline the factors on the slot engine
    (smoothers.py:717-727); the port has no such gates, so ilu0 always
    builds."""

    _DENSE_MAX = 1024

    def __init__(
        self,
        A: PSparseMatrix,
        local_solver: Optional[Callable] = None,
        mode: str = "auto",
        iterations: int = 1,
    ):
        if mode not in ("auto", "dense", "ilu0"):
            raise ValueError(f"mode must be auto/dense/ilu0, got {mode!r}")
        self.A = A
        self.iterations = int(iterations)
        self.local_solver = local_solver
        self.lu = self.piv = None
        self.sgsL = self.sgsU = None
        if local_solver is not None:
            self.mode = "custom"
            return
        self._requested = mode
        self.mode = self._tier(A, mode)
        if self.mode == "dense":
            self.lu, self.piv = self._dense_factors(A)
        else:
            L, U = self._ilu0_factors(A)
            self.sgsL = NaturalTileGS.build(L, topo=True, directions=("f",))
            self.sgsU = NaturalTileGS.build(U, topo=True, directions=("b",))

    def _tier(self, A: PSparseMatrix, mode: str) -> str:
        if mode == "auto":
            return "dense" if A.row_layout().n_own_pad <= self._DENSE_MAX else "ilu0"
        return mode

    @staticmethod
    def _dense_factors(A: PSparseMatrix):
        """The batched LU factors of the own-own blocks, each embedded in
        the identity of ``n_own_pad`` rows, on A's device in A's dtype."""
        n = A.row_layout().n_own_pad
        blocks = host_blocks(A)
        mats = np.zeros((len(blocks), n, n), dtype=blocks[0]["oo"].dtype)
        mats[:] = np.eye(n, dtype=mats.dtype)
        for d, b in zip(mats, blocks):
            k = b["oo"].shape[0]
            d[:k, :k] = b["oo"].toarray()
        return torch.linalg.lu_factor(torch.from_numpy(mats).to(A.torch_device, A.dtype))

    @staticmethod
    def _ilu0_factors(A: PSparseMatrix):
        """The matrices of the parts' ILU(0) factors (own-own blocks only,
        on A's row partition), host values in A's host dtype, frozen in
        A's device dtype."""
        Lb, Ub = [], []
        for b in host_blocks(A):
            oo = b["oo"]
            L, U = ilu0(oo)
            none = sp.csr_matrix((oo.shape[0], 0), dtype=oo.dtype)
            Lb.append({"oo": L.astype(oo.dtype), "oh": none})
            Ub.append({"oo": U.astype(oo.dtype), "oh": none})
        rows = A.row_prange
        return tuple(
            PSparseMatrix(None, rows, rows, A.backend, blocks=blocks, device=A.torch_device,
                          device_dtype=A.dtype)
            for blocks in (Lb, Ub)
        )

    def apply(self, x: PVector, b: PVector) -> PVector:
        """In-solver smoothing: ``iterations`` Schwarz corrections from the
        current iterate, x <- x + M (b - A x) each (the reference's
        Richardson over the local solve, so that it serves as an AMG level
        smoother).  ``spmv`` takes x and b on any layout of A's own parts."""
        for _ in range(self.iterations):
            z = self(spmv(self.A, x, alpha=-1.0, beta=1.0, y=b))
            x = PVector(x.own + z.own, x.ghost, x.layout, x.backend)
        return x

    def refresh_values(self, A: PSparseMatrix) -> None:
        """The local factors for new values of a matrix of the same
        sparsity (the smoother leg of the AMG ``update``): the dense tier
        refactors; the ilu0 tier refactors on the host and refreshes its
        two K6 operands (``NaturalTileGS.refresh``: the level schedule and
        K6's tables kept, where the reference reschedules).  A user
        ``local_solver`` is refreshed by its own ``refresh_values`` and
        raises without one; a matrix that selects another tier raises."""
        if self.mode == "custom":
            inner = getattr(self.local_solver, "refresh_values", None)
            if inner is None:
                raise ValueError(
                    "refresh_values: cannot refresh a user-supplied local_solver without its "
                    "own refresh_values; rebuild the AdditiveSchwarz instead"
                )
            inner(A)
            self.A = A
            return
        if self._tier(A, self._requested) != self.mode:
            raise ValueError(
                "refresh_values: the new matrix selects a different Schwarz tier; rebuild instead"
            )
        self.A = A
        if self.mode == "dense":
            self.lu, self.piv = self._dense_factors(A)
        else:
            L, U = self._ilu0_factors(A)
            self.sgsL.refresh(L)
            self.sgsU.refresh(U)

    def __call__(self, r: PVector) -> PVector:
        """The correction M r, zero on the padding."""
        if self.local_solver is not None:
            return self.local_solver(r)
        if self.mode == "dense":
            own = torch.linalg.lu_solve(self.lu, self.piv, r.own.unsqueeze(-1)).squeeze(-1)
        else:
            own = self.sgsU.sweeps(None, self.sgsL.sweeps(None, r.own, ("f",)), ("b",))
        own = torch.where(_own_mask(r.layout, own.device), own, torch.zeros_like(own))
        return PVector(own, torch.zeros_like(r.ghost), r.layout, r.backend)


def additive_schwarz(
    A: PSparseMatrix,
    local_solver: Optional[Callable] = None,
    mode: str = "auto",
    iterations: int = 1,
) -> AdditiveSchwarz:
    return AdditiveSchwarz(A, local_solver, mode, iterations)
