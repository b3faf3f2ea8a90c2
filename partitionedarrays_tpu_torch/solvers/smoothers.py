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
sweeps: by the colored tier in its de-interleaved core
(``GaussSeidel.ghost_couple_core``, which alone decides whether a level
couples), by the tile tier in standard order (``ghost_contrib``).  An own
block that is a DIA band with a mod-m coloring takes the colored tier
(kernels K3, K4); any other takes the tile tier
(``solvers/gs_slot.py::NaturalTileGS``, kernel K6), built from the host
blocks, unless K6's packed planes would pass ``MAX_TILE_PACK_BYTES``: then
it takes the reference's tier 2, the sorted-by-color sweep
(``SortedColorGS``, :219-265, :294, :575-597), whose color steps run on
kernel K5.  The reference takes tier 2 where its TPU gates decline the tile
tier (``gs_slot.py:356-419``); the port's gate is its own, a budget of the
card's memory.  ``GaussSeidel(..., _sorted=True)`` forces tier 2 (tests and
``chip_smoke.py``).

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

from ..backends import stack_parts
from ..config import values_dtype as _values_dtype
from ..ops.blocks import freeze_block
from ..ops.ell import ell_spmv, stack_ell
from ..ops.ghost_spmv import ghost_spmv
from ..ops.native import greedy_coloring_native, ilu0
from ..ops.tile_gs import TILE
from ..parallel.exchange_plan import core_slot
from ..psparse import (PSparseMatrix, _agree_max_i32, _agreed_ell_groups, dense_diag, host_blocks,
                       spmv)
from ..pvector import PVector, _own_mask
from ..utils.profiling import span
from .gs_dia import ColoredDIAGS, find_mod_coloring
from .gs_slot import NaturalTileGS

# The tile tier's budget: K6's packed inverse planes (one 128 x 128 plane
# per tile and direction, 128 KiB a plane in float64) of all the parts.
# Beyond it the smoother takes the sorted-by-color tier, which stores only
# the entries (its planes are the block's ELL rows).  A fifth of the card's
# 80 GB, so that the hierarchy's matrices, the other levels and the solver's
# vectors keep the rest: the planes hold 2 x 128 values a row against the
# operator's ~81 (3-D elasticity), so the tile tier stops at about 8 * 10^6
# rows of one level in float64.
MAX_TILE_PACK_BYTES = 16 << 30


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


def tile_pack_bytes(A: PSparseMatrix, directions: int = 2) -> int:
    """The bytes of K6's packed planes for A's own-own blocks: a plane of
    TILE x TILE values per tile and direction, for every part (the same
    on every process)."""
    nt = -(-A.row_layout().n_own_pad // TILE)
    return A.row_prange.n_parts * nt * directions * TILE * TILE * A.dtype.itemsize


class SortedColorGS:
    """The reference's tier 2: Gauss-Seidel sorted by color.  Each part's
    own-own block is greedily colored; a sweep visits the colors in order
    (reversed backward), and a color step updates its rows at once from
    the current x: ``x_r += (b_r - A_oo[r] x - A_oh[r] g) / a_rr``.

    Per color c the state is the reference's six arrays (``tabs[c]``):
    ``rows[P, nc]`` (the color's rows of each part, padding ``n_own_pad``), the
    ELL planes ``oo_cols``, ``oo_vals`` of its rows of A_oo and ``oh_cols``,
    ``oh_vals`` of A_oh (``ops/ell.py``), and ``invd[P, nc]`` (0 on the
    padding).  The same rows freeze as compressed-row operands of kernel K5
    (``blocks[c]``: the A_oo and A_oh slices), which a sweep launches: one
    K5 a color, two where the color's rows have ghost columns.  The gather
    of x and b at the rows, the update and the scatter run in torch.
    ``sweep(..., plain=True)`` runs the same steps on the ELL planes
    through ``ell_spmv``, the plain version of the products.

    On several processes each one colors its own parts; the color count is
    agreed (the most of any process), so that every process runs the same
    steps."""

    def __init__(self, tabs, n_own_pad: int, n_ghost_pad: int, device, dtype, backend=None):
        """``tabs``: the six host arrays of each color (``build``, or the
        reference's ``GaussSeidel.color_tabs`` through ``convert.py``), the
        values cast to ``dtype`` on ``device``; ``backend``: the matrix's
        (on several processes K5's plans are agreed)."""
        self.n_own_pad, self.n_ghost_pad = int(n_own_pad), int(n_ghost_pad)
        self.n_colors = len(tabs)
        self.backend = backend
        self._set(tabs, device, dtype)

    @classmethod
    def build(cls, A: PSparseMatrix) -> "SortedColorGS":
        """From A's host blocks of this process's parts (the reference's
        :219-265, the colors agreed across processes)."""
        lay, clay = A.row_layout(), A.col_layout()
        return cls(_sorted_tabs(A), lay.n_own_pad, clay.n_ghost_pad, A.torch_device, A.dtype,
                   A.backend)

    def _set(self, tabs, device, dtype) -> None:
        self.tabs, self.blocks = [], []
        for rows, ooc, oov, ohc, ohv, invd in tabs:
            self.tabs.append(tuple(
                torch.from_numpy(np.array(a)).to(device, dt) for a, dt in (
                    (rows, torch.int64), (ooc, torch.int32), (oov, dtype), (ohc, torch.int32),
                    (ohv, dtype), (invd, dtype))))
            self.blocks.append(tuple(
                _ell_freeze(c, v, n_cols, device, dtype, self.backend)
                for c, v, n_cols in ((ooc, oov, self.n_own_pad), (ohc, ohv, self.n_ghost_pad))))

    def refresh(self, A: PSparseMatrix) -> None:
        """The state for new values of A, built anew in place, as the
        reference's ``refresh_values`` does (:267-291): the coloring is
        that of A + A^T's nonzero values, which new values may change."""
        tabs = _sorted_tabs(A)
        self.n_colors = len(tabs)
        self._set(tabs, self.tabs[0][0].device, A.dtype)

    def _step(self, x, b, g, c, plain: bool):
        """One color step on the padded x ``[P, n_own_pad + 1]`` (slot
        ``n_own_pad`` takes the padding rows' writes)."""
        rows, ooc, oov, ohc, ohv, invd = self.tabs[c]
        if plain:
            ax = ell_spmv(ooc, oov, x[:, : self.n_own_pad]) + ell_spmv(ohc, ohv, g)
        else:
            boo, boh = self.blocks[c]
            ax = boo.spmv(x) if boo is not None else x.new_zeros(rows.shape)
            if boh is not None and g.shape[1]:
                ax = boh.spmv_add(g, ax)
        xc = torch.gather(x, 1, rows)
        bc = torch.gather(b, 1, rows)
        # the row residual keeps the diagonal term: x_r + (b_r - (A x)_r) / a_rr
        x.scatter_(1, rows, xc + (bc - ax) * invd)

    def sweep(self, xo: torch.Tensor, g: torch.Tensor, bo: torch.Tensor, order,
              plain: bool = False) -> torch.Tensor:
        """One pass over the colors of ``order`` (the reference's
        ``_sweep_once``): own values xo ``[P, n_own_pad]``, the frozen ghost
        values g ``[P, n_ghost_pad]``, the rhs bo; returns the new xo.
        ``plain``: the products through ``ell_spmv`` instead of K5."""
        P = xo.shape[0]
        x = torch.cat([xo, xo.new_zeros((P, 1))], dim=1)
        b = torch.cat([bo, bo.new_zeros((P, 1))], dim=1)
        for c in order:
            self._step(x, b, g, c, plain)
        return x[:, : self.n_own_pad].contiguous()


def _sorted_tabs(A: PSparseMatrix) -> list:
    """The six host arrays of each color over this process's parts, the
    color count agreed by every process (the reference's :231-265)."""
    lay = A.row_layout()
    blocks = [host_blocks(A)[p] for p in A.backend.local_parts()]
    oo = [b["oo"].tocsr() for b in blocks]
    oh = [b["oh"].tocsr() for b in blocks]
    color_parts = [greedy_coloring(b) for b in oo]
    n_colors = int(max((int(c.max()) + 1 if c.size else 1 for c in color_parts), default=1))
    n_colors = int(_agree_max_i32(A.backend, [n_colors])[0])
    diag = stack_parts([b.diagonal() for b in oo], pad_to=lay.n_own_pad, fill=0.0)
    inv = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 0.0).astype(diag.dtype)
    P = len(blocks)
    tabs = []
    for c in range(n_colors):
        rows_pc = [np.flatnonzero(cp == c) for cp in color_parts]
        nc_pad = max(max((r.size for r in rows_pc), default=0), 1)
        row_tab = np.full((P, nc_pad), lay.n_own_pad, dtype=np.int32)  # a scatter's sink
        invd_c = np.zeros((P, nc_pad), dtype=inv.dtype)
        for p, r in enumerate(rows_pc):
            row_tab[p, : r.size] = r
            invd_c[p, : r.size] = inv[p, r]
        ooc, oov = stack_ell([m[r] for m, r in zip(oo, rows_pc)], nc_pad)
        ohc, ohv = stack_ell([m[r] for m, r in zip(oh, rows_pc)], nc_pad)
        tabs.append((row_tab, ooc, oov, ohc, ohv, invd_c))
    return tabs


def _ell_csrs(cols, vals, n_cols: int):
    """Per-part CSR blocks of stacked ELL planes ``[P, R, K]`` (the lanes
    with a column in range)."""
    cols, vals = np.asarray(cols), np.asarray(vals)
    out = []
    for c, v in zip(cols, vals):
        live = (c >= 0) & (c < n_cols)
        r = np.broadcast_to(np.arange(c.shape[0])[:, None], c.shape)[live]
        out.append(sp.csr_matrix((v[live], (r, c[live])), shape=(c.shape[0], n_cols)))
    return out


def _ell_freeze(cols, vals, n_cols: int, device, dtype, backend=None):
    """K5's compressed-row block of ELL planes, or None without entries.
    Explicit zeros of the planes stay entries, as in the ELL.  On several
    processes K5's plan is agreed, so every process freezes (collective)
    and then drops a block without entries."""
    if n_cols == 0:
        return None
    agree = _agreed_ell_groups(backend) if backend is not None and backend.is_multiprocess \
        else None
    blk = freeze_block(_ell_csrs(cols, vals, n_cols), np.asarray(cols).shape[1], n_cols,
                       device=device, prefer_dia=False, dtype=dtype, agree_lanes=agree)
    return blk if blk.vals.shape[1] else None


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
        _sorted=False,
    ):
        """``colored``: sweep state built elsewhere (``convert.py``);
        by default it is built from A's DIA values.  ``_sorted``: take the
        sorted-by-color tier whatever the block (True, or a
        ``SortedColorGS`` built elsewhere); the private hook of the tests
        and ``chip_smoke.py``.  ``values_dtype``:
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
        self.level = None  # the owning hierarchy's level, set by its builder
        self._core_rows = None  # core_rows(), built at first use
        self.colored = self.tile_gs = self.sorted = None
        oo = A.device().oo
        if _sorted is not False:
            if colored is not None:
                raise ValueError("GaussSeidel: a colored sweep state and the sorted tier")
            self.sorted = _sorted if isinstance(_sorted, SortedColorGS) else SortedColorGS.build(A)
            self.n_colors = self.sorted.n_colors
        elif oo.kind == "dia" and find_mod_coloring(oo.offsets) is not None:
            if colored is None:
                colored = ColoredDIAGS.from_device(
                    oo.offsets, oo.vals, _own_diagonal(A), _values_dtype(values_dtype)
                )
            colored.plan_parts = A.row_prange.n_parts
            self.colored = colored
            self.n_colors = colored.m
        elif colored is not None:
            raise ValueError("a colored sweep state for an own block without a DIA coloring")
        elif tile_pack_bytes(A) <= MAX_TILE_PACK_BYTES:
            self.tile_gs = NaturalTileGS.build(A)
            self.n_colors = 1
        else:
            self.sorted = SortedColorGS.build(A)
            self.n_colors = self.sorted.n_colors

    def refresh_values(self, A: PSparseMatrix) -> None:
        """The smoother for new values of a matrix of the same sparsity
        (the smoother leg of the AMG ``update``): the colored tier
        de-interleaves A's new DIA values and inverse diagonal (the
        coloring, K3's tap table and the values' storage dtype kept), the
        tile tier recomputes its
        packed inverse planes and off-tile values (``NaturalTileGS.refresh``:
        the schedule and K6's tables kept), the sorted tier builds its state
        anew (``SortedColorGS.refresh``).  A matrix that would select the
        other tier, or another band, raises."""
        oo = A.device().oo
        if self.sorted is not None:
            self.sorted.refresh(A)
            self.A, self.n_colors = A, self.sorted.n_colors
            return
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
        application.  One exchange and one own-ghost SpMV (K5).  A profiled
        call records the span ``ghost`` (attributes ``level``,
        ``layout="std"``)."""
        A = self.A
        clay = A.col_layout()
        with span("ghost", level=self.level, layout="std"):
            g = clay.consistent_plan.apply(
                x_own, x_own.new_zeros((x_own.shape[0], clay.n_ghost_pad)), "set", A.backend
            )
            return A.device().oh.spmv(g)

    def ghost_couple_core(self, xcore: Optional[torch.Tensor], ycore: torch.Tensor,
                          subtract: bool = False) -> torch.Tensor:
        """``ycore += A_oh @ consistent(x)`` (``-=`` with ``subtract``) in
        place, x and y cores ``[P, m, Lq]`` of the colored tier; returns
        ycore.  The ghost coupling of ``ghost_contrib`` without standard
        order: the exchange gathers the owners' values from the core
        (``ExchangePlan.apply(src_core=...)``) and K5 adds each row's sum
        into its core slot (``core_rows``), one rounding per row, so y ends
        as the standard-order composition's (a banded own-ghost block, as
        on small coarse parts, adds its de-interleaved product).  A profiled
        call records the span ``ghost`` (attributes ``level``,
        ``layout="core"``).

        The one place that decides whether the colored tier couples: where
        ``flat_viable()`` it returns ycore untouched (no launch, no exchange,
        no span).  ``xcore=None`` is the zero guess: a zero core is exchanged
        all the same, as the reference does."""
        if self.flat_viable():
            return ycore
        A = self.A
        clay = A.col_layout()
        oh = A.device().oh
        col = self.colored
        if xcore is None:
            xcore = torch.zeros_like(ycore)
        P = xcore.shape[0]
        with span("ghost", level=self.level, layout="core"):
            g = clay.consistent_plan.apply(xcore, xcore.new_zeros((P, clay.n_ghost_pad)), "set",
                                           A.backend, src_core=(col.m, col.Lq))
            if oh.kind != "ell":  # a banded own-ghost block (K1): add its core
                s = col.deinterleave(oh.spmv(g))
                return ycore.sub_(s) if subtract else ycore.add_(s)
            ghost_spmv(self.core_rows(), oh.cols, oh.vals, g, ycore.view(P, col.m * col.Lq),
                       oh.plan, subtract=subtract)
        return ycore

    def core_rows(self) -> torch.Tensor:
        """The own-ghost block's compressed rows in core slots (int32 [P,
        Nr], the padding rows kept at -1): K5's output rows when it writes
        into a core.  Built once: the sparsity is fixed, so a value refresh
        leaves it valid."""
        if self._core_rows is None:
            rows, col = self.A.device().oh.rows, self.colored
            self._core_rows = torch.where(rows >= 0, core_slot(rows, (col.m, col.Lq)),
                                          rows).to(torch.int32).contiguous()
        return self._core_rows

    def apply(self, x: PVector, b: PVector) -> PVector:
        """In-solver smoothing: improve x for ``A x = b``.  With ghost
        columns the ghost values are refreshed by one exchange per
        application, then all sweeps run in the core layout."""
        return self._apply(x, b, zero_guess=False)

    def _apply(self, x: PVector, b: PVector, zero_guess: bool) -> PVector:
        if self.sorted is not None:
            return self._apply_sorted(x, b)
        if self.tile_gs is not None:  # K6 sweeps in natural order: couple there
            bo = b.own if self.flat_viable() else b.own - self.ghost_contrib(x.own)
            xo = self.tile_gs.sweeps(None if zero_guess else x.own, bo, self._dir_seq())
            return PVector(xo, x.ghost, x.layout, x.backend)
        col = self.colored
        xc = None if zero_guess else col.deinterleave(x.own)
        bd = self.ghost_couple_core(xc, col.deinterleave(b.own), subtract=True)
        xc = col.sweeps_core(xc, bd, col.vals_d, col.invd_d, self._order_seq())
        return PVector(col.interleave_core(xc), x.ghost, x.layout, x.backend)

    def _apply_sorted(self, x: PVector, b: PVector, plain: bool = False) -> PVector:
        """The sorted tier (the reference's :575-597): with ghost columns the
        ghost values are refreshed by one exchange before each pass, and
        each pass is one ``SortedColorGS.sweep``.  ``plain``: the products
        through ``ell_spmv`` (the plain version, for comparisons)."""
        A = self.A
        clay = A.col_layout()
        fwd = list(range(self.n_colors))
        orders = {"forward": [fwd], "backward": [fwd[::-1]],
                  "symmetric": [fwd, fwd[::-1]]}[self.sweep]
        xo = x.own
        g = xo.new_zeros((xo.shape[0], clay.n_ghost_pad))
        for _ in range(self.iterations):
            for order in orders:
                if not self.flat_viable():
                    g = clay.consistent_plan.apply(xo, g, "set", A.backend)
                xo = self.sorted.sweep(xo, g, b.own, order, plain=plain)
        return PVector(xo, x.ghost, x.layout, x.backend)

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

    On a multi-process backend a process factors its own parts only; the
    other processes' placeholder parts get no factors (the reference's
    identity dense factors and zero ILU factors: ``_ilu0_factors`` keeps
    empty placeholder blocks, which ``NaturalTileGS`` never reads).  A part
    with no rows keeps identity padding in both tiers.  The reference falls back from ilu0 to dense
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
        blocks = [host_blocks(A)[p] for p in A.backend.local_parts()]
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
        local = set(A.backend.local_parts())
        for p, b in enumerate(host_blocks(A)):
            oo = b["oo"]
            none = sp.csr_matrix((oo.shape[0], 0), dtype=oo.dtype)
            if p in local:
                L, U = ilu0(oo)
            else:  # a part of another process: a placeholder
                L = U = sp.csr_matrix(oo.shape, dtype=oo.dtype)
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
        own = torch.where(_own_mask(r.layout, own.device, r.backend), own, torch.zeros_like(own))
        return PVector(own, torch.zeros_like(r.ghost), r.layout, r.backend)


def additive_schwarz(
    A: PSparseMatrix,
    local_solver: Optional[Callable] = None,
    mode: str = "auto",
    iterations: int = 1,
) -> AdditiveSchwarz:
    return AdditiveSchwarz(A, local_solver, mode, iterations)
