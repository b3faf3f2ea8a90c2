"""K6: the wave-scheduled tile Gauss-Seidel sweep, kernel wrapper and plain
version.

Replaces ``partitionedarrays_tpu/solvers/gs_slot.py::_wave_sweep_pallas``
(the sweep of ``NaturalTileGS``, ``solvers/gs_slot.py``).  The rows are cut
into 128-row tiles and the tiles packed into W waves of mutually uncoupled
tiles; each wave step sets, for every tile t of the wave,

    x_t <- M_t (b_t - y_t - N_t x_t)

with y_t the off-tile coupling against the live x and, forward,
M = (D+L)^-1, N = U, backward M = (D+U)^-1, N = L (waves reversed).  Under
the level schedule of a triangular factor (``NaturalTileGS.build(...,
topo=True)``) a zero-guess forward sweep is the exact forward substitution
and a backward sweep the exact backward one: the ILU(0) Schwarz tier.  The
operands (all with the part axis first):

- ``pack[P, D, nt, 128, 128]``: per direction and tile the packed plane
  ``F[q, r]`` = entry (r, q) of M + N (the reference's transposed storage);
  D = 2 holds forward then backward, D = 1 one direction's planes, which
  every step of the call reads (the reference's one-direction pack,
  ``gs_slot.py:513-515``); a step's direction always comes from
  ``dir_seq``;
- ``rows[P, Nr]``, ``cols[P, K, Nr]``, ``vals[P, K, Nr]``: the off-tile
  entries as compressed rows (the K5 layout), rows ascending;
- ``tile_ptr[P, nt + 1]``: tile t's compressed rows are
  ``tile_ptr[p, t] .. tile_ptr[p, t + 1] - 1``;
- ``wave_tiles[P, W, B]``: the tiles of each wave, -1 on padding entries;
- ``x``, ``b``: ``[P, 128 nt]``, x updated in place.

The CUDA kernel is ``csrc/tile_gs.cu``: ONE launch runs every wave step of
a call (every direction of ``dir_seq``), one thread-block cluster per part
with the cluster barrier between steps and x in shared memory, as the TPU's
one ``pallas_call`` does with x in VMEM; its source note says what bounds
it and how the design meets that.  The steps travel as a cached device int32 array
(``tile_steps``, ``steps_on``), each with its direction flag.  The off-tile
step runs the compressed-row engine K5 shares (``csrc/ell_rows.cuh``), up
to each tile's lane count (``ops/ell_rows.py::tile_lane_counts``, kept by
``NaturalTileGS``).  The TPU kernel's one-hot routing matmuls, int8 lanes,
block-diagonal wave matmuls and VMEM-resident x plane are TPU layouts and
are not carried over.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import _build
from .ell_rows import tile_lane_counts
from .ghost_spmv import ghost_spmv_plain

TILE = 128
_DTYPES = (torch.float32, torch.float64)
_DIRECTIONS = {"f": 0, "b": 1}


def tile_steps(W: int, dir_seq: Sequence[str], zero_guess: bool = False) -> Tuple[int, ...]:
    """K6's step sequence: for each direction of ``dir_seq`` its W wave
    steps in its order (forward w = 0 .. W-1, backward W-1 .. 0), each
    step ``w * 4 + zero_old * 2 + dir``: the wave, whether x is still the
    zero guess there (the first direction of a ``zero_guess`` call), and
    the direction (0 forward, 1 backward)."""
    steps = []
    for s, d in enumerate(dir_seq):
        zero_old = int(zero_guess and s == 0)
        order = range(W) if d == "f" else range(W - 1, -1, -1)
        steps += [w * 4 + zero_old * 2 + _DIRECTIONS[d] for w in order]
    return tuple(steps)


_steps: Dict[Tuple, torch.Tensor] = {}


def steps_on(W: int, dir_seq: Sequence[str], zero_guess: bool, device) -> torch.Tensor:
    """``tile_steps`` as an int32 array on ``device``, built once per
    sequence and device."""
    key = (W, tuple(dir_seq), bool(zero_guess), torch.device(device))
    t = _steps.get(key)
    if t is None:
        t = _steps[key] = torch.tensor(tile_steps(W, dir_seq, zero_guess), dtype=torch.int32,
                                       device=device)
    return t


def _masks(device):
    """Boolean [q, r] masks of the solve triangle M: forward q <= r,
    backward q >= r (N is the rest of the plane)."""
    q = torch.arange(TILE, device=device).unsqueeze(1)
    r = torch.arange(TILE, device=device).unsqueeze(0)
    return (q <= r, q >= r)


def tile_gs_sweeps_plain(
    pack, rows, cols, vals, tile_ptr, wave_tiles, x, b, dir_seq: Sequence[str],
    zero_guess: bool = False,
) -> torch.Tensor:
    """The sweeps of ``dir_seq`` ("f"/"b") on x in place, in plain torch,
    wave by wave as the kernel: the off-tile sums of the live x (K5's plain
    product over all rows; the wave's rows are read), then for the wave's
    tiles rhs = (b - y) - N^T-plane product with x_old and x = the M-plane
    product with rhs, as the reference's XLA twin (``gs_slot.py:611-640``).
    ``zero_guess`` is accepted for the kernel's signature: x_old is then
    zero, so the product with N adds zeros.  Returns x."""
    P, D, nt = pack.shape[:3]
    W = wave_tiles.shape[1]
    xt = x.view(P, nt, TILE)
    bt = b.view(P, nt, TILE)
    masks = _masks(pack.device)
    waves = wave_tiles.tolist()
    for d in dir_seq:
        di = _DIRECTIONS[d]
        order = range(W) if d == "f" else range(W - 1, -1, -1)
        for w in order:
            y = ghost_spmv_plain(rows, cols, vals, x, torch.zeros_like(x)).view(P, nt, TILE)
            for p in range(P):
                tiles = [t for t in waves[p][w] if t >= 0]
                if not tiles:
                    continue
                T = torch.tensor(tiles, device=x.device)
                F = pack[p, di if D == 2 else 0, T]  # [nb, q, r]
                M = torch.where(masks[di], F, torch.zeros_like(F))
                N = F - M
                contrib = torch.einsum("tq,tqr->tr", xt[p, T], N)
                rhs = (bt[p, T] - y[p, T]) - contrib
                xt[p, T] = torch.einsum("tq,tqr->tr", rhs, M)
    return x


def tile_gs_sweeps(
    pack, rows, cols, vals, tile_ptr, wave_tiles, x, b, dir_seq: Sequence[str],
    zero_guess: bool = False, tile_lanes: Optional[torch.Tensor] = None,
    _n_steps: Optional[int] = None, _x_in_smem: Optional[bool] = None,
) -> torch.Tensor:
    """K6.  Run the sweeps of ``dir_seq`` ("f" forward, "b" backward) on x
    in place and return it.  ``zero_guess``: x is 0 on entry, so the first
    direction's tiles skip the N x_old product.  ``tile_lanes``: int32
    ``[P, nt]``, ``ell_rows.tile_lane_counts(cols, tile_ptr)``
    (``NaturalTileGS.tile_lanes``); None computes it here, which copies the
    columns to the host.

    A CPU tensor goes to ``tile_gs_sweeps_plain``; a CUDA tensor goes to
    the kernel, one launch for the whole sequence, or the call raises.
    The kernel keeps x in shared memory where it fits (else reads it from
    L2).  ``_n_steps`` runs only the first wave steps of the sequence and
    ``_x_in_smem`` forces where x lives (True raises where it does not
    fit): private hooks for the GPU tests and ``chip_smoke.py``, which time
    a launch of 0 and 1 step and both places of x."""
    P, D, nt = pack.shape[:3]
    Nr = rows.shape[1]
    K = cols.shape[1]
    W, B = wave_tiles.shape[1:]
    if D not in (1, 2) or tuple(pack.shape[3:]) != (TILE, TILE):
        raise ValueError(f"tile_gs_sweeps: pack {tuple(pack.shape)}")
    if tuple(x.shape) != (P, nt * TILE) or tuple(b.shape) != (P, nt * TILE):
        raise ValueError(f"tile_gs_sweeps: x {tuple(x.shape)}, b {tuple(b.shape)} for {nt} tiles")
    if tuple(cols.shape) != (P, K, Nr) or tuple(vals.shape) != (P, K, Nr):
        raise ValueError(f"tile_gs_sweeps: cols {tuple(cols.shape)}, vals {tuple(vals.shape)}")
    if tuple(tile_ptr.shape) != (P, nt + 1) or wave_tiles.shape[0] != P:
        raise ValueError("tile_gs_sweeps: tile_ptr or wave_tiles do not match the parts")
    if any(d not in _DIRECTIONS for d in dir_seq):
        raise ValueError(f"tile_gs_sweeps: directions {dir_seq}")
    if not (pack.dtype == vals.dtype == x.dtype == b.dtype):
        raise TypeError(f"tile_gs_sweeps: {pack.dtype}, {vals.dtype}, {x.dtype}, {b.dtype}")
    tensors = (pack, rows, cols, vals, tile_ptr, wave_tiles, x, b)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tile_gs_sweeps: operands on {sorted(map(str, devices))}")
    if x.device.type == "cpu":
        return tile_gs_sweeps_plain(pack, rows, cols, vals, tile_ptr, wave_tiles, x, b,
                                    dir_seq, zero_guess)
    if x.device.type != "cuda":
        raise ValueError(f"tile_gs_sweeps: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"tile_gs_sweeps: no kernel for {x.dtype}")
    if any(t.dtype != torch.int32 for t in (rows, cols, tile_ptr, wave_tiles)):
        raise TypeError("tile_gs_sweeps: rows, cols, tile_ptr and wave_tiles must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tile_gs_sweeps: tensors must be contiguous")
    if K * Nr >= 2**31:
        raise ValueError(f"tile_gs_sweeps: a part's {K * Nr} off-tile lanes exceed int32 offsets")
    if tile_lanes is None:
        tile_lanes = torch.from_numpy(tile_lane_counts(cols, tile_ptr)).to(x.device)
    if tuple(tile_lanes.shape) != (P, nt) or tile_lanes.dtype != torch.int32 \
            or tile_lanes.device != x.device:
        raise ValueError(f"tile_gs_sweeps: tile_lanes {tuple(tile_lanes.shape)} for {nt} tiles")
    steps = steps_on(W, dir_seq, zero_guess, x.device)
    if _n_steps is not None:
        steps = steps[:_n_steps]
    # the C entry takes b before x
    code = _build.entry("pat_tile_gs_sweeps", x.dtype)(
        pack.data_ptr(), rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), tile_ptr.data_ptr(),
        tile_lanes.data_ptr(), wave_tiles.data_ptr(), steps.data_ptr(), b.data_ptr(),
        x.data_ptr(), steps.numel(), nt, D, B, W, Nr, K, P,
        -1 if _x_in_smem is None else int(_x_in_smem), _build.stream_of(x),
    )
    tile_gs_sweeps.launches += 1
    _build.check(code, "tile_gs_sweeps")
    return x


tile_gs_sweeps.launches = 0
