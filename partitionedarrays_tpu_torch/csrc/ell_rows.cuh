// The compressed-row engine shared by K5 (ghost_spmv.cu) and K6's off-tile
// step (tile_gs.cu).
//
// Both kernels sum, for compressed rows c of one part's ELL block,
//
//     acc[c] = sum_k vals[k * ld + c] * x[cols[k * ld + c]]
//
// over the live lanes k (cols >= 0).  The layout is ops/blocks.py::
// stack_rows': lanes column-major [K, ld] (ld = Nr, the compressed rows of
// a part), each row's live lanes a prefix of its K lanes in CSR order,
// padding lanes holding column -1 and value 0.
//
// The AMG path's blocks have few long rows (the 40^3 restriction P0^T:
// 16,464 rows of up to 375 lanes, mean 313; P1^T: 752 rows, mean 510),
// where one thread per row, walking up to the block's longest row with its
// padding, leaves the card nearly idle.  So:
//
//   - a group of 32 consecutive compressed rows is shared by G warps: warp
//     j of the group takes the lanes k = j, j + G, j + 2G, ...; the 32
//     threads of a warp read 32 consecutive rows at the same k, so the
//     column-major layout stays coalesced;
//   - a warp stops at its group's lane count (the longest live row of the
//     32, computed on the host once per block: ops/ell_rows.py), not at K;
//   - the lanes of a warp go in chunks of kEllChunk: every column and
//     value of a chunk is loaded before its x gathers, and every gather
//     before the FMAs, so a warp keeps a chunk's loads in flight instead
//     of one dependent load after another;
//   - each warp adds its lanes in increasing k; the caller adds the G
//     partial sums in shared memory in the fixed order j = 0 .. G-1 (no
//     atomics, a deterministic sum).
// G = 1 is one thread per row, for blocks of many short rows (the HPCG
// own-ghost block: 19 lanes).  The host rule that picks G is
// ops/ell_rows.py::warps_per_group.
//
// x is read through a policy: K5 reads it read-only (__ldg); K6 writes x in
// the same launch, so it reads through L2 only (__ldcg), never through the
// SM's L1, which is not coherent with the other SMs' writes.  Columns and
// values are read-only in both (__ldg).

#pragma once

#include <cuda_runtime.h>

namespace pat {

constexpr int kEllChunk = 8;  // lanes of one warp whose loads are in flight together

// x loaded read-only (x not written by the launch)
struct XReadOnly {
  template <typename T>
  __device__ __forceinline__ static T load(const T* p) { return __ldg(p); }
};

// x loaded from L2 (x written by other CTAs of the launch)
struct XCoherent {
  template <typename T>
  __device__ __forceinline__ static T load(const T* p) { return __ldcg(p); }
};

// Warp j's partial sum of compressed row c (of a part's block: cols, vals
// [K, ld]) over its lanes k = j, j + G, ... < nl, in increasing k, CH lanes
// a chunk.  x holds n_cols entries; a column outside [0, n_cols) (padding:
// -1) adds nothing.
template <typename T, typename XL, int CH = kEllChunk>
__device__ __forceinline__ T ell_row_partial(const int* __restrict__ cols,
                                             const T* __restrict__ vals,
                                             int ld, int c, const T* x,
                                             int n_cols, int j, int G, int nl) {
  T acc = T(0);
  for (int k0 = j; k0 < nl; k0 += G * CH) {
    int cc[CH];
    T vv[CH], xv[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int k = k0 + u * G;
      const bool live = k < nl;
      cc[u] = live ? __ldg(cols + k * ld + c) : -1;
      vv[u] = live ? __ldg(vals + k * ld + c) : T(0);
    }
#pragma unroll
    for (int u = 0; u < CH; ++u)
      xv[u] = (unsigned)cc[u] < (unsigned)n_cols ? XL::load(x + cc[u]) : T(0);
#pragma unroll
    for (int u = 0; u < CH; ++u) acc += vv[u] * xv[u];
  }
  return acc;
}

// The G partial sums of a row: red holds one per warp and lane
// (red[warp * 32 + lane]); the group's first warp is `first`.  Added in the
// fixed order j = 0 .. G-1.
template <typename T>
__device__ __forceinline__ T ell_group_sum(const T* red, int first, int G,
                                           int lane) {
  T s = T(0);
  for (int j = 0; j < G; ++j) s += red[(first + j) * 32 + lane];
  return s;
}

}  // namespace pat
