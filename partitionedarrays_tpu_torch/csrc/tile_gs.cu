// K6: one wave step of the wave-scheduled tile Gauss-Seidel sweep, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel partitionedarrays_tpu/solvers/gs_slot.py::
// _wave_sweep_pallas (the sweep of NaturalTileGS, the Gauss-Seidel tier of
// an own block that is not a colorable DIA band: AMG's Galerkin levels).
// The rows of a part are cut into 128-row tiles; the tiles are packed into
// W waves of at most B tiles that no off-tile nonzero couples
// (solvers/gs_slot.py::_wave_schedule).  A sweep visits the waves in order
// (forward) or in reverse (backward) and, for each tile t of a wave, sets
//
//     x_t <- M_t (b_t - y_t - N_t x_t)
//
// where y_t is the off-tile coupling of the tile's rows against the live x,
// and forward M = (D + L)^-1, N = U, backward M = (D + U)^-1, N = L, with
// D, L, U the diagonal and strict triangles of the tile's 128 x 128 block.
// That is exact Gauss-Seidel in the wave-major row order (natural within a
// tile).  Tiles of one wave are mutually uncoupled, so the tiles of a launch
// never read each other's rows: reading the live x is exact, as the TPU's
// sequential grid made it there (gs_slot.py:612-617).  Waves are ordered by
// launching this kernel once per wave step, in order, on one stream.
//
// Layouts (all contiguous, P parts stacked first):
//   pack       [P, 2, nt, 128, 128]: per part, direction (0 forward, 1
//              backward) and tile, one packed plane F with F[q][r] the
//              entry (r, q) of M + N.  M and N are disjoint triangles: for
//              forward M holds q <= r and N q > r, for backward M holds
//              q >= r and N q < r.  This is the reference's storage, the
//              transposed factors (D+L)^-T + U^T and (D+U)^-T + L^T
//              (gs_slot.py:384-389): thread r reads F[q][r], so for each q
//              the 128 threads of a tile read 128 consecutive words.
//   rows       [P, Nr], cols [P, K, Nr], vals [P, K, Nr]: the off-tile
//              entries as compressed rows (the K5 layout of
//              ops/blocks.py::stack_rows), the rows ascending, so tile t's
//              compressed rows are tile_ptr[p, t] .. tile_ptr[p, t + 1] - 1
//              (at most 128); padding lanes hold column -1.
//   tile_ptr   [P, nt + 1]; wave_tiles [P, W, B], -1 on padding entries.
//   b, x       [P, Rp] with Rp = 128 nt; the rows past the block's own rows
//              have an identity diagonal and b = 0, so they stay 0.
//
// One CTA of 128 threads per tile of the wave, grid (B, P).  Thread r of
// tile t: (1) sums one compressed row of the tile's off-tile coupling into
// shared memory, (2) stages x_t in shared memory (not read from a zero
// guess, where x_t is still 0), (3) forms its rhs entry
// b - y - sum_{q in N} F[q][r] x_q, and after a barrier (4) writes
// x[r] = sum_{q in M} F[q][r] rhs_q.  Plain FMA loops in the working type,
// no tensor cores (no TF32).  Plain PyTorch version:
// ops/tile_gs.py::tile_gs_sweeps_plain; wrapper: ops/tile_gs.py::
// tile_gs_sweeps.
//
// Bound: device-memory bandwidth.  Per direction a sweep must read every
// tile's packed plane once (nt * 128^2 words: 8.5 MB in float32 at the
// 16,464-row level 1 of 40^3-node elasticity), the off-tile entries once
// (value and column: 18 MB there) and b and x, and write x: about 8 us at
// 3.35 TB/s.  This first version spends W launches per direction and runs
// B CTAs per launch (at most 8 of the 132 SMs busy), so it is launch- and
// latency-bound at these sizes; a persistent grid-synced version or a CUDA
// graph is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

template <typename T>
__global__ void __launch_bounds__(kTile)
    tile_gs_wave_kernel(const T* __restrict__ pack,
                        const int* __restrict__ rows,
                        const int* __restrict__ cols,
                        const T* __restrict__ vals,
                        const int* __restrict__ tile_ptr,
                        const int* __restrict__ wave_tiles,
                        const T* __restrict__ b, T* x, int w, int dir,
                        int zero_old, int nt, int B, int W, int Nr, int K,
                        long long Rp) {
  __shared__ T ys[kTile];
  __shared__ T xs[kTile];
  __shared__ T rs[kTile];
  const int p = blockIdx.y;
  const int r = threadIdx.x;
  const int t = wave_tiles[((long long)p * W + w) * B + blockIdx.x];
  if (t < 0) return;  // a padding entry of the wave: the whole CTA leaves
  const long long row0 = (long long)p * Rp + (long long)t * kTile;
  ys[r] = T(0);
  // x is written in this launch (other tiles' rows), so no __ldg
  xs[r] = zero_old ? T(0) : x[row0 + r];
  __syncthreads();

  // (1) off-tile coupling of one compressed row of the tile
  const int* tp = tile_ptr + (long long)p * (nt + 1);
  const int c = tp[t] + r;
  if (c < tp[t + 1]) {
    const long long base = (long long)p * Nr;
    const int* cp = cols + base * K + c;
    const T* vp = vals + base * K + c;
    const T* xp = x + (long long)p * Rp;
    T acc = T(0);
    for (int k = 0; k < K; ++k) {
      const int col = cp[(long long)k * Nr];
      if (col >= 0) acc += vp[(long long)k * Nr] * xp[col];
    }
    ys[rows[base + c] - t * kTile] = acc;
  }
  __syncthreads();

  // (3) rhs entry: b - y - N x_old (N x_old is 0 from a zero guess)
  const T* F =
      pack + (((long long)p * 2 + dir) * nt + t) * (kTile * kTile) + r;
  T acc = T(0);
  if (!zero_old) {
    for (int q = 0; q < kTile; ++q) {
      const bool coupling = dir == 0 ? q > r : q < r;
      if (coupling) acc += F[q * kTile] * xs[q];
    }
  }
  rs[r] = (b[row0 + r] - ys[r]) - acc;
  __syncthreads();

  // (4) the within-tile solve: x = M rhs
  acc = T(0);
  for (int q = 0; q < kTile; ++q) {
    const bool solve = dir == 0 ? q <= r : q >= r;
    if (solve) acc += F[q * kTile] * rs[q];
  }
  x[row0 + r] = acc;
}

template <typename T>
int launch(const T* pack, const int* rows, const int* cols, const T* vals,
           const int* tile_ptr, const int* wave_tiles, const T* b, T* x,
           int w, int dir, int zero_old, int nt, int B, int W, int Nr, int K,
           long long Rp, int P, cudaStream_t stream) {
  if (w < 0 || w >= W || (dir != 0 && dir != 1) || B < 1 || P < 1 ||
      P > 65535 || Rp != (long long)nt * kTile) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(B, P);
  tile_gs_wave_kernel<T><<<grid, kTile, 0, stream>>>(
      pack, rows, cols, vals, tile_ptr, wave_tiles, b, x, w, dir, zero_old,
      nt, B, W, Nr, K, Rp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pat_tile_gs_wave_f32(const void* pack, const void* rows, const void* cols,
                         const void* vals, const void* tile_ptr,
                         const void* wave_tiles, const void* b, void* x, int w,
                         int dir, int zero_old, int nt, int B, int W, int Nr,
                         int K, long long Rp, int P, void* stream) {
  return launch<float>((const float*)pack, (const int*)rows, (const int*)cols,
                       (const float*)vals, (const int*)tile_ptr,
                       (const int*)wave_tiles, (const float*)b, (float*)x, w,
                       dir, zero_old, nt, B, W, Nr, K, Rp, P,
                       (cudaStream_t)stream);
}

int pat_tile_gs_wave_f64(const void* pack, const void* rows, const void* cols,
                         const void* vals, const void* tile_ptr,
                         const void* wave_tiles, const void* b, void* x, int w,
                         int dir, int zero_old, int nt, int B, int W, int Nr,
                         int K, long long Rp, int P, void* stream) {
  return launch<double>((const double*)pack, (const int*)rows,
                        (const int*)cols, (const double*)vals,
                        (const int*)tile_ptr, (const int*)wave_tiles,
                        (const double*)b, (double*)x, w, dir, zero_old, nt, B,
                        W, Nr, K, Rp, P, (cudaStream_t)stream);
}

}  // extern "C"
