// K6: the wave-scheduled tile Gauss-Seidel sweep sequence, for Hopper
// (sm_90a).
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
// tile).  Tiles of one wave are mutually uncoupled, so the tiles of one
// wave step never read each other's rows: reading the live x is exact, as
// the TPU's sequential grid made it there (gs_slot.py:612-617).
//
// The same kernel runs the exact triangular solves of the ILU(0) Schwarz
// tier (solvers/smoothers.py::AdditiveSchwarz): with the level schedule
// (topo) every tile's off-tile neighbours of lower index lie in earlier
// waves, so a zero-guess forward sweep on the unit-lower factor L reads
// only rows that earlier steps finished (published to every CTA's copy of
// x before the cluster barrier that ends their step) and rows still at
// the zero guess that L does not couple: the forward substitution.  The
// reverse sweep on U is the backward one.  D = 1 there (one direction per
// factor).
//
// One launch runs a whole sequence of wave steps (every direction of a
// call), as the TPU's one pallas_call does.  The steps travel as a device
// int32 array, step s = w * 4 + zero_old * 2 + dir (ops/tile_gs.py::
// tile_steps): the wave, a flag that x_t is still the zero guess (the
// first direction of a zero-guess call skips the N x_old product), and the
// direction.
//
// Layouts (all contiguous, P parts stacked first):
//   pack       [P, D, nt, 128, 128]: per part, direction and tile, one
//              packed plane F with F[q][r] the entry (r, q) of M + N.  M
//              and N are disjoint triangles: for forward M holds q <= r and
//              N q > r, for backward M holds q >= r and N q < r (the
//              reference's transposed storage, gs_slot.py:384-389).  D = 2
//              holds both directions (plane 0 forward, 1 backward); D = 1
//              one direction's planes, read by every step of the call
//              whatever its direction (the reference's slab 0 of a
//              one-direction pack, gs_slot.py:513-515).  The direction of
//              a step, which picks the triangles, comes from its step
//              entry, never from the plane index.
//   rows       [P, Nr], cols [P, K, Nr], vals [P, K, Nr]: the off-tile
//              entries as compressed rows (the K5 layout of
//              ops/blocks.py::stack_rows), the rows ascending, so tile t's
//              compressed rows are tile_ptr[p, t] .. tile_ptr[p, t + 1] - 1
//              (at most 128); padding lanes hold column -1.
//   tile_ptr   [P, nt + 1]; tile_lanes [P, nt]: the live lanes of each
//              tile's longest compressed row (ops/ell_rows.py);
//              wave_tiles [P, W, B], -1 on padding entries.
//   b, x       [P, Rp] with Rp = 128 nt; the rows past the block's own rows
//              have an identity diagonal and b = 0, so they stay 0.
//
// Bound: device-memory bandwidth.  Per direction a sweep must read every
// tile's packed plane once (nt * 128^2 words: 8.5 MB in float32 at the
// 16,464-row level 1 of 40^3-node elasticity), the off-tile entries once
// (value and column: 15 MB there) and b and x, and write x: about 10 us
// for a symmetric sweep at 3.35 TB/s.  A wave holds at most B = 8 tiles
// (the reference's schedule, which fixes the Gauss-Seidel order), so at
// most 8 SMs can work at once, and a level-1 sweep is 36 dependent steps:
// the time is the steps' latency, not the bytes.  Within a step the cost
// is the off-tile gathers: ~17,000 scattered loads of x for a level-1
// tile, which one SM's load path serves at about one a clock from L2
// (~9 us a step when x was read from L2: PERF.md, section 6).  The design:
//   - one persistent launch per sequence, grid (B, P), one thread-block
//     cluster of B CTAs per part (B <= 8, a portable size): CTA j takes
//     the j-th tile of each wave step of its part, and the hardware cluster
//     barrier orders the steps; parts never couple, so no grid-wide
//     barrier is needed (a cooperative grid with a grid barrier was built
//     and timed: as fast, and it cannot share shared memory);
//   - x of the part lives in every CTA's shared memory (66 KB in float32
//     at level 1; up to the card's 227 KB a CTA), so the off-tile gathers
//     are shared-memory loads; each step's new x_t goes into every CTA's
//     copy through distributed shared memory (the TPU's VMEM-resident x
//     plane, in Hopper's form) and to device memory.  A part whose x does
//     not fit reads x from L2 (__ldcg) instead, never through the read-only
//     path or the SM's L1, which are not coherent with the other SMs'
//     writes;
//   - 1024 threads per CTA: the off-tile step runs the compressed-row
//     engine of ell_rows.cuh with 8 warps on each group of 32 compressed
//     rows, stopping at the tile's lane count, 9 lanes of a warp in
//     flight at once; the two 128 x 128
//     triangular products run on 8 threads per row (16 columns each, held
//     in registers for both products), their partial sums added in shared
//     memory in a fixed order;
//   - each CTA looks its tiles up once per 256 steps (tile, compressed-row
//     range, lane count, direction and zero-guess flags into shared
//     memory), so no step starts with a chain of dependent loads; the
//     rows, b and (float32) the plane entries are loaded before the
//     off-tile step; an L2 prefetch of the next step's operands was timed
//     and bought nothing, even with the L2 flushed;
//   - plain FMAs in the working type, no tensor cores (the reference pins
//     full precision).
// A refused launch (a cluster over 8 CTAs, x forced into shared memory
// that it does not fit) returns its error code, which the wrapper raises;
// there is no per-wave-step fallback.  Plain PyTorch version:
// ops/tile_gs.py::tile_gs_sweeps_plain; wrapper: ops/tile_gs.py::
// tile_gs_sweeps.

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ell_rows.cuh"

namespace cg = cooperative_groups;

extern __shared__ __align__(16) unsigned char tile_smem[];

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupWarps = kWarps / (kTile / 32);  // warps per 32-row group
constexpr int kQGroups = kThreads / kTile;          // threads per row in the products
constexpr int kQ = kTile / kQGroups;                // plane columns per thread
constexpr int kSmallWords = kThreads + 3 * kTile;   // red, ys, rs, xt
constexpr int kMetaSteps = 256;  // steps whose tiles a CTA looks up at once
// off-tile lanes of a warp in flight at once: the 40^3 level 1's rows hold
// up to 144 lanes, 18 a warp, so two chunks of 9 (a chunk of 10 or more
// spills at 1024 threads)
constexpr int kOffTileChunk = 9;

// the hardware cluster barrier: arrive (release), wait (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// x in this CTA's shared memory: an ordinary load
struct XShared {
  template <typename T>
  __device__ __forceinline__ static T load(const T* p) { return *p; }
};

// The operands of one part.
template <typename T>
struct Part {
  const T* pack;
  const int* rows;
  const int* cols;
  const T* vals;
  const int* tile_ptr;
  const int* tile_lanes;
  const int* waves;  // [W, B]
  const T* b;
  T* x;
  int D;  // planes per tile: 2 (one per direction) or 1
};

// What a CTA's step reads of its tile: the tile (-1: none), its compressed
// rows c0 .. c1-1, and flags = lanes << 2 | zero_old << 1 | dir, looked
// up once per kMetaSteps steps (so a step starts with no dependent load
// of device memory).
struct Step {
  int t, c0, c1, flags;
};

// this thread's entries of the plane, F[q][r] for its kQ columns q (read
// once for both products)
template <typename T>
__device__ __forceinline__ void load_plane(T (&f)[kQ], const T* F, int q0) {
#pragma unroll
  for (int i = 0; i < kQ; ++i) f[i] = __ldg(F + (q0 + i) * kTile);
}

// One wave step of one tile t: x_t <- M (b_t - y_t - N x_t).  With
// X_SMEM the part's x lives in x_s (this CTA's copy), and unless this is
// the sequence's last step the new x_t is written into every CTA's copy
// of the cluster (B of them); else x is read from L2.  x_t is written to
// device memory either way.
template <typename T, bool X_SMEM>
__device__ __forceinline__ void tile_step(const Part<T>& pt, T* small, T* x_s, int Nr,
                                          int nt, int B, const Step& m, bool broadcast) {
  T* red = small;
  T* ys = red + kThreads;
  T* rs = ys + kTile;
  T* xt = rs + kTile;  // x_t's old values (x in L2)
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = m.t;
  const int dir = m.flags & 1;
  const bool zero_old = (m.flags >> 1) & 1;
  const int row0 = t * kTile;
  const int Rp = nt * kTile;
  // every load of device memory that x does not change is issued first
  const int grp = warp / kGroupWarps;
  const int j = warp % kGroupWarps;
  const int c = m.c0 + grp * 32 + lane;
  const bool on = c < m.c1;
  const int row = on && j == 0 ? __ldg(pt.rows + c) - row0 : 0;
  const int r = tid % kTile;
  const int q0 = (tid / kTile) * kQ;
  const int plane = pt.D == 2 ? dir : 0;
  const T* F = pt.pack + ((long long)plane * nt + t) * (kTile * kTile) + r;
  T f[kQ];
  if (sizeof(T) == 4) load_plane(f, F, q0);  // float64: after (1), for registers
  T bt = T(0);
  if (tid < kTile) {
    ys[tid] = T(0);
    if (!X_SMEM) xt[tid] = zero_old ? T(0) : __ldcg(pt.x + row0 + tid);
    bt = __ldg(pt.b + row0 + tid);
  }
  const T* x_old = X_SMEM ? x_s + row0 : xt;

  // (1) off-tile coupling against the live x: 8 warps per 32 compressed rows
  T acc = T(0);
  if (on) {
    const int nl = m.flags >> 2;
    if (X_SMEM) {
      acc = pat::ell_row_partial<T, XShared, kOffTileChunk>(pt.cols, pt.vals, Nr, c, x_s,
                                                            Rp, j, kGroupWarps, nl);
    } else {
      acc = pat::ell_row_partial<T, pat::XCoherent, kOffTileChunk>(pt.cols, pt.vals, Nr, c,
                                                                   pt.x, Rp, j, kGroupWarps,
                                                                   nl);
    }
  }
  if (sizeof(T) != 4) load_plane(f, F, q0);
  red[tid] = acc;
  __syncthreads();
  if (on && j == 0) ys[row] = pat::ell_group_sum(red, warp, kGroupWarps, lane);
  __syncthreads();

  // (2) rhs = b - y - N x_old (N x_old is 0 while x_t is the zero guess)
  acc = T(0);
  if (!zero_old) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int q = q0 + i;
      if (dir == 0 ? q > r : q < r) acc += f[i] * x_old[q];
    }
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < kTile) {
    T s = T(0);
#pragma unroll
    for (int g = 0; g < kQGroups; ++g) s += red[g * kTile + tid];
    rs[tid] = (bt - ys[tid]) - s;
  }
  __syncthreads();

  // (3) the within-tile solve: x_t = M rhs
  acc = T(0);
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int q = q0 + i;
    if (dir == 0 ? q <= r : q >= r) acc += f[i] * rs[q];
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < kTile) {
    T s = T(0);
#pragma unroll
    for (int g = 0; g < kQGroups; ++g) s += red[g * kTile + tid];
    __stcg(pt.x + row0 + tid, s);
    if (X_SMEM && broadcast) {
      // x_t into the copy of each CTA of the cluster (rank = blockIdx.x):
      // no CTA reads these rows in this step (the tiles of a wave do not
      // couple), and the barrier after the step publishes them
      cg::cluster_group cluster = cg::this_cluster();
      for (int rank = 0; rank < B; ++rank)
        cluster.map_shared_rank(x_s, (unsigned)rank)[row0 + tid] = s;
    }
  }
}

template <typename T, bool X_SMEM>
__global__ void __launch_bounds__(kThreads, 1)
    tile_sweeps_kernel(const T* __restrict__ pack, const int* __restrict__ rows,
                       const int* __restrict__ cols, const T* __restrict__ vals,
                       const int* __restrict__ tile_ptr,
                       const int* __restrict__ tile_lanes,
                       const int* __restrict__ wave_tiles,
                       const int* __restrict__ steps, int n_steps,
                       const T* __restrict__ b, T* x, int nt, int D, int B, int W,
                       int Nr, int K) {
  // shared memory: the step table, red/ys/rs/xt, and x (X_SMEM)
  Step* meta = reinterpret_cast<Step*>(tile_smem);
  T* small = reinterpret_cast<T*>(meta + kMetaSteps);
  T* x_s = small + kSmallWords;
  const long long p = blockIdx.y;
  const int Rp = nt * kTile;
  const Part<T> pt = {
      pack + p * D * nt * (long long)(kTile * kTile), rows + p * Nr,
      cols + p * K * (long long)Nr, vals + p * K * (long long)Nr,
      tile_ptr + p * (nt + 1), tile_lanes + p * nt, wave_tiles + p * W * (long long)B,
      b + p * Rp, x + p * Rp, D,
  };
  const int j = blockIdx.x;
  for (int s0 = 0; s0 < n_steps; s0 += kMetaSteps) {
    // this CTA's tile of each step of the block (a step of a loop's last
    // block ends with the barrier, so no thread still reads meta)
    if (threadIdx.x < kMetaSteps && s0 + threadIdx.x < n_steps) {
      const int st = __ldg(steps + s0 + threadIdx.x);
      const int t = __ldg(pt.waves + (st >> 2) * B + j);
      Step m = {t, 0, 0, st & 3};
      if (t >= 0) {
        m.c0 = __ldg(pt.tile_ptr + t);
        m.c1 = __ldg(pt.tile_ptr + t + 1);
        m.flags |= __ldg(pt.tile_lanes + t) << 2;
      }
      meta[threadIdx.x] = m;
    }
    if (X_SMEM && s0 == 0) {
      // every CTA's copy of x is loaded before any CTA writes into another's
      for (int i = threadIdx.x; i < Rp; i += kThreads) x_s[i] = __ldcg(pt.x + i);
      cluster_sync();
    } else {
      __syncthreads();
    }
    const int s1 = min(s0 + kMetaSteps, n_steps);
    for (int s = s0; s < s1; ++s) {
      const Step m = meta[s - s0];
      const bool last = s + 1 == n_steps;
      if (m.t >= 0) tile_step<T, X_SMEM>(pt, small, x_s, Nr, nt, B, m, !last);
      if (!last) cluster_sync();
    }
  }
}

int max_smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

template <typename T>
size_t smem_bytes(bool x_smem, int nt) {
  return sizeof(Step) * kMetaSteps + sizeof(T) * (kSmallWords + (x_smem ? (size_t)nt * kTile : 0));
}

template <typename T, bool X_SMEM>
int launch_x(const T* pack, const int* rows, const int* cols, const T* vals,
             const int* tile_ptr, const int* tile_lanes, const int* wave_tiles,
             const int* steps, int n_steps, const T* b, T* x, int nt, int D, int B,
             int W, int Nr, int K, int P, cudaStream_t stream) {
  auto kernel = tile_sweeps_kernel<T, X_SMEM>;
  const size_t smem = smem_bytes<T>(X_SMEM, nt);
  if (smem > (size_t)max_smem_optin()) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_optin());
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, P);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = B;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, pack, rows, cols, vals, tile_ptr, tile_lanes,
                                 wave_tiles, steps, n_steps, b, x, nt, D, B, W, Nr, K);
}

// x_smem: 1 keeps x in shared memory (refused if it does not fit), 0 reads
// it from L2, -1 picks shared memory where it fits
template <typename T>
int launch(const T* pack, const int* rows, const int* cols, const T* vals,
           const int* tile_ptr, const int* tile_lanes, const int* wave_tiles,
           const int* steps, int n_steps, const T* b, T* x, int nt, int D, int B, int W,
           int Nr, int K, int P, int x_smem, cudaStream_t stream) {
  int code = (int)cudaErrorInvalidValue;
  // B <= 8: one cluster of B CTAs per part, the portable cluster size
  if (n_steps >= 0 && nt >= 1 && (D == 1 || D == 2) && B >= 1 && B <= 8 && W >= 1 &&
      Nr >= 0 && K >= 0 &&
      P >= 1 && P <= 65535 && (long long)nt * kTile <= INT_MAX &&
      (long long)K * Nr <= INT_MAX) {
    if (x_smem < 0) x_smem = smem_bytes<T>(true, nt) <= (size_t)max_smem_optin();
    code = x_smem ? launch_x<T, true>(pack, rows, cols, vals, tile_ptr, tile_lanes,
                                      wave_tiles, steps, n_steps, b, x, nt, D, B, W, Nr,
                                      K, P, stream)
                  : launch_x<T, false>(pack, rows, cols, vals, tile_ptr, tile_lanes,
                                       wave_tiles, steps, n_steps, b, x, nt, D, B, W, Nr,
                                       K, P, stream);
  }
  // a refused launch must not leave its error behind for the next launch's
  // cudaGetLastError()
  if (code != (int)cudaSuccess) cudaGetLastError();
  return code;
}

}  // namespace

extern "C" {

int pat_tile_gs_sweeps_f32(const void* pack, const void* rows, const void* cols,
                           const void* vals, const void* tile_ptr,
                           const void* tile_lanes, const void* wave_tiles,
                           const void* steps, const void* b, void* x, int n_steps,
                           int nt, int D, int B, int W, int Nr, int K, int P,
                           int x_smem, void* stream) {
  return launch<float>((const float*)pack, (const int*)rows, (const int*)cols,
                       (const float*)vals, (const int*)tile_ptr, (const int*)tile_lanes,
                       (const int*)wave_tiles, (const int*)steps, n_steps,
                       (const float*)b, (float*)x, nt, D, B, W, Nr, K, P, x_smem,
                       (cudaStream_t)stream);
}

int pat_tile_gs_sweeps_f64(const void* pack, const void* rows, const void* cols,
                           const void* vals, const void* tile_ptr,
                           const void* tile_lanes, const void* wave_tiles,
                           const void* steps, const void* b, void* x, int n_steps,
                           int nt, int D, int B, int W, int Nr, int K, int P,
                           int x_smem, void* stream) {
  return launch<double>((const double*)pack, (const int*)rows, (const int*)cols,
                        (const double*)vals, (const int*)tile_ptr,
                        (const int*)tile_lanes, (const int*)wave_tiles,
                        (const int*)steps, n_steps, (const double*)b, (double*)x, nt, D,
                        B, W, Nr, K, P, x_smem, (cudaStream_t)stream);
}

}  // extern "C"
