// K3 and K4: the colored DIA Gauss-Seidel kernels for Hopper (sm_90a).
//
// Both work on the de-interleaved ("core") layout of solvers/gs_dia.py:
// with m colors (color = row mod m), row m*i + c of the block lives at
// core[c, i], c in [0, m), i in [0, Lq).  Tap d of color c reads
// core_flat[tap[c][d] + i], where tap = schedule - Kp from
// ColoredDIAGS._plan; a read outside [0, m*Lq) is a masked load that gives
// 0.  The reference pads the core with Kp zero margins so that its aligned
// window loads stay in bounds (gs_dia.py:63-86, gs_pallas.py:132-142); a
// masked load gives the same sum without the padded copy.
//
// Layouts (all contiguous): vals [P, m, n_off, Lq]; x, bd, invd, out
// [P, m, Lq]; tap int32 [m, n_off] in device memory.
//
// Types: the values are V, everything else T.  Besides V = T (float,
// double) there are three narrow-value pairs, the reference's
// reduced-precision preconditioner values (partitionedarrays_tpu/solvers/
// gs_dia.py:111-199, widened at ops/gs_pallas.py:101-110 and :171-180):
// bfloat16 values with float or double vectors, float values with double
// vectors.  Each value is widened to T exactly before its FMA and the sums
// run in T (dia_rows.cuh), so narrow values change only the bytes read:
// bfloat16 values halve the bytes of the values, which are nine tenths of
// K3's and K4's at the 27-point stencil.  bd, invd and x stay in T.
//
// K4 ax_core replaces partitionedarrays_tpu/ops/gs_pallas.py::
// ax_core_pallas (body _ax_kernel, pallas_call :205):
//     out[p, c, i] = sum_d vals[p, c, d, i] * core[p, tap[c][d] + i]
// i.e. A_own_own @ x in the de-interleaved layout.  Plain version:
// ops/gs_dia_kernels.py::ax_core_plain; wrapper and launch plan:
// ops/gs_dia_kernels.py::ax_core, ops/dia_rows.py::ax_plan.
//
// K4's bound: device-memory bandwidth.  It does 2 flops a value and must
// read every value once, x once and write out once: at the 128^3 level
// ([1, 9, 27, 245,760]) 239 MB of float32 values and 17.7 MB of x and
// out, 0.0766 ms at 3.35 TB/s; with bfloat16 values 137 MB, 0.0409 ms.
// The values are 93% of the bytes (87% in bfloat16), so the design streams
// them at the engine's full load width and keeps everything else off the
// critical path.  K4 is K2 run over every color at once: color c's rows
// are the DIA product of vals[p, c] (taps tap[c]) over the whole core.  So
// it runs the row engine of dia_rows.cuh in ONE launch, grid (row tiles,
// m, P):
//   - each CTA takes one tile of rows of one color of one part; the
//     part's and the color's bases are added once, every offset inside a
//     part is 32-bit, and there is no division and no grid-stride loop;
//   - the engine's loads: VEC rows a thread (16 bytes of the vectors), each
//     tap's values one load (16 bytes, or 8 and 4 for narrow values), a
//     chunk of 4 taps in flight before its FMAs (kAxChunk: 8, as K2's and
//     K3's single lanes hold, takes 80-102 registers and was up to 1.36x
//     slower with narrow values);
//   - the color's row of the tap table in shared memory, loaded once per
//     CTA (lanes of a warp read different taps);
//   - G lanes per row group where rows are few (the coarse HPCG and box
//     AMG levels), their partial sums added by a butterfly; G comes from
//     ops/dia_rows.py::ax_plan, from the vectors' item size alone, so
//     narrow values sum in the full-value order;
//   - x is read by element through L1 (a tap's shift is rarely a whole
//     load), each read masked to [0, m*Lq); two aligned vector loads and a
//     shift per tap were slower at every level.
// Where it stands (NVIDIA H100 80GB HBM3, 700 W; device time,
// scripts/k4_ab.py and chip_smoke.py phase 3d): at the 128^3 level 0.095
// ms in float32 (80% of the bound), 0.053 ms with bfloat16 values (78%),
// 0.212 ms in float64 (72%).  What holds float64
// and the narrow values under float64 back is x: each x element is read
// 27 times, once per tap of a color, through L1 and L2, and the windows
// of one CTA's 27 taps rarely overlap, so L1 keeps little of it.  Timed
// alone (scripts/k4_ab.py --variants, which drop one or the other), the
// gather takes 0.061 ms in float64 and the value stream 0.167 ms (92% of
// the bound), and the two overlap only in part; with bfloat16 values the
// gather alone is as long as the whole kernel.  Holding x windows in
// shared memory across the colors of a row tile is the next design
// (ROADMAP Queue 2).
//
// K3 gs_seq replaces partitionedarrays_tpu/ops/gs_pallas.py::
// gs_sweep_pallas (body _kernel, pallas_call :286): a whole color sequence
//     x[p, c, i] += (bd[p, c, i] - sum_d vals[p, c, d, i] *
//                    x[p, tap[c][d] + i]) * invd[p, c, i],  c in steps
// in ONE launch, as the TPU runs it.  Plain version:
// ops/gs_dia_kernels.py::gs_sweeps_plain; wrapper and launch plan:
// ops/gs_dia_kernels.py::gs_sweeps, ops/dia_rows.py::sweep_plan.
//
// Why the sequence is race-free.  Within one step the writes go to the
// rows of color c only, each row by the thread that sums it.  m is chosen
// so that no nonzero offset is a multiple of m (gs_dia.py::
// find_mod_coloring), so for every nonzero offset the tap lands in another
// color's row: the only tap of a color-c row that reads a color-c value is
// the row's own diagonal, which that same thread then writes.  A tap whose
// index i + k runs past its row's end reads a neighbouring row of the
// core, which may be row c and may be written by another thread of this
// step; but such a tap multiplies a value that is exactly zero (a valid
// entry A[j, j+o] has j+o inside the block, which lands inside the target
// row's core, gs_dia.py:70-77), and the value it reads, old or new, is
// finite, so the product is exactly 0 either way.  Between steps a grid
// barrier orders the colors (a single launch over all colors without it
// would race and turn the sweep into a Jacobi-like smoother); what a
// thread loads between the barrier's arrive and wait is read-only.  x is
// written inside the launch, so it is read with ordinary coherent loads
// (never __ldg, never const __restrict__); values, bd, invd and taps take
// the read-only path.
//
// Bound: device-memory bandwidth.  A sequence of S steps must read each
// color's values once per step (S * n_off * Lq words per part; the
// table's one-read bound counts them once in all, which no design reaches
// short of holding all values on chip) and x, bd, invd through the
// caches.  The design:
//   - one launch per sequence: the 2m launches, the clone and the zeros of
//     the per-color version are gone.  Step 0 also sets up the output: it
//     copies the guess into the other colors' rows and runs the first
//     color reading the guess, or, from a zero guess, writes zeros there
//     and bd * invd into the first color (every tap of the first step reads
//     a zero);
//   - the row engine of dia_rows.cuh: 16-byte value loads along i, a chunk
//     of taps in flight before its FMAs, taps in shared memory, 32-bit
//     offsets inside a part (the part is blockIdx.y), G lanes per row
//     group where rows are few and taps many;
//   - a persistent cooperative launch (cudaLaunchKernelEx with the
//     cooperative attribute, so that a CUDA graph can capture it), grid
//     (CTAs per part, P) sized by ops/dia_rows.py::sweep_plan to one pass
//     over a step and capped at the CTAs that are co-resident, so a small
//     level gets a small grid;
//   - the grid barrier split in two (cooperative_groups' barrier_arrive /
//     barrier_wait): between them each thread loads what the next step
//     needs and x does not change, its first chunk of values, bd and invd,
//     so the barrier's latency hides those loads'.
// A step still costs about 2 us beyond its bytes (chip_smoke.py phase 3c
// times launches of 0, 1 and all steps: the barrier, then a round trip to
// L2 for x, the lanes' shuffles and the store), so the small levels (16^3:
// 18 steps over 1,024 rows per color) are bound by the steps' latency, not
// by bandwidth.  A cluster form that kept x in every CTA's shared memory
// (Hopper's form of the TPU's VMEM-resident x) and stepped with the
// hardware cluster barrier was no faster at 16^3 and slower at 32^3, the
// levels whose core fits, so it is not kept (PERF.md, section 6).
// A refused launch (more CTAs than are co-resident, a tap table over 48
// KB) returns its error code, which the wrapper raises; there is no
// per-color fallback.

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dia_rows.cuh"

namespace cg = cooperative_groups;

// K3's and K4's dynamic shared memory: the tap table (K4: one color's row)
extern __shared__ __align__(16) unsigned char gs_smem[];

namespace {

constexpr int kThreads = 256;  // K3 and K4; ops/dia_rows.py::THREADS
// K4's taps per lane in flight (ops/dia_rows.py::AX_CHUNK): with 4, not the
// 8 of K2's and K3's single lanes, a thread holds 47 to 63 registers, so more
// warps per SM keep loads in flight
constexpr int kAxChunk = 4;

// K4: one tile of rows of color c = blockIdx.y of part p = blockIdx.z,
// out[p, c, i] = sum_d vals[p, c, d, i] * x[p, tap[c][d] + i]; the threads
// take the (row group, lane) pairs t = group * G + lane
template <typename V, typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
    ax_core_rows_kernel(const V* __restrict__ vals, const T* __restrict__ x,
                        T* __restrict__ out, const int* __restrict__ tap,
                        int m, int n_off, int Lq) {
  int* s_tap = reinterpret_cast<int*>(gs_smem);
  const int c = blockIdx.y;
  for (int k = threadIdx.x; k < n_off; k += blockDim.x) s_tap[k] = __ldg(tap + c * n_off + k);
  __syncthreads();
  const long long p = blockIdx.z;
  const int core = m * Lq;
  vals += (p * m + c) * n_off * (long long)Lq;
  x += p * core;
  out += p * core + c * Lq;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = t < (Lq / VEC) * G;
  const int i = (t / G) * VEC;
  const int g = t % G;
  T acc[VEC];
  if (on) {
    pat::rows_partial<V, T, VEC, G, kAxChunk>(acc, vals, Lq, x, core, s_tap, n_off, i, g);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = T(0);
  }
  pat::reduce_lanes<T, VEC, G>(acc);  // every lane of the warp takes part
  if (on && g == 0) pat::store(out + i, acc);
}

// What a thread of a color step can load before x is ready, for the row
// group t0 + lane: the values of its first chunk of taps (widened to T)
// and, for the group's writer, bd and invd.
template <typename T, int VEC, int G>
struct StepLoads {
  T vv[pat::Chunk<G>::value][VEC];
  T b[VEC], di[VEC];
};

template <typename V, typename T, int VEC, int G>
__device__ __forceinline__ void step_loads(StepLoads<T, VEC, G>& pre,
                                           const V* __restrict__ vals,
                                           const T* __restrict__ bd,
                                           const T* __restrict__ invd, int c,
                                           int n_off, int Lq, int t0) {
  const int t = t0 + (threadIdx.x & 31);
  if (t < (Lq / VEC) * G) {
    const int i = (t / G) * VEC;
    const int g = t % G;
    pat::chunk_values<V, T, VEC, G>(pre.vv, vals + c * n_off * Lq, Lq, n_off, i, g);
    if (g == 0) {
      pat::load_ro(bd + c * Lq + i, pre.b);
      pat::load_ro(invd + c * Lq + i, pre.di);
    }
  }
}

// One color step of one part: rows i of color c, xw[c, i] = xr[c, i] +
// (bd[c, i] - sum_d vals[c, d, i] xr[tap[c][d] + i]) * invd[c, i].  The
// threads t_first + lane, + t_stride, ... take the (row group, lane)
// pairs t = group * G + lane; t_first is warp-aligned so that every lane
// of a warp runs the same iterations (the lanes' shuffles need the whole
// warp).  `pre` holds step_loads(t_first) on entry.
template <typename V, typename T, int VEC, int G>
__device__ __forceinline__ void color_step(
    const V* __restrict__ vals, const T* __restrict__ bd,
    const T* __restrict__ invd, const T* xr, T* xw, const int* taps, int c,
    int n_off, int Lq, int core, int t_first, int t_stride,
    StepLoads<T, VEC, G>& pre) {
  const V* vc = vals + c * n_off * Lq;
  const int* tc = taps + c * n_off;
  const int row = c * Lq;
  const int t_end = (Lq / VEC) * G;
  const int lane = threadIdx.x & 31;
  for (int t0 = t_first; t0 < t_end; t0 += t_stride) {
    if (t0 != t_first) step_loads<V, T, VEC, G>(pre, vals, bd, invd, c, n_off, Lq, t0);
    const int t = t0 + lane;
    const bool on = t < t_end;
    const int i = (t / G) * VEC;
    const int g = t % G;
    const bool writer = on && g == 0;
    T xo[VEC], acc[VEC];
    if (writer) pat::load_rw(xr + row + i, xo);
    if (on) {
      pat::rows_partial_from<V, T, VEC, G>(acc, pre.vv, vc, Lq, xr, core, tc, n_off, i, g);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = T(0);
    }
    pat::reduce_lanes<T, VEC, G>(acc);
    if (writer) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) xo[v] += (pre.b[v] - acc[v]) * pre.di[v];
      pat::store(xw + row + i, xo);
    }
  }
}

// K3: a persistent cooperative launch, grid (CTAs per part, P)
template <typename V, typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
    gs_seq_grid_kernel(const V* __restrict__ vals, const T* __restrict__ bd,
                       const T* __restrict__ invd, const T* __restrict__ x_in,
                       T* x, const int* __restrict__ tap,
                       const int* __restrict__ steps, int n_steps,
                       int zero_guess, int m, int n_off, int Lq) {
  int* s_tap = reinterpret_cast<int*>(gs_smem);
  for (int k = threadIdx.x; k < m * n_off; k += blockDim.x) s_tap[k] = __ldg(tap + k);
  __syncthreads();
  const int core = m * Lq;
  const long long p = blockIdx.y;
  vals += p * m * n_off * (long long)Lq;
  bd += p * core;
  invd += p * core;
  x += p * core;
  if (!zero_guess) x_in += p * core;
  const int t_stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int t_first = tid & ~31;
  const int nv = Lq / VEC;
  const int c0 = n_steps > 0 ? __ldg(steps) : -1;
  StepLoads<T, VEC, G> pre;

  // step 0: the other colors' rows take the guess (or zeros), then the
  // first color runs on the guess
  for (int c = 0; c < m; ++c) {
    if (c == c0) continue;
    for (int q = tid; q < nv; q += t_stride) {
      T v[VEC];
      if (zero_guess) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = T(0);
      } else {
        pat::load_ro(x_in + c * Lq + q * VEC, v);
      }
      pat::store(x + c * Lq + q * VEC, v);
    }
  }
  if (c0 >= 0) {
    if (zero_guess) {  // every tap of the first step reads a zero
      for (int q = tid; q < nv; q += t_stride) {
        T b[VEC], di[VEC];
        pat::load_ro(bd + c0 * Lq + q * VEC, b);
        pat::load_ro(invd + c0 * Lq + q * VEC, di);
#pragma unroll
        for (int k = 0; k < VEC; ++k) b[k] *= di[k];
        pat::store(x + c0 * Lq + q * VEC, b);
      }
    } else {
      step_loads<V, T, VEC, G>(pre, vals, bd, invd, c0, n_off, Lq, t_first);
      color_step<V, T, VEC, G>(vals, bd, invd, x_in, x, s_tap, c0, n_off, Lq, core,
                               t_first, t_stride, pre);
    }
  }
  // each barrier: arrive, load what does not depend on x (the next step's
  // first chunk of values, bd, invd) while the other CTAs arrive, wait
  cg::grid_group grid = cg::this_grid();
  for (int s = 1; s < n_steps; ++s) {
    const int c = __ldg(steps + s);
    cg::grid_group::arrival_token token = grid.barrier_arrive();
    step_loads<V, T, VEC, G>(pre, vals, bd, invd, c, n_off, Lq, t_first);
    grid.barrier_wait(static_cast<cg::grid_group::arrival_token&&>(token));
    color_step<V, T, VEC, G>(vals, bd, invd, x, x, s_tap, c, n_off, Lq, core, t_first,
                             t_stride, pre);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// co-resident CTAs per SM of one kernel, by dynamic shared memory size
// (each level of a hierarchy has its own tap table)
struct Occupancy {
  size_t smem[16];
  int per_sm[16];
  int n = 0;
};

template <typename K>
cudaError_t per_sm_of(K kernel, size_t smem, Occupancy* occ, int* per_sm) {
  for (int k = 0; k < occ->n; ++k) {
    if (occ->smem[k] == smem) {
      *per_sm = occ->per_sm[k];
      return cudaSuccess;
    }
  }
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess && occ->n < 16) {
    occ->smem[occ->n] = smem;
    occ->per_sm[occ->n++] = *per_sm;
  }
  return e;
}

// `width` CTAs per part wanted, capped at the co-resident count
template <typename V, typename T, int G>
int launch_seq(const V* vals, const T* bd, const T* invd, const T* x_in, T* x,
               const int* tap, const int* steps, int n_steps, int zero_guess,
               int width, int P, int m, int n_off, int Lq, cudaStream_t stream) {
  constexpr int VEC = pat::vec_of<T>();
  const size_t tap_bytes = (size_t)m * n_off * sizeof(int);
  if (tap_bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = gs_seq_grid_kernel<V, T, VEC, G>;
  static Occupancy occ;
  int per_sm = 0;
  const cudaError_t e = per_sm_of(kernel, tap_bytes, &occ, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const int cap = per_sm * sm_count() / P;  // CTAs per part that fit at once
  if (cap < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(width < 1 ? 1 : (width < cap ? width : cap), P);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = tap_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, vals, bd, invd, x_in, x, tap, steps,
                                 n_steps, zero_guess, m, n_off, Lq);
}

template <typename V, typename T>
int launch_gs(const V* vals, const T* bd, const T* invd, const T* x_in, T* x,
              const int* tap, const int* steps, int n_steps, int zero_guess,
              int lanes, int width, int P, int m, int n_off, int Lq,
              cudaStream_t stream) {
  constexpr int VEC = pat::vec_of<T>();
  if (P < 1 || m < 1 || n_off < 0 || Lq < VEC || Lq % VEC != 0 || n_steps < 0 ||
      (long long)m * n_off * Lq > INT_MAX || (long long)m * Lq > INT_MAX ||
      (long long)Lq * lanes > INT_MAX ||
      (!zero_guess && x_in == nullptr))
    return (int)cudaErrorInvalidValue;
#define PAT_GS_LANES(G)                                                        \
  case G:                                                                      \
    code = launch_seq<V, T, G>(vals, bd, invd, x_in, x, tap, steps, n_steps,   \
                               zero_guess, width, P, m, n_off, Lq, stream);   \
    break;
  int code = (int)cudaErrorInvalidValue;
  switch (lanes) {
    PAT_GS_LANES(1)
    PAT_GS_LANES(2)
    PAT_GS_LANES(4)
    PAT_GS_LANES(8)
    PAT_GS_LANES(16)
  }
  // a refused launch must not leave its error behind for the next launch's
  // cudaGetLastError()
  if (code != (int)cudaSuccess) cudaGetLastError();
  return code;
#undef PAT_GS_LANES
}

template <typename V, typename T, int G>
int launch_ax_rows(const V* vals, const T* x, T* out, const int* tap, int P,
                   int m, int n_off, int Lq, cudaStream_t stream) {
  constexpr int VEC = pat::vec_of<T>();
  const int tiles = ((Lq / VEC) * G + kThreads - 1) / kThreads;
  ax_core_rows_kernel<V, T, VEC, G>
      <<<dim3(tiles, m, P), kThreads, n_off * sizeof(int), stream>>>(vals, x, out, tap, m,
                                                                    n_off, Lq);
  return (int)cudaGetLastError();
}

template <typename V, typename T>
int launch_ax(const V* vals, const T* x, T* out, const int* tap, int P, int m,
              int n_off, long long Lq, int lanes, cudaStream_t stream) {
  constexpr int VEC = pat::vec_of<T>();
  if (P < 0 || m < 0 || n_off < 0 || Lq < 0 || Lq % VEC != 0 || P > 65535 || m > 65535 ||
      (long long)n_off * Lq > INT_MAX || (long long)m * Lq > INT_MAX ||
      Lq * lanes > INT_MAX || (size_t)n_off * sizeof(int) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if ((long long)P * m * Lq == 0) return (int)cudaSuccess;
#define PAT_AX_LANES(G)                                                      \
  case G:                                                                    \
    return launch_ax_rows<V, T, G>(vals, x, out, tap, P, m, n_off, (int)Lq,  \
                                   stream);
  switch (lanes) {
    PAT_AX_LANES(1)
    PAT_AX_LANES(2)
    PAT_AX_LANES(4)
    PAT_AX_LANES(8)
    PAT_AX_LANES(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAT_AX_LANES
}

}  // namespace

// The C entries, one per (values, vectors) pair: the suffix names the
// vector type alone where the values have it too (f32, f64), else the
// values' type and then the vectors' (bf16_f32, bf16_f64, f32_f64).
#define PAT_GS_ENTRIES(SUFFIX, V, T)                                          \
  int pat_ax_core_##SUFFIX(const void* vals, const void* x, void* out,        \
                           const void* tap, int P, int m, int n_off,          \
                           long long Lq, int lanes, void* stream) {           \
    return launch_ax<V, T>((const V*)vals, (const T*)x, (T*)out,              \
                           (const int*)tap, P, m, n_off, Lq, lanes,           \
                           (cudaStream_t)stream);                             \
  }                                                                           \
  int pat_gs_sweeps_##SUFFIX(const void* vals, const void* bd,                \
                             const void* invd, const void* x_in, void* x,     \
                             const void* tap, const void* steps, int n_steps, \
                             int zero_guess, int lanes, int width, int P,     \
                             int m, int n_off, int Lq, void* stream) {        \
    return launch_gs<V, T>((const V*)vals, (const T*)bd, (const T*)invd,      \
                           (const T*)x_in, (T*)x, (const int*)tap,            \
                           (const int*)steps, n_steps, zero_guess, lanes,     \
                           width, P, m, n_off, Lq, (cudaStream_t)stream);     \
  }

extern "C" {

PAT_GS_ENTRIES(f32, float, float)
PAT_GS_ENTRIES(f64, double, double)
PAT_GS_ENTRIES(bf16_f32, __nv_bfloat16, float)
PAT_GS_ENTRIES(bf16_f64, __nv_bfloat16, double)
PAT_GS_ENTRIES(f32_f64, float, double)

}  // extern "C"
