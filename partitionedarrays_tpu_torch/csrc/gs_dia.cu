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
// ax_core_pallas (body _ax_kernel):
//     out[p, c, i] = sum_d vals[p, c, d, i] * core[p, tap[c][d] + i]
// i.e. A_own_own @ x in the de-interleaved layout.  Plain version:
// ops/gs_dia_kernels.py::ax_core_plain.  One thread per output,
// grid-stride loop.
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

// K3's dynamic shared memory: the tap table
extern __shared__ __align__(16) unsigned char gs_smem[];

namespace {

constexpr int kThreads = 256;  // K3 and K4; ops/dia_rows.py::THREADS

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // enough resident blocks for 132 SMs
  if (b > cap) b = cap;
  return b < 1 ? 1 : (int)b;
}

template <typename V, typename T>
__global__ void ax_core_kernel(const V* __restrict__ vals,
                               const T* __restrict__ x, T* __restrict__ out,
                               const int* __restrict__ tap, int P, int m,
                               int n_off, long long Lq) {
  const long long core = (long long)m * Lq;
  const long long total = (long long)P * core;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long p = t / core;
    const long long r = t - p * core;
    const int c = (int)(r / Lq);
    const long long i = r - (long long)c * Lq;
    const V* vp = vals + ((p * m + c) * n_off) * Lq + i;
    const T* xp = x + p * core;
    const int* tc = tap + c * n_off;
    T acc = T(0);
    for (int d = 0; d < n_off; ++d) {
      const long long j = (long long)__ldg(tc + d) + i;
      const T xv = (j >= 0 && j < core) ? __ldg(xp + j) : T(0);
      acc += pat::widen<T>(vp[d * Lq]) * xv;
    }
    out[t] = acc;
  }
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

template <typename V, typename T>
int launch_ax(const V* vals, const T* x, T* out, const int* tap, int P, int m,
              int n_off, long long Lq, cudaStream_t stream) {
  const long long work = (long long)P * m * Lq;
  if (work > 0) {
    ax_core_kernel<V, T><<<blocks_for(work), kThreads, 0, stream>>>(
        vals, x, out, tap, P, m, n_off, Lq);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The C entries, one per (values, vectors) pair: the suffix names the
// vector type alone where the values have it too (f32, f64), else the
// values' type and then the vectors' (bf16_f32, bf16_f64, f32_f64).
#define PAT_GS_ENTRIES(SUFFIX, V, T)                                          \
  int pat_ax_core_##SUFFIX(const void* vals, const void* x, void* out,        \
                           const void* tap, int P, int m, int n_off,          \
                           long long Lq, void* stream) {                      \
    return launch_ax<V, T>((const V*)vals, (const T*)x, (T*)out,              \
                           (const int*)tap, P, m, n_off, Lq,                  \
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
