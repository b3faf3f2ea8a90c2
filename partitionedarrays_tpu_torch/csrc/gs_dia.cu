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
// K4 ax_core replaces partitionedarrays_tpu/ops/gs_pallas.py::
// ax_core_pallas (body _ax_kernel):
//     out[p, c, i] = sum_d vals[p, c, d, i] * core[p, tap[c][d] + i]
// i.e. A_own_own @ x in the de-interleaved layout.  Plain version:
// ops/gs_dia_kernels.py::ax_core_plain.
//
// K3 gs_color replaces partitionedarrays_tpu/ops/gs_pallas.py::
// gs_sweep_pallas (body _kernel) one color step at a time:
//     x[p, c, i] += (bd[p, c, i] - sum_d vals[p, c, d, i] *
//                    x[p, tap[c][d] + i]) * invd[p, c, i]
// in place.  The TPU runs a whole color sequence in one launch because its
// grid runs in order; here blocks run in no order, so the wrapper
// (ops/gs_dia_kernels.py::gs_sweeps) launches this kernel once per color
// step, in order, on one stream: 2m launches per symmetric sweep.  Plain
// version: ops/gs_dia_kernels.py::gs_sweeps_plain.
//
// Why one launch per color is race-free.  A launch writes only the rows of
// color c, one thread per row.  m is chosen so that no nonzero offset is a
// multiple of m (gs_dia.py::find_mod_coloring), so for every nonzero
// offset the tap lands in another color's row: the only tap of the color-c
// row that reads a color-c value is the thread's own diagonal, which that
// same thread then writes.  A tap whose index i + k runs past its row's end
// reads a neighbouring row of the core, which may be row c and may be
// written by another thread of this launch; but such a tap multiplies a
// value that is exactly zero (a valid entry A[j, j+o] has j+o inside the
// block, which lands inside the target row's core, gs_dia.py:70-77), and
// the value it reads, old or new, is finite, so the product is exactly 0
// either way.  x is therefore read with ordinary loads, not __ldg: part of
// it is written in the same launch.  A single launch over all colors would
// race and turn the sweep into a Jacobi-like smoother.
//
// Bound: device-memory bandwidth.  Each pass reads every value once
// (m * n_off * Lq words, ~93% of the bytes at the 27-point stencil), x
// once through the caches, and writes one core (K4) or one color row (K3).
// Values are stored so that for each (c, d) neighbouring threads read
// neighbouring addresses; one thread per output, grid-stride loop.  The
// per-launch cost of K3 matters on the small coarse levels and is left to
// a later persistent-kernel or CUDA-graph version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // enough resident blocks for 132 SMs
  if (b > cap) b = cap;
  return b < 1 ? 1 : (int)b;
}

template <typename T>
__global__ void ax_core_kernel(const T* __restrict__ vals,
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
    const T* vp = vals + ((p * m + c) * n_off) * Lq + i;
    const T* xp = x + p * core;
    const int* tc = tap + c * n_off;
    T acc = T(0);
    for (int d = 0; d < n_off; ++d) {
      const long long j = (long long)__ldg(tc + d) + i;
      const T xv = (j >= 0 && j < core) ? __ldg(xp + j) : T(0);
      acc += vp[d * Lq] * xv;
    }
    out[t] = acc;
  }
}

template <typename T>
__global__ void gs_color_kernel(const T* __restrict__ vals,
                                const T* __restrict__ bd,
                                const T* __restrict__ invd, T* x,
                                const int* __restrict__ tap, int c, int P,
                                int m, int n_off, long long Lq) {
  const long long core = (long long)m * Lq;
  const long long total = (long long)P * Lq;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long p = t / Lq;
    const long long i = t - p * Lq;
    const T* vp = vals + ((p * m + c) * n_off) * Lq + i;
    T* xp = x + p * core;
    const int* tc = tap + c * n_off;
    T acc = T(0);
    for (int d = 0; d < n_off; ++d) {
      const long long j = (long long)__ldg(tc + d) + i;
      const T xv = (j >= 0 && j < core) ? xp[j] : T(0);
      acc += vp[d * Lq] * xv;
    }
    const long long k = p * core + (long long)c * Lq + i;
    x[k] = x[k] + (bd[k] - acc) * invd[k];
  }
}

template <typename T>
int launch_ax(const T* vals, const T* x, T* out, const int* tap, int P, int m,
              int n_off, long long Lq, cudaStream_t stream) {
  const long long work = (long long)P * m * Lq;
  if (work > 0) {
    ax_core_kernel<T><<<blocks_for(work), kThreads, 0, stream>>>(
        vals, x, out, tap, P, m, n_off, Lq);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gs(const T* vals, const T* bd, const T* invd, T* x, const int* tap,
              int c, int P, int m, int n_off, long long Lq,
              cudaStream_t stream) {
  if (c < 0 || c >= m) return (int)cudaErrorInvalidValue;
  const long long work = (long long)P * Lq;
  if (work > 0) {
    gs_color_kernel<T><<<blocks_for(work), kThreads, 0, stream>>>(
        vals, bd, invd, x, tap, c, P, m, n_off, Lq);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pat_ax_core_f32(const void* vals, const void* x, void* out,
                    const void* tap, int P, int m, int n_off, long long Lq,
                    void* stream) {
  return launch_ax<float>((const float*)vals, (const float*)x, (float*)out,
                          (const int*)tap, P, m, n_off, Lq,
                          (cudaStream_t)stream);
}

int pat_ax_core_f64(const void* vals, const void* x, void* out,
                    const void* tap, int P, int m, int n_off, long long Lq,
                    void* stream) {
  return launch_ax<double>((const double*)vals, (const double*)x,
                           (double*)out, (const int*)tap, P, m, n_off, Lq,
                           (cudaStream_t)stream);
}

int pat_gs_color_f32(const void* vals, const void* bd, const void* invd,
                     void* x, const void* tap, int c, int P, int m, int n_off,
                     long long Lq, void* stream) {
  return launch_gs<float>((const float*)vals, (const float*)bd,
                          (const float*)invd, (float*)x, (const int*)tap, c, P,
                          m, n_off, Lq, (cudaStream_t)stream);
}

int pat_gs_color_f64(const void* vals, const void* bd, const void* invd,
                     void* x, const void* tap, int c, int P, int m, int n_off,
                     long long Lq, void* stream) {
  return launch_gs<double>((const double*)vals, (const double*)bd,
                           (const double*)invd, (double*)x, (const int*)tap, c,
                           P, m, n_off, Lq, (cudaStream_t)stream);
}

}  // extern "C"
