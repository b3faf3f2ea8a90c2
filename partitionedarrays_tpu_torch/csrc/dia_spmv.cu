// K1 and K2: DIA SpMV for Hopper (sm_90a).
//
// K1 replaces the TPU kernel partitionedarrays_tpu/ops/spmv_pallas.py::
// dia_spmv_pallas_flat (_dia_spmv_pallas_flat, body _dia_kernel_flat), the
// standard-order SpMV behind DeviceBlock.spmv.  It computes, for every part
// p and row i,
//
//     y[p, i] = sum_d vals[p, d, i] * x[p, i + off[d]]
//
// with x read as zero outside [0, n_cols).  Plain PyTorch version:
// ops/dia.py::dia_spmv_plain; wrapper: ops/dia_spmv.py::dia_spmv.
//
// K2 replaces partitionedarrays_tpu/ops/spmv_pallas.py::dia_spmv_pallas
// (_dia_spmv_pallas, body _dia_kernel), the same SpMV over one color's
// [n_off, Lq] values inside the colored Gauss-Seidel's de-interleaved core
// (ColoredDIAGS.sweep_flat):
//
//     y[p, i] = sum_d vals[p, d, i] * x[p, i + off[d]]
//
// with the values and x of part p read at a per-part stride: one color's
// values vals_d[:, c] are a [P, n_off, Lq] view whose parts lie
// m * n_off * Lq apart, so no copy of the color is made.  Wrapper:
// ops/dia_spmv.py::dia_spmv_strided; its plain version is dia_spmv_plain
// on the same views.
//
// Bound: device-memory bandwidth, as K1: every value once, x once, y once.
// At one color of the (2,2,2) x 64^3 level, [8, 27, 24,576] (m = 11), that
// is 31 MB, so a per-row loop with scalar loads spends as much time in its
// launch and tail as in streaming.  K2 runs the row engine of
// dia_rows.cuh that K3 shares: 16-byte value loads along i (a view that
// is not 16-byte aligned is refused), a chunk of taps in flight before its
// FMAs, the offsets in shared memory, 32-bit offsets inside a
// part, a grid (row tiles, parts), and G lanes per row group where rows
// are few (ops/dia_rows.py::row_lanes picks G).
//
// K1's bound: device-memory bandwidth.  The product does 2 flops per
// value and must read every value once (n_off * R words), x once and write
// y once; at the 27-point stencil the values are ~93% of the bytes.  The
// design keeps the traffic at that minimum:
//   - values are stored [.., n_off, R], so for each diagonal neighbouring
//     threads read neighbouring addresses (fully coalesced streams);
//   - x is read through the read-only path (__ldg).  The 27 taps of a warp
//     fall in at most 9 short runs of x that the L1/L2 caches serve, so
//     x costs about one pass from device memory;
//   - the offsets travel in the kernel's parameter block (no extra loads);
//   - a tap whose column falls outside [0, n_cols) is a masked load that
//     contributes 0: no zero-padded copy of x is made.
// One thread per output row, grid-stride loop; the sum runs over the
// diagonals in the order of the offsets, as the plain version's does.
//
// Narrow values.  K2 also reads values narrower than x and y, the
// reference's reduced-precision preconditioner values (ColoredDIAGS with
// values_dtype; its kernel promotes the output type,
// ops/spmv_pallas.py:74): bfloat16 or float16 values with float or double
// vectors, float values with double vectors, each value widened to the
// vector type exactly and summed in it (dia_rows.cuh).  K1 keeps one type: no path
// applies A through K1 with a smoother's stored values.  The port's
// V-cycle is flat on every level, so each level applies A_oo through K4
// on the core; the ghost contribution of a smoother (K5) reads A's full
// values, as the reference's does (solvers/smoothers.py:329-350); and the
// reference's narrow standard-order operators (devs_pc, models/hpcg/
// mg.py:90-93) feed only its generic V-cycle branch (mg.py:160-164),
// which no HPCG level reaches.  So K5 keeps one type too.

#include <climits>

#include <cuda_runtime.h>

#include "dia_rows.cuh"

namespace {

constexpr int kMaxDiags = 128;  // ops/dia.py::MAX_DIAGS
constexpr int kThreads = 256;

struct DiaOffsets {
  int n;
  int off[kMaxDiags];
};

// one output row: vp points at the row's value of diagonal 0, xp at the
// part's x
template <typename T>
__device__ __forceinline__ T dia_row(const T* __restrict__ vp,
                                     const T* __restrict__ xp,
                                     const DiaOffsets& offs, long long i,
                                     long long R, long long n_cols) {
  T acc = T(0);
  for (int d = 0; d < offs.n; ++d) {
    const long long j = i + offs.off[d];
    const T xv = (j >= 0 && j < n_cols) ? __ldg(xp + j) : T(0);
    acc += vp[d * R] * xv;
  }
  return acc;
}

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ vals,
                                const T* __restrict__ x, T* __restrict__ y,
                                const DiaOffsets offs, long long R,
                                long long n_cols, int P) {
  const long long total = (long long)P * R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long p = t / R;
    const long long i = t - p * R;
    y[t] = dia_row(vals + p * offs.n * R + i, x + p * n_cols, offs, i, R,
                   n_cols);
  }
}

// K2: the row engine over one tile of rows of part blockIdx.y; the values
// (type V) of part p start at p * vals_stride and its x at p * x_stride;
// y is [P, R] contiguous
template <typename V, typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
    dia_rows_strided_kernel(const V* __restrict__ vals, const T* x,
                            T* __restrict__ y, const DiaOffsets offs, int R,
                            int n_cols, long long vals_stride,
                            long long x_stride) {
  __shared__ int s_off[kMaxDiags];
  for (int d = threadIdx.x; d < offs.n; d += blockDim.x) s_off[d] = offs.off[d];
  __syncthreads();
  const long long p = blockIdx.y;
  vals += p * vals_stride;
  x += p * x_stride;
  y += p * R;
  const int total = (R / VEC) * G;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = t < total;
  const int i = (t / G) * VEC;
  const int g = t % G;
  T acc[VEC];
  if (on) {
    pat::rows_partial<V, T, VEC, G>(acc, vals, R, x, n_cols, s_off, offs.n, i, g);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = T(0);
  }
  pat::reduce_lanes<T, VEC, G>(acc);  // every lane of the warp takes part
  if (on && g == 0) pat::store(y + i, acc);
}

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // enough resident blocks for 132 SMs
  if (b > cap) b = cap;
  return b < 1 ? 1 : (int)b;
}

bool load_offsets(DiaOffsets* offs, const int* offsets, int n_off) {
  if (n_off < 0 || n_off > kMaxDiags) return false;
  offs->n = n_off;
  for (int d = 0; d < n_off; ++d) offs->off[d] = offsets[d];
  return true;
}

template <typename T>
int launch(const T* vals, const T* x, T* y, const int* offsets, int n_off,
           long long R, long long n_cols, int P, cudaStream_t stream) {
  DiaOffsets offs;
  if (!load_offsets(&offs, offsets, n_off)) return (int)cudaErrorInvalidValue;
  if ((long long)P * R > 0) {
    dia_spmv_kernel<T><<<blocks_for((long long)P * R), kThreads, 0, stream>>>(
        vals, x, y, offs, R, n_cols, P);
  }
  return (int)cudaGetLastError();
}

template <typename V, typename T, int G>
int launch_rows(const V* vals, const T* x, T* y, const DiaOffsets& offs, int R,
                int n_cols, int P, long long vals_stride, long long x_stride,
                cudaStream_t stream) {
  constexpr int VEC = pat::vec_of<T>();
  const int total = (R / VEC) * G;
  if (total > 0 && P > 0) {
    dia_rows_strided_kernel<V, T, VEC, G>
        <<<dim3((total + kThreads - 1) / kThreads, P), kThreads, 0, stream>>>(
            vals, x, y, offs, R, n_cols, vals_stride, x_stride);
  }
  return (int)cudaGetLastError();
}

template <typename V, typename T>
int launch_strided(const V* vals, const T* x, T* y, const int* offsets,
                   int n_off, long long R, long long n_cols, int P,
                   long long vals_stride, long long x_stride, int lanes,
                   cudaStream_t stream) {
  constexpr int VEC = pat::vec_of<T>();
  DiaOffsets offs;
  if (!load_offsets(&offs, offsets, n_off)) return (int)cudaErrorInvalidValue;
  if (R < 0 || n_cols < 0 || P < 0 || (long long)n_off * R > INT_MAX ||
      n_cols > INT_MAX || R * lanes > INT_MAX || R % VEC != 0 ||
      vals_stride % VEC != 0)
    return (int)cudaErrorInvalidValue;
#define PAT_K2_LANES(G)                                                      \
  case G:                                                                    \
    return launch_rows<V, T, G>(vals, x, y, offs, (int)R, (int)n_cols, P,    \
                                vals_stride, x_stride, stream);
  switch (lanes) {
    PAT_K2_LANES(1)
    PAT_K2_LANES(2)
    PAT_K2_LANES(4)
    PAT_K2_LANES(8)
    PAT_K2_LANES(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAT_K2_LANES
}

}  // namespace

// K2's C entries, one per (values, vectors) pair, named as gs_dia.cu's
#define PAT_K2_ENTRY(SUFFIX, V, T)                                            \
  int pat_dia_spmv_strided_##SUFFIX(                                          \
      const void* vals, const void* x, void* y, const int* offsets,           \
      int n_off, long long R, long long n_cols, int P, long long vals_stride, \
      long long x_stride, int lanes, void* stream) {                          \
    return launch_strided<V, T>((const V*)vals, (const T*)x, (T*)y, offsets,  \
                                n_off, R, n_cols, P, vals_stride, x_stride,   \
                                lanes, (cudaStream_t)stream);                 \
  }

extern "C" {

int pat_dia_spmv_f32(const void* vals, const void* x, void* y,
                     const int* offsets, int n_off, long long R,
                     long long n_cols, int P, void* stream) {
  return launch<float>((const float*)vals, (const float*)x, (float*)y,
                       offsets, n_off, R, n_cols, P, (cudaStream_t)stream);
}

int pat_dia_spmv_f64(const void* vals, const void* x, void* y,
                     const int* offsets, int n_off, long long R,
                     long long n_cols, int P, void* stream) {
  return launch<double>((const double*)vals, (const double*)x, (double*)y,
                        offsets, n_off, R, n_cols, P, (cudaStream_t)stream);
}

PAT_K2_ENTRY(f32, float, float)
PAT_K2_ENTRY(f64, double, double)
PAT_K2_ENTRY(bf16_f32, __nv_bfloat16, float)
PAT_K2_ENTRY(bf16_f64, __nv_bfloat16, double)
PAT_K2_ENTRY(f32_f64, float, double)
PAT_K2_ENTRY(f16_f32, __half, float)
PAT_K2_ENTRY(f16_f64, __half, double)

}  // extern "C"
