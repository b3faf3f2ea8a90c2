// K1: standard-order DIA SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel partitionedarrays_tpu/ops/spmv_pallas.py::
// dia_spmv_pallas_flat (_dia_spmv_pallas_flat, body _dia_kernel_flat).
// It computes, for every part p and row i,
//
//     y[p, i] = sum_d vals[p, d, i] * x[p, i + off[d]]
//
// with x read as zero outside [0, n_cols).  Plain PyTorch version:
// ops/dia.py::dia_spmv_plain; wrapper: ops/dia_spmv.py::dia_spmv.
//
// Bound: device-memory bandwidth.  The product does 2 flops per value and
// must read every value once (n_off * R words), x once and write y once;
// at the 27-point stencil the values are ~93% of the bytes.  The design
// keeps the traffic at that minimum:
//   - values are stored [P, n_off, R], so for each diagonal neighbouring
//     threads read neighbouring addresses (fully coalesced streams);
//   - x is read through the read-only path (__ldg).  The 27 taps of a warp
//     fall in at most 9 short runs of x that the L1/L2 caches serve, so
//     x costs about one pass from device memory;
//   - the offsets travel in the kernel's parameter block (no extra loads);
//   - a tap whose column falls outside [0, n_cols) is a masked load that
//     contributes 0: no zero-padded copy of x is made.
// One thread per output row, grid-stride loop; the sum runs over the
// diagonals in the order of the offsets, as the plain version's does.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 48;  // ops/dia.py::MAX_DIAGS
constexpr int kThreads = 256;

struct DiaOffsets {
  int n;
  int off[kMaxDiags];
};

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
    const T* vp = vals + p * offs.n * R + i;
    const T* xp = x + p * n_cols;
    T acc = T(0);
    for (int d = 0; d < offs.n; ++d) {
      const long long j = i + offs.off[d];
      const T xv = (j >= 0 && j < n_cols) ? __ldg(xp + j) : T(0);
      acc += vp[d * R] * xv;
    }
    y[t] = acc;
  }
}

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // enough resident blocks for 132 SMs
  if (b > cap) b = cap;
  return b < 1 ? 1 : (int)b;
}

template <typename T>
int launch(const T* vals, const T* x, T* y, const int* offsets, int n_off,
           long long R, long long n_cols, int P, cudaStream_t stream) {
  if (n_off < 0 || n_off > kMaxDiags) return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.n = n_off;
  for (int d = 0; d < n_off; ++d) offs.off[d] = offsets[d];
  if ((long long)P * R > 0) {
    dia_spmv_kernel<T><<<blocks_for((long long)P * R), kThreads, 0, stream>>>(
        vals, x, y, offs, R, n_cols, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

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

}  // extern "C"
