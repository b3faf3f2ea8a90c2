// K5: SpMV of a non-banded block (the own-ghost block) for Hopper (sm_90a).
//
// Replaces the TPU kernel partitionedarrays_tpu/ops/slot_spmv.py::slot_spmv
// (_slot_spmv_pallas).  The block is stored as a compressed-row ELL that
// keeps only the rows with nonzeros: for part p, compressed row i is own row
// rows[p, i], and its lanes k hold column cols[p, k, i] and value
// vals[p, k, i].  The kernel computes, for every part p and lane-valid row,
//
//     y[p, rows[p, i]] += sum_k vals[p, k, i] * x[p, cols[p, k, i]]
//
// over the lanes with cols >= 0 (padding lanes carry col -1 and value 0;
// padding rows carry row -1 and are skipped).  Each own row appears at most
// once per part, so the += of one thread has no race; accumulating into
// y lets the caller fuse "A_oo x + A_oh g" into the K1 output with the same
// rounding as adding the two products (one sum per own row).  Plain PyTorch
// version: ops/ghost_spmv.py::ghost_spmv_plain; wrapper: ghost_spmv.
//
// The TPU kernel's slot format (128-lane windows, int8 lane indices, a
// one-hot routing matmul) exists because the TPU has no general gather; the
// GPU gathers natively, so only the computation is ported.
//
// Bound: at the HPCG own-ghost block the kernel is launch- and latency-
// bound.  At 64^3 per part on 8 parts it moves ~15 MB per call in float64
// (12,097 rows x 19 lanes x (8 B value + 4 B column) per part, plus the
// x gathers and the y updates), a few microseconds at device bandwidth,
// about the cost of a launch.  The layout keeps that traffic coalesced:
// lanes are stored column-major [K, Nr], so for each lane neighbouring
// threads read neighbouring values and columns; x (the ghost values, ~100 KB
// per part) is read through the read-only path (__ldg) and stays in L2.
// One thread per compressed row, grid (rows, parts).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void ghost_spmv_kernel(const int* __restrict__ rows,
                                  const int* __restrict__ cols,
                                  const T* __restrict__ vals,
                                  const T* __restrict__ x, T* __restrict__ y,
                                  int Nr, int K, long long n_cols,
                                  long long R) {
  const int p = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Nr) return;
  const long long base = (long long)p * Nr;
  const int row = rows[base + i];
  if (row < 0 || row >= R) return;
  const int* cp = cols + base * K + i;
  const T* vp = vals + base * K + i;
  const T* xp = x + (long long)p * n_cols;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int c = cp[(long long)k * Nr];
    if (c >= 0 && c < n_cols) acc += vp[(long long)k * Nr] * __ldg(xp + c);
  }
  T* yp = y + (long long)p * R + row;
  *yp = *yp + acc;
}

template <typename T>
int launch(const int* rows, const int* cols, const T* vals, const T* x, T* y,
           int Nr, int K, long long n_cols, long long R, int P,
           cudaStream_t stream) {
  if (Nr < 0 || K < 0 || P < 0 || P > 65535) return (int)cudaErrorInvalidValue;
  if (Nr > 0 && P > 0) {
    const dim3 grid((Nr + kThreads - 1) / kThreads, P);
    ghost_spmv_kernel<T><<<grid, kThreads, 0, stream>>>(rows, cols, vals, x, y,
                                                        Nr, K, n_cols, R);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pat_ghost_spmv_f32(const void* rows, const void* cols, const void* vals,
                       const void* x, void* y, int Nr, int K, long long n_cols,
                       long long R, int P, void* stream) {
  return launch<float>((const int*)rows, (const int*)cols, (const float*)vals,
                       (const float*)x, (float*)y, Nr, K, n_cols, R, P,
                       (cudaStream_t)stream);
}

int pat_ghost_spmv_f64(const void* rows, const void* cols, const void* vals,
                       const void* x, void* y, int Nr, int K, long long n_cols,
                       long long R, int P, void* stream) {
  return launch<double>((const int*)rows, (const int*)cols,
                        (const double*)vals, (const double*)x, (double*)y, Nr,
                        K, n_cols, R, P, (cudaStream_t)stream);
}

}  // extern "C"
