// K5: SpMV of a non-banded block for Hopper (sm_90a).
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
// once per part, and the row's one sum is added by one thread, so the +=
// has no race and needs no atomics; accumulating into y lets the caller
// fuse "A_oo x + A_oh g" into the K1 output with the same rounding as
// adding the two products.  The SUB instances (entries pat_ghost_spmv_sub_*)
// subtract the sum instead, y[p, rows[p, i]] -= sum: "b - A_oh g" in one
// rounding, as b minus a zero-filled product.  Plain PyTorch version:
// ops/ghost_spmv.py::ghost_spmv_plain; wrapper: ghost_spmv.
//
// The TPU kernel's slot format (128-lane windows, int8 lane indices, a
// one-hot routing matmul) exists because the TPU has no general gather; the
// GPU gathers natively, so only the computation is ported.
//
// Bound: device-memory bandwidth, each live lane's value and column read
// once, x gathered, y read and written once per live row.  The paths give
// two regimes:
//   - many short rows: the HPCG own-ghost block (8 parts x 12,104 rows x 19
//     lanes, ~5 us at 3.35 TB/s) and the 40^3 elasticity prolongator P0
//     (192,000 rows, at most 48 lanes);
//   - few long rows: the restrictions P0^T (16,464 rows, at most 375 lanes)
//     and P1^T (752 rows, mean 510 lanes) and the coarse operators A1, A2
//     (at most 162 lanes), where one thread walking a whole row (up to the
//     block's longest row, padding included) leaves the card nearly idle.
// The design is the compressed-row engine of ell_rows.cuh: G warps share a
// group of 32 consecutive rows and split its lanes, each warp stops at the
// group's own lane count (glanes, from the host), and loads go in chunks;
// the G partial sums meet in shared memory in a fixed order.  G comes from
// ops/ell_rows.py::warps_per_group; the CTA holds max(G, 8) warps, so a
// group never spans two CTAs.  Grid: (row groups / groups per CTA, parts).

#include <climits>

#include <cuda_runtime.h>

#include "ell_rows.cuh"

namespace {

template <int G>
struct Warps {  // warps per CTA
  static constexpr int value = G > 8 ? G : 8;
};

template <typename T, int G, bool SUB>
__global__ void __launch_bounds__(Warps<G>::value * 32)
    ghost_spmv_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                      const T* __restrict__ vals, const int* __restrict__ glanes,
                      const T* __restrict__ x, T* __restrict__ y, int Nr, int K,
                      int n_groups, int n_cols, int R) {
  constexpr int W = Warps<G>::value;
  const long long p = blockIdx.y;
  rows += p * Nr;
  cols += p * K * (long long)Nr;
  vals += p * K * (long long)Nr;
  x += p * n_cols;
  y += p * R;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = blockIdx.x * (W / G) + warp / G;
  const int j = warp % G;
  const int c = grp * 32 + lane;
  const bool on = grp < n_groups && c < Nr;
  T acc = T(0);
  if (on) {
    const int nl = __ldg(glanes + p * n_groups + grp);
    acc = pat::ell_row_partial<T, pat::XReadOnly>(cols, vals, Nr, c, x, n_cols, j, G, nl);
  }
  if constexpr (G == 1) {
    if (on) {
      const int row = __ldg(rows + c);
      if (row >= 0 && row < R) {
        if constexpr (SUB)
          y[row] -= acc;
        else
          y[row] += acc;
      }
    }
  } else {
    __shared__ T red[W * 32];
    red[threadIdx.x] = acc;
    __syncthreads();
    if (on && j == 0) {
      const T s = pat::ell_group_sum(red, warp, G, lane);
      const int row = __ldg(rows + c);
      if (row >= 0 && row < R) {
        if constexpr (SUB)
          y[row] -= s;
        else
          y[row] += s;
      }
    }
  }
}

template <typename T, int G, bool SUB>
void launch_g(const int* rows, const int* cols, const T* vals, const int* glanes,
              const T* x, T* y, int Nr, int K, int n_cols, int R, int P,
              cudaStream_t stream) {
  constexpr int W = Warps<G>::value;
  const int n_groups = (Nr + 31) / 32;
  const dim3 grid((n_groups + W / G - 1) / (W / G), P);
  ghost_spmv_kernel<T, G, SUB><<<grid, W * 32, 0, stream>>>(
      rows, cols, vals, glanes, x, y, Nr, K, n_groups, n_cols, R);
}

template <typename T, bool SUB>
int launch(const int* rows, const int* cols, const T* vals, const int* glanes,
           const T* x, T* y, int Nr, int K, long long n_cols, long long R,
           int P, int lanes, cudaStream_t stream) {
  if (Nr < 0 || K < 0 || P < 0 || P > 65535 || n_cols > INT_MAX || R > INT_MAX ||
      (long long)K * Nr > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (Nr == 0 || K == 0 || P == 0) return (int)cudaGetLastError();
#define PAT_ELL_LANES(G)                                                   \
  case G:                                                                  \
    launch_g<T, G, SUB>(rows, cols, vals, glanes, x, y, Nr, K, (int)n_cols, \
                        (int)R, P, stream);                                \
    break;
  switch (lanes) {
    PAT_ELL_LANES(1)
    PAT_ELL_LANES(2)
    PAT_ELL_LANES(4)
    PAT_ELL_LANES(8)
    PAT_ELL_LANES(16)
    PAT_ELL_LANES(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAT_ELL_LANES
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pat_ghost_spmv_f32(const void* rows, const void* cols, const void* vals,
                       const void* glanes, const void* x, void* y, int Nr, int K,
                       long long n_cols, long long R, int P, int lanes,
                       void* stream) {
  return launch<float, false>((const int*)rows, (const int*)cols, (const float*)vals,
                              (const int*)glanes, (const float*)x, (float*)y, Nr, K,
                              n_cols, R, P, lanes, (cudaStream_t)stream);
}

int pat_ghost_spmv_f64(const void* rows, const void* cols, const void* vals,
                       const void* glanes, const void* x, void* y, int Nr, int K,
                       long long n_cols, long long R, int P, int lanes,
                       void* stream) {
  return launch<double, false>((const int*)rows, (const int*)cols, (const double*)vals,
                               (const int*)glanes, (const double*)x, (double*)y, Nr, K,
                               n_cols, R, P, lanes, (cudaStream_t)stream);
}

int pat_ghost_spmv_sub_f32(const void* rows, const void* cols, const void* vals,
                           const void* glanes, const void* x, void* y, int Nr, int K,
                           long long n_cols, long long R, int P, int lanes,
                           void* stream) {
  return launch<float, true>((const int*)rows, (const int*)cols, (const float*)vals,
                             (const int*)glanes, (const float*)x, (float*)y, Nr, K,
                             n_cols, R, P, lanes, (cudaStream_t)stream);
}

int pat_ghost_spmv_sub_f64(const void* rows, const void* cols, const void* vals,
                           const void* glanes, const void* x, void* y, int Nr, int K,
                           long long n_cols, long long R, int P, int lanes,
                           void* stream) {
  return launch<double, true>((const int*)rows, (const int*)cols, (const double*)vals,
                              (const int*)glanes, (const double*)x, (double*)y, Nr, K,
                              n_cols, R, P, lanes, (cudaStream_t)stream);
}

}  // extern "C"
