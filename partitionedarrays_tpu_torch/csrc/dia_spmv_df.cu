// K7: df64 (two-float) DIA SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel partitionedarrays_tpu/ops/spmv_pallas.py::
// dia_spmv_pallas_flat_df (_dia_spmv_pallas_flat_df, body
// _dia_kernel_flat_df), the fine-operator SpMV of the official-precision
// (df64) HPCG.  Values and x are (hi, lo) pairs of float32 words; for every
// part p and row i it computes, tap by tap in the order of the offsets,
//
//     p, e   = two_prod(vh, xh)         exact: p + e == vh * xh
//     e     += vh * xl + vl * xh
//     acc_h, c = two_sum(acc_h, p)     exact: acc_h' + c == acc_h + p
//     acc_l += c + e
//
// and writes quick_two_sum(acc_h, acc_l), with x read as zero outside
// [0, n_cols).  Plain PyTorch version: ops/df64.py::dia_spmv_df_plain
// (same per-tap order); wrapper: ops/dia_spmv.py::dia_spmv_df.
//
// Rounding.  An error-free transformation holds only if every operation is
// rounded as written.  nvcc contracts a*b + c into one fma by default
// (-fmad=true), which would replace a rounded product by the exact one and
// break two_sum and the cross terms.  The shared NVCC_FLAGS stay as they
// are (a global -fmad=false would change K1-K5), so every operation here is
// an explicit round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn),
// which the compiler never contracts.  two_prod is p = a*b and
// e = fmaf(a, b, -p): the fused multiply-add gives the exact error of the
// product, which the plain version's Dekker split also gives, bit for bit.
//
// Bound: device-memory bandwidth.  Each row reads 2 * n_off value words
// (hi and lo streams) and writes 2 words; ~14 float32 operations per tap
// are far below the card's float32 rate for those bytes.  The design is
// K1's: values stored [.., n_off, R] so that neighbouring threads read
// neighbouring addresses of both streams, x pairs through the read-only
// path (__ldg), the 27 taps of a warp falling into a few short runs of x
// that L1/L2 serve, offsets in the parameter block, masked loads at the
// edges, one thread per output row, grid-stride loop over P * R.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 128;  // ops/dia.py::MAX_DIAGS
constexpr int kThreads = 256;

struct DiaOffsets {
  int n;
  int off[kMaxDiags];
};

__device__ __forceinline__ void two_sum(float a, float b, float* s,
                                        float* e) {
  const float sum = __fadd_rn(a, b);
  const float bb = __fsub_rn(sum, a);
  *e = __fadd_rn(__fsub_rn(a, __fsub_rn(sum, bb)), __fsub_rn(b, bb));
  *s = sum;
}

__device__ __forceinline__ void quick_two_sum(float a, float b, float* s,
                                              float* e) {
  const float sum = __fadd_rn(a, b);
  *e = __fsub_rn(b, __fsub_rn(sum, a));
  *s = sum;
}

__global__ void dia_spmv_df_kernel(const float* __restrict__ vh,
                                   const float* __restrict__ vl,
                                   const float* __restrict__ xh,
                                   const float* __restrict__ xl,
                                   float* __restrict__ yh,
                                   float* __restrict__ yl,
                                   const DiaOffsets offs, long long R,
                                   long long n_cols, int P) {
  const long long total = (long long)P * R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long p = t / R;
    const long long i = t - p * R;
    const float* vhp = vh + p * offs.n * R + i;
    const float* vlp = vl + p * offs.n * R + i;
    const float* xhp = xh + p * n_cols;
    const float* xlp = xl + p * n_cols;
    float acc_h = 0.0f, acc_l = 0.0f;
    for (int d = 0; d < offs.n; ++d) {
      const long long j = i + offs.off[d];
      const bool in = j >= 0 && j < n_cols;
      const float sh = in ? __ldg(xhp + j) : 0.0f;
      const float sl = in ? __ldg(xlp + j) : 0.0f;
      const float ah = vhp[d * R];
      const float al = vlp[d * R];
      const float prod = __fmul_rn(ah, sh);
      float err = fmaf(ah, sh, -prod);
      err = __fadd_rn(err, __fadd_rn(__fmul_rn(ah, sl), __fmul_rn(al, sh)));
      float c;
      two_sum(acc_h, prod, &acc_h, &c);
      acc_l = __fadd_rn(acc_l, __fadd_rn(c, err));
    }
    float outh, outl;
    quick_two_sum(acc_h, acc_l, &outh, &outl);
    yh[t] = outh;
    yl[t] = outl;
  }
}

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // enough resident blocks for 132 SMs
  if (b > cap) b = cap;
  return b < 1 ? 1 : (int)b;
}

}  // namespace

extern "C" {

// vals_hi, vals_lo [P, n_off, R]; x_hi, x_lo [P, n_cols]; y_hi, y_lo [P, R];
// all float32, contiguous
int pat_dia_spmv_df_f32(const void* vals_hi, const void* vals_lo,
                        const void* x_hi, const void* x_lo, void* y_hi,
                        void* y_lo, const int* offsets, int n_off,
                        long long R, long long n_cols, int P, void* stream) {
  if (n_off < 0 || n_off > kMaxDiags) return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.n = n_off;
  for (int d = 0; d < n_off; ++d) offs.off[d] = offsets[d];
  if ((long long)P * R > 0) {
    dia_spmv_df_kernel<<<blocks_for((long long)P * R), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const float*)vals_hi, (const float*)vals_lo, (const float*)x_hi,
        (const float*)x_lo, (float*)y_hi, (float*)y_lo, offs, R, n_cols, P);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
