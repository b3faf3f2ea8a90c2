// The DIA row engine shared by K2 (dia_spmv.cu), K3 and K4 (gs_dia.cu).
//
// The kernels compute, for rows i of one [n_off, ld] block of values,
//
//     acc[i] = sum_d vals[d * ld + i] * x[taps[d] + i]
//
// with x read as zero outside [0, n).  K2 is that sum for one color; K4
// runs it for every color of the core in one launch; K3 runs it once per
// color step and updates the color's row of x with it.
// The engine is written for the two regimes the paths run:
//
//   (a) many rows, few taps (the HPCG fine level: 245,760 rows per color,
//       27 taps): one thread takes VEC consecutive rows (16 bytes of x: 4
//       floats or 2 doubles), reads each tap's values as one load, issues
//       every load of a chunk of CH taps before its FMAs, and keeps 32-bit
//       offsets inside a part (the caller adds the part's base once);
//   (b) few rows, many taps (the 40^3 elasticity level: 7,168 rows, 99
//       taps; the HPCG 16^3 level: 1,024 rows, 27 taps): G lanes of one
//       warp share a row group and split its taps, lane g taking d = g,
//       g + G, ...; a butterfly of shuffles adds the G partial sums, so
//       that every lane holds the same, fixed-order total.  G is a power
//       of two up to 16, so a tap's 16-byte loads of one warp still cover
//       whole 32-byte sectors (narrow values' loads cover half or a
//       quarter of one, which the next warp reads from L2).
// G = 1 is regime (a).  The host (ops/dia_rows.py::row_lanes) picks G.
//
// Types: the values are V, x and the sums T.  VEC comes from T, so a
// value load is VEC * sizeof(V) bytes: 16 where V is T, 8 for bfloat16 or
// float16 values with float vectors or float values with double vectors,
// 4 for bfloat16 or float16 values with double vectors.  Each value is
// widened to T exactly (a bfloat16 is the upper half of a float; a
// float16 is a float exactly, and a float a double) before its FMA, and
// the sums run in T in the same tap order, under the same plan
// (ops/dia_rows.py plans from T alone), as with values of type T: narrow
// values change only the bytes read, and values exact in V give the
// full-value results bit for bit.  No tensor cores.
//
// Operands: the engine has one form, whole-load reads along the rows.
// The row length (ld) and every part stride of the values, bd, invd and
// x_in must be whole multiples of VEC, and every operand's start a whole
// load (VEC elements of its type); x itself is read by element.  The three
// wrappers (ops/dia_rows.py::check_rows) raise ValueError on anything
// else and the launchers return cudaErrorInvalidValue: there is no scalar
// form.  Every operand the paths give qualifies (Lq is a multiple of
// 1024, solvers/gs_dia.py).
//
// x is read with ordinary loads through a generic pointer: K3 writes x in
// the same launch (and may keep it in shared memory), so it must not go
// through the read-only path.  Values go through __ldg.  Taps sit in
// shared memory: lanes of a warp read different taps, which the constant
// bank would serialise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace pat {

constexpr int kVecBytes = 16;

// rows per thread: 16 bytes of the vector type T
template <typename T>
constexpr int vec_of() {
  return kVecBytes / (int)sizeof(T);
}

// one value widened to the vector type T, exactly
template <typename T>
__device__ __forceinline__ T widen(float v) { return T(v); }
template <typename T>
__device__ __forceinline__ T widen(double v) { return T(v); }
template <typename T>
__device__ __forceinline__ T widen(__nv_bfloat16 v) { return T(__bfloat162float(v)); }
template <typename T>
__device__ __forceinline__ T widen(__half v) { return T(__half2float(v)); }

// a bfloat16 is the upper half of a float: the two of a 32-bit word
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
// the two float16 of a 32-bit word (the first in the low half), as floats
__device__ __forceinline__ float f16_lo(unsigned w) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float f16_hi(unsigned w) {
  return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}

// Loads of VEC rows of one operand (16 bytes of T: 4 floats or 2
// doubles), and of one tap's VEC values of type V widened to T (16, 8 or 4
// bytes)
__device__ __forceinline__ void load_ro(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_ro(const double* p, double (&v)[2]) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void load_ro(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
}
__device__ __forceinline__ void load_ro(const __nv_bfloat16* p, double (&v)[2]) {
  const unsigned q = __ldg(reinterpret_cast<const unsigned*>(p));
  v[0] = bf16_lo(q); v[1] = bf16_hi(q);
}
__device__ __forceinline__ void load_ro(const __half* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = f16_lo(q.x); v[1] = f16_hi(q.x); v[2] = f16_lo(q.y); v[3] = f16_hi(q.y);
}
__device__ __forceinline__ void load_ro(const __half* p, double (&v)[2]) {
  const unsigned q = __ldg(reinterpret_cast<const unsigned*>(p));
  v[0] = f16_lo(q); v[1] = f16_hi(q);
}
__device__ __forceinline__ void load_ro(const float* p, double (&v)[2]) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = q.x; v[1] = q.y;
}

// coherent (x may be written in the same launch)
__device__ __forceinline__ void load_rw(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_rw(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// taps per lane whose loads are all issued before their FMAs: K2's and
// K3's (K4 passes its own CH to the functions below)
template <int G>
struct Chunk {
  static constexpr int value = G == 1 ? 8 : 4;
};

// One chunk of lane g's taps: d = d0, d0 + G, ..., CH of them (a tap past
// n_off is a zero).  chunk_values loads their values for rows i ..
// i+VEC-1, widened to T (vals: tap 0 of row 0 of the block, row stride
// ld); chunk_fma loads their x (the part's vector of n entries, in global
// or shared memory; taps: n_off tap offsets in shared memory) and adds the
// products to acc in increasing d.  The two are apart so that a caller can load a
// chunk's values before x is ready.
template <typename V, typename T, int VEC, int G, int CH = Chunk<G>::value>
__device__ __forceinline__ void chunk_values(T (&vv)[CH][VEC],
                                             const V* __restrict__ vals,
                                             int ld, int n_off, int i, int d0) {
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int d = d0 + k * G;
    if (d < n_off) {
      load_ro(vals + d * ld + i, vv[k]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) vv[k][v] = T(0);
    }
  }
}

template <typename T, int VEC, int G, int CH = Chunk<G>::value>
__device__ __forceinline__ void chunk_fma(T (&acc)[VEC], const T (&vv)[CH][VEC],
                                          const T* x, int n, const int* taps,
                                          int n_off, int i, int d0) {
  T xv[CH][VEC];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int d = d0 + k * G;
    const int j = d < n_off ? taps[d] + i : -VEC;
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      xv[k][v] = (unsigned)(j + v) < (unsigned)n ? x[j + v] : T(0);
  }
#pragma unroll
  for (int k = 0; k < CH; ++k)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] += vv[k][v] * xv[k][v];
}

// Lane g's partial sums of rows i .. i+VEC-1 over the taps d = g, g+G, ...
// in increasing d, given the values of its first chunk (d0 = g) in vv0.
template <typename V, typename T, int VEC, int G, int CH = Chunk<G>::value>
__device__ __forceinline__ void rows_partial_from(
    T (&acc)[VEC], const T (&vv0)[CH][VEC], const V* __restrict__ vals, int ld,
    const T* x, int n, const int* taps, int n_off, int i, int g) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = T(0);
  chunk_fma<T, VEC, G, CH>(acc, vv0, x, n, taps, n_off, i, g);
  for (int d0 = g + G * CH; d0 < n_off; d0 += G * CH) {
    T vv[CH][VEC];
    chunk_values<V, T, VEC, G, CH>(vv, vals, ld, n_off, i, d0);
    chunk_fma<T, VEC, G, CH>(acc, vv, x, n, taps, n_off, i, d0);
  }
}

// The same, loading every chunk itself.
template <typename V, typename T, int VEC, int G, int CH = Chunk<G>::value>
__device__ __forceinline__ void rows_partial(T (&acc)[VEC],
                                             const V* __restrict__ vals,
                                             int ld, const T* x, int n,
                                             const int* taps, int n_off,
                                             int i, int g) {
  T vv0[CH][VEC];
  chunk_values<V, T, VEC, G, CH>(vv0, vals, ld, n_off, i, g);
  rows_partial_from<V, T, VEC, G, CH>(acc, vv0, vals, ld, x, n, taps, n_off, i, g);
}

// Sum the partials of the G lanes that share a row group (a butterfly:
// every lane ends with the same total).  Every lane of the warp must call
// it: the shuffles take the full mask.
template <typename T, int VEC, int G>
__device__ __forceinline__ void reduce_lanes(T (&acc)[VEC]) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], off);
}

}  // namespace pat
