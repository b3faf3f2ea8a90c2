// The HPCG V-cycle's level transfers in the de-interleaved core layout, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference restricts by a 0/1 selection matmul
// and prolongates by a dilated pad (partitionedarrays_tpu/models/hpcg/mg.py),
// both in standard order: XLA layout devices for the TPU.  The port ran the
// same injection in PyTorch by way of standard order, about twelve strided
// copies, fills and adds a level pair (an interleave of the residual, a
// stride-2 slice, the coarse de-interleave, the coarse interleave, a zero fine
// box with a strided scatter, a fine de-interleave and an add).  These two
// kernels read and write the cores directly.
//
// A level's own point j (C order of its part's box nx x ny x nz) lives at
// core slot (j mod m) * Lq + j / m of its [m, Lq] core
// (solvers/gs_dia.py::ColoredDIAGS.deinterleave).  Coarse point jc = (ix, iy,
// iz) of the (nx/2, ny/2, nz/2) box is the fine point j = ((2 ix) ny + 2 iy)
// nz + 2 iz (injection of the even-coordinate points).  One thread per slot
// (p, c, i) of the coarse core [P, mc, Lqc] computes jc = i * mc + c and:
//
//   restrict:    rc[p, c, i] = jc < nc ? rd[p, fine_slot(jc)] : 0
//   prolongate:  xf[p, fine_slot(jc)] += xc[p, c, i]      (jc < nc only)
//
// where nc = (nx/2)(ny/2)(nz/2).  The restriction writes every coarse slot,
// so the coarse core's padding is zero, as a de-interleave leaves it.  Each
// fine slot is the image of at most one coarse point, so the prolongation's
// += has no race and needs no atomics; the even slots get one rounding of
// x + xc, every other slot is untouched (x + 0 = x), which is the
// standard-order composition's result.  Plain PyTorch versions and wrappers:
// ops/mg_transfer.py.
//
// Bound: device-memory bandwidth.  Per part, with V the bytes of the fine
// core: the restriction reads the even (x, y) z-lines only, about 1/4 of the
// fine core's 32-byte sectors (every other slot of such a line's run), and
// writes the coarse core, V/8: ~0.4 V.  The prolongation reads the coarse
// core and reads and writes the same quarter of the fine sectors: ~0.65 V.
// At 256^3 -> 128^3 in float64 (V = 134 MB) that is ~15 us and ~25 us at
// 3.35 TB/s.  Neighbouring threads take neighbouring coarse slots: the
// writes (restriction) and the coarse reads (prolongation) are coalesced,
// and along a coarse z-line a warp's fine slots stay in one color row at a
// stride of 2 (a coarse step of mc points is a fine step of 2 mc, which is
// 0 mod m when mc = m), so a warp touches a few sector runs.  There is one
// value to move per thread and no reuse, so one thread per coarse slot is
// enough: a 128^3 coarse core is 2.1 M threads, eight times what the card
// holds resident; the coarsest pairs (32^3 coarse and below) are launch
// latency.  Indices within a part are 32-bit (the wrapper checks m * Lq and
// mc * Lqc against INT_MAX); the part offset is 64-bit.  Grid: (coarse slots
// / 256, parts).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// one level pair: the fine box's inner extents and both cores
struct Pair {
  int ny, nz;    // fine box (nx only bounds nc)
  int nyc, nzc;  // coarse box
  int nc;        // coarse own points
  int m, Lq;     // fine core
  int mc, Lqc;   // coarse core
};

__device__ __forceinline__ unsigned fine_slot(unsigned jc, const Pair& g) {
  const unsigned iz = jc % (unsigned)g.nzc;
  const unsigned q = jc / (unsigned)g.nzc;
  const unsigned iy = q % (unsigned)g.nyc;
  const unsigned ix = q / (unsigned)g.nyc;
  const unsigned j = ((2u * ix) * (unsigned)g.ny + 2u * iy) * (unsigned)g.nz + 2u * iz;
  return (j % (unsigned)g.m) * (unsigned)g.Lq + j / (unsigned)g.m;
}

// coarse point of coarse core slot t, or nc and above for a padding slot
__device__ __forceinline__ unsigned coarse_point(unsigned t, const Pair& g) {
  const unsigned c = t / (unsigned)g.Lqc;
  const unsigned i = t - c * (unsigned)g.Lqc;
  return i * (unsigned)g.mc + c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    restrict_core_kernel(const T* __restrict__ rd, T* __restrict__ rc, Pair g) {
  const unsigned slots = (unsigned)g.mc * (unsigned)g.Lqc;
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= slots) return;
  const long long p = blockIdx.y;
  const unsigned jc = coarse_point(t, g);
  T v = T(0);
  if (jc < (unsigned)g.nc) v = __ldg(rd + p * g.m * (long long)g.Lq + fine_slot(jc, g));
  rc[p * slots + t] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    prolong_add_core_kernel(T* __restrict__ xf, const T* __restrict__ xc, Pair g) {
  const unsigned slots = (unsigned)g.mc * (unsigned)g.Lqc;
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= slots) return;
  const unsigned jc = coarse_point(t, g);
  if (jc >= (unsigned)g.nc) return;
  const long long p = blockIdx.y;
  xf[p * g.m * (long long)g.Lq + fine_slot(jc, g)] += __ldg(xc + p * slots + t);
}

// the pair's geometry, or false where an argument is out of range: an odd or
// empty box, a box larger than its core, an index past 32 bits
bool pair_of(int nx, int ny, int nz, int m, long long Lq, int mc, long long Lqc, int P,
             Pair* g) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || (nx | ny | nz) & 1 || m <= 0 || mc <= 0 ||
      Lq <= 0 || Lqc <= 0 || P < 0 || P > 65535)
    return false;
  const long long n = (long long)nx * ny * nz;
  const long long nc = n / 8;
  if ((long long)m * Lq > INT_MAX || (long long)mc * Lqc > INT_MAX || n > (long long)m * Lq ||
      nc > (long long)mc * Lqc)
    return false;
  *g = Pair{ny, nz, ny / 2, nz / 2, (int)nc, m, (int)Lq, mc, (int)Lqc};
  return true;
}

dim3 grid_of(const Pair& g, int P) {
  const unsigned slots = (unsigned)g.mc * (unsigned)g.Lqc;
  return dim3((slots + kThreads - 1) / kThreads, P);
}

template <typename T>
int restrict_core(const T* rd, T* rc, int nx, int ny, int nz, int m, long long Lq, int mc,
                  long long Lqc, int P, cudaStream_t stream) {
  Pair g;
  if (!pair_of(nx, ny, nz, m, Lq, mc, Lqc, P, &g)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaGetLastError();
  restrict_core_kernel<T><<<grid_of(g, P), kThreads, 0, stream>>>(rd, rc, g);
  return (int)cudaGetLastError();
}

template <typename T>
int prolong_add_core(T* xf, const T* xc, int nx, int ny, int nz, int m, long long Lq, int mc,
                     long long Lqc, int P, cudaStream_t stream) {
  Pair g;
  if (!pair_of(nx, ny, nz, m, Lq, mc, Lqc, P, &g)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaGetLastError();
  prolong_add_core_kernel<T><<<grid_of(g, P), kThreads, 0, stream>>>(xf, xc, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pat_mg_restrict_core_f32(const void* rd, void* rc, int nx, int ny, int nz, int m,
                             long long Lq, int mc, long long Lqc, int P, void* stream) {
  return restrict_core<float>((const float*)rd, (float*)rc, nx, ny, nz, m, Lq, mc, Lqc, P,
                              (cudaStream_t)stream);
}

int pat_mg_restrict_core_f64(const void* rd, void* rc, int nx, int ny, int nz, int m,
                             long long Lq, int mc, long long Lqc, int P, void* stream) {
  return restrict_core<double>((const double*)rd, (double*)rc, nx, ny, nz, m, Lq, mc, Lqc, P,
                               (cudaStream_t)stream);
}

int pat_mg_prolong_core_f32(void* xf, const void* xc, int nx, int ny, int nz, int m,
                            long long Lq, int mc, long long Lqc, int P, void* stream) {
  return prolong_add_core<float>((float*)xf, (const float*)xc, nx, ny, nz, m, Lq, mc, Lqc, P,
                                 (cudaStream_t)stream);
}

int pat_mg_prolong_core_f64(void* xf, const void* xc, int nx, int ny, int nz, int m,
                            long long Lq, int mc, long long Lqc, int P, void* stream) {
  return prolong_add_core<double>((double*)xf, (const double*)xc, nx, ny, nz, m, Lq, mc, Lqc,
                                  P, (cudaStream_t)stream);
}

}  // extern "C"
