// K3 and K4 with float16 values: the entries of the pairs f16_f32 (float16
// values, float vectors) and f16_f64 (float16 values, double vectors), the
// reference's precond_dtype=float16 (values widened at
// partitionedarrays_tpu/ops/gs_pallas.py:101-110 and :171-180).  The
// kernels are gs_dia.cu's, instantiated here so that nvcc compiles these
// instances in a process of their own, beside gs_dia.cu's.

#define PAT_GS_DIA_NO_ENTRIES
#include "gs_dia.cu"

extern "C" {

PAT_GS_ENTRIES(f16_f32, __half, float)
PAT_GS_ENTRIES(f16_f64, __half, double)

}  // extern "C"
