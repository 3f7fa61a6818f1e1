// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every kernel computes in fp32 with plain FMA (no TF32, no tensor cores):
// loads widen bf16 to fp32, stores narrow fp32 to the output type with
// round-to-nearest-even, which is what the reference's ``.astype`` does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed from Python (kernels/_build.py: DTYPE_CODES)
#define DT_F32 0
#define DT_BF16 1

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Opt a kernel into more than 48 KB of dynamic shared memory, then return
// the launch error (0 on success) so the Python wrapper can raise on it.
template <typename K>
static cudaError_t prepare_smem(K kernel, size_t smem_bytes) {
  if (smem_bytes > 48 * 1024) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
  }
  return cudaSuccess;
}
