// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every kernel computes in fp32 with plain FMA (no TF32, no tensor cores):
// loads widen bf16 to fp32, stores narrow fp32 to the output type with
// round-to-nearest-even, which is what the reference's ``.astype`` does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Block-diagonal factor readers: element (r, c) of diagonal block ``blk``
// of a factor stored as (n_blocks, rows, cols), widened to fp32.  The
// kernels are templated on the reader, so a float factor and a quantized
// one run the same arithmetic after the value is staged in shared memory.
template <typename WT>
struct FloatBlocks {
  const WT* w;
  int rows, cols;
  __device__ __forceinline__ float operator()(int blk, int r, int c) const {
    return to_f(w[((size_t)blk * rows + r) * cols + c]);
  }
};

// int8 values (BITS 8), or int4 values packed two to a byte along ``cols``
// (BITS 4: byte = hi << 4 | lo, lo the even index), times the block's fp32
// scale: core.quant.dequantize_factor's single fp32 multiply.  __fmul_rn
// keeps nvcc from contracting it into a later add, so the staged value is
// bitwise what the plain version computes.
template <int BITS>
struct QuantBlocks {
  const int8_t* w;
  const float* scale;
  int rows, cols;
  __device__ __forceinline__ float operator()(int blk, int r, int c) const {
    const int stored = BITS == 4 ? cols >> 1 : cols;
    const int8_t* row = w + ((size_t)blk * rows + r) * stored;
    int v;
    if (BITS == 4) {
      const int b = row[c >> 1];  // the signed byte, sign-extended
      v = (c & 1) ? (b >> 4) : (((b & 0xF) ^ 8) - 8);
    } else {
      v = row[c];
    }
    return __fmul_rn(static_cast<float>(v), scale[blk]);
  }
};

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
