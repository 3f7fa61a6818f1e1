// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every kernel computes in fp32: plain FMA, or (bdmm.cu's prefill instance)
// TF32 tensor cores on operands split in two TF32 halves, three products
// each, which holds fp32's accuracy.  Loads widen bf16 to fp32, stores narrow
// fp32 to the output type with round-to-nearest-even, which is what the
// reference's ``.astype`` does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

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
// one run the same arithmetic after the value is widened.  ``row`` and
// ``row_bytes`` give a stored row's address and size, so a kernel can copy
// raw rows into shared memory and widen them there with ``at`` (the same
// conversion ``operator()`` applies to device memory).
template <typename WT>
struct FloatBlocks {
  const WT* w;
  int rows, cols;
  __host__ __device__ int row_bytes() const {
    return cols * static_cast<int>(sizeof(WT));
  }
  __host__ __device__ const char* row(int blk, int r) const {
    return reinterpret_cast<const char*>(w + ((size_t)blk * rows + r) * cols);
  }
  __device__ __forceinline__ float scale_of(int) const { return 1.f; }
  // expert e of a stack of factors of ``nblocks`` blocks each
  __host__ __device__ FloatBlocks expert(int e, int nblocks) const {
    return FloatBlocks{w + (size_t)e * nblocks * rows * cols, rows, cols};
  }
  // element c of a stored row; a float factor has no scale
  __device__ static __forceinline__ float at(const char* row, int c, float) {
    return to_f(reinterpret_cast<const WT*>(row)[c]);
  }
  __device__ __forceinline__ float operator()(int blk, int r, int c) const {
    return at(row(blk, r), c, 1.f);
  }
};

// int8 values (BITS 8), or int4 values packed two to a byte along ``cols``
// (BITS 4: byte = hi << 4 | lo, lo the even index), times the block's fp32
// scale: core.quant.dequantize_factor's single fp32 multiply.  __fmul_rn
// keeps nvcc from contracting it into a later add, so the value is
// bitwise what the plain version computes.
template <int BITS>
struct QuantBlocks {
  const int8_t* w;
  const float* scale;
  int rows, cols;
  __host__ __device__ int row_bytes() const {
    return BITS == 4 ? cols >> 1 : cols;
  }
  __host__ __device__ const char* row(int blk, int r) const {
    return reinterpret_cast<const char*>(w) +
           ((size_t)blk * rows + r) * row_bytes();
  }
  __device__ __forceinline__ float scale_of(int blk) const {
    return scale[blk];
  }
  // expert e of a stack of factors of ``nblocks`` blocks each (values and
  // one scale a block)
  __host__ __device__ QuantBlocks expert(int e, int nblocks) const {
    return QuantBlocks{w + (size_t)e * nblocks * rows * row_bytes(),
                       scale + (size_t)e * nblocks, rows, cols};
  }
  __device__ static __forceinline__ float at(const char* row, int c,
                                             float sc) {
    const int8_t* r8 = reinterpret_cast<const int8_t*>(row);
    int v;
    if (BITS == 4) {
      const int b = r8[c >> 1];  // the signed byte, sign-extended
      v = (c & 1) ? (b >> 4) : (((b & 0xF) ^ 8) - 8);
    } else {
      v = r8[c];
    }
    return __fmul_rn(static_cast<float>(v), sc);
  }
  __device__ __forceinline__ float operator()(int blk, int r, int c) const {
    return at(row(blk, r), c, scale[blk]);
  }
};

__host__ __device__ inline size_t r16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// lanes that share one dot product of length n: a power of two, at most
// 32 and n, and as many as a block of NT threads allows for ``items`` dots
template <int NT>
__device__ __forceinline__ int lanes_for(int items, int n) {
  int g = 1;
  while (g < 32 && 2 * g <= n && 2 * g * items <= NT) g *= 2;
  return g;
}

// sum over each aligned group of g lanes; every lane of the warp calls it
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// widest copy unit (16, 8 or 4 bytes; 1: plain loads) that every address
// and size OR-ed into m is a multiple of
__device__ __forceinline__ int vec_of(size_t m) {
  return m % 16 == 0 ? 16 : m % 8 == 0 ? 8 : m % 4 == 0 ? 4 : 1;
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(N)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copy ``nseg`` rows of ``bytes`` each, row g from src(g) to
// dst + g * dst_stride, with the NT threads of a block; asynchronous
// unless vec is 1
template <int NT, typename Src>
__device__ __forceinline__ void stage(char* dst, int dst_stride, int nseg,
                                      int bytes, int vec, Src src) {
  if (vec == 1) {
    for (int e = threadIdx.x; e < nseg * bytes; e += NT) {
      const int g = e / bytes, b = e - g * bytes;
      dst[(size_t)g * dst_stride + b] = src(g)[b];
    }
    return;
  }
  const int per = bytes / vec;
  for (int e = threadIdx.x; e < nseg * per; e += NT) {
    const int g = e / per, o = (e - g * per) * vec;
    char* d = dst + (size_t)g * dst_stride + o;
    const char* s = src(g) + o;
    if (vec == 16)
      cp_async<16>(d, s);
    else if (vec == 8)
      cp_async<8>(d, s);
    else
      cp_async<4>(d, s);
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory, then return
// the launch error (0 on success) so the Python wrapper can raise on it.
// The attribute is set once per (kernel, device), at the first launch that
// needs more than the last setting: the engine's first eager step of a span
// bucket sets every attribute its CUDA graph's capture then finds set, so
// the capture records launches only.
template <typename K>
static cudaError_t prepare_smem(K kernel, size_t smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  struct Set {
    const void* kernel;
    int device;
    size_t bytes;
  };
  static std::mutex mu;
  static std::vector<Set> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  Set* hit = nullptr;
  for (Set& s : done)
    if (s.kernel == key && s.device == device) hit = &s;
  if (hit != nullptr && hit->bytes >= smem_bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  if (hit != nullptr)
    hit->bytes = smem_bytes;
  else
    done.push_back(Set{key, device, smem_bytes});
  return cudaSuccess;
}
