// One block-diagonal stage: out[t, j, :] = x[t, j, :] . W[j]^T.
// Replaces the Pallas kernels ``bdmm`` / ``_bdmm_kernel`` (float blocks) and
// ``bdmm_q`` / ``_bdmm_q_kernel`` (int8 or nibble-packed int4 blocks with one
// fp32 scale per block) of repro/kernels/bdmm.py.
//
// x: (T, k, p) with arbitrary strides (so the staged Monarch branch reads
// the stride-permuted intermediate in place), w: (k, q, p) contiguous, or
// wq (k, q, p[/2]) int8 with scale (k,) fp32 -> out: (T, k, q) contiguous in
// x's dtype.
//
// Grid (k, ceil(T / bT)): each block stages W[j] (q x p, rows padded by one
// float against bank conflicts) and its token tile's x[:, j, :] slice in
// shared memory, then writes its bT x q output tile with fp32 FMA.  Only the
// diagonal blocks are ever read or multiplied: no work on the off-diagonal
// zeros.  A quantized block is staged as float(v) * scale[j] (one fp32
// multiply, core.quant.dequantize_factor) by the reader of common.cuh, so
// the quantized kernel is bitwise the float kernel on the dequantized block
// and reads 1 or 0.5 bytes per weight instead of 4.  Shared memory:
// q*(p+1) + bT*p floats whatever the stored width (kernels/bdmm.py:
// smem_bytes).
#include "common.cuh"

template <typename XT, typename W>
__global__ void bdmm_kernel(const XT* __restrict__ x, W w,
                            XT* __restrict__ out, int T, int k, int q, int p,
                            int bT, long long sx_t, long long sx_j,
                            long long sx_p) {
  extern __shared__ float smem[];
  const int wstride = p + 1;
  float* ws = smem;                 // (q, p + 1)
  float* xs = ws + q * wstride;     // (bT, p)
  const int j = blockIdx.x;
  const int t0 = blockIdx.y * bT;
  const int tid = threadIdx.x, nth = blockDim.x;

  for (int e = tid; e < q * p; e += nth) {
    const int c = e / p, pp = e - c * p;
    ws[c * wstride + pp] = w(j, c, pp);
  }
  for (int e = tid; e < bT * p; e += nth) {
    const int t = e / p, pp = e - t * p;
    const int tg = t0 + t;
    xs[e] = tg < T ? to_f(x[tg * sx_t + j * sx_j + pp * sx_p]) : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < bT * q; e += nth) {
    const int t = e / q, c = e - t * q;
    const int tg = t0 + t;
    if (tg >= T) continue;
    const float* xr = xs + t * p;
    const float* wr = ws + c * wstride;
    float acc = 0.f;
    for (int pp = 0; pp < p; ++pp) acc = fmaf(xr[pp], wr[pp], acc);
    out[((size_t)tg * k + j) * q + c] = from_f<XT>(acc);
  }
}

template <typename XT, typename W>
static int launch(const void* x, W w, void* out, int T, int k, int q, int p,
                  int bT, long long sx_t, long long sx_j, long long sx_p,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)q * (p + 1) + (size_t)bT * p);
  auto kern = bdmm_kernel<XT, W>;
  cudaError_t err = prepare_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(k, (T + bT - 1) / bT);
  kern<<<grid, 256, smem, stream>>>(static_cast<const XT*>(x), w,
                                    static_cast<XT*>(out), T, k, q, p, bT,
                                    sx_t, sx_j, sx_p);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
static int launch_x(const void* x, W w, void* out, int T, int k, int q, int p,
                    int bT, long long sx_t, long long sx_j, long long sx_p,
                    int x_dtype, cudaStream_t st) {
  if (x_dtype == DT_F32)
    return launch<float>(x, w, out, T, k, q, p, bT, sx_t, sx_j, sx_p, st);
  if (x_dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, w, out, T, k, q, p, bT, sx_t, sx_j, sx_p,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bdmm_launch(const void* x, const void* w, void* out, int T,
                           int k, int q, int p, int bT, long long sx_t,
                           long long sx_j, long long sx_p, int x_dtype,
                           int w_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == DT_F32)
    return launch_x(x, FloatBlocks<float>{static_cast<const float*>(w), q, p},
                    out, T, k, q, p, bT, sx_t, sx_j, sx_p, x_dtype, st);
  if (w_dtype == DT_BF16)
    return launch_x(x,
                    FloatBlocks<__nv_bfloat16>{
                        static_cast<const __nv_bfloat16*>(w), q, p},
                    out, T, k, q, p, bT, sx_t, sx_j, sx_p, x_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bits 8: int8 blocks; bits 4: blocks nibble-packed along p (p even)
extern "C" int bdmm_q_launch(const void* x, const void* wq, const void* scale,
                             void* out, int T, int k, int q, int p, int bT,
                             long long sx_t, long long sx_j, long long sx_p,
                             int x_dtype, int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(scale);
  if (bits == 8)
    return launch_x(x, QuantBlocks<8>{w8, sc, q, p}, out, T, k, q, p, bT,
                    sx_t, sx_j, sx_p, x_dtype, st);
  if (bits == 4 && p % 2 == 0)
    return launch_x(x, QuantBlocks<4>{w8, sc, q, p}, out, T, k, q, p, bT,
                    sx_t, sx_j, sx_p, x_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
