// One block-diagonal stage: out[t, j, :] = x[t, j, :] . W[j]^T.
// Replaces the Pallas kernel ``bdmm`` / ``_bdmm_kernel`` of
// repro/kernels/bdmm.py.
//
// x: (T, k, p) with arbitrary strides (so the staged Monarch branch reads
// the stride-permuted intermediate in place), w: (k, q, p) contiguous ->
// out: (T, k, q) contiguous in x's dtype.
//
// Grid (k, ceil(T / bT)): each block stages W[j] (q x p, rows padded by one
// float against bank conflicts) and its token tile's x[:, j, :] slice in
// shared memory, then writes its bT x q output tile with fp32 FMA.  Only the
// diagonal blocks are ever read or multiplied: no work on the off-diagonal
// zeros.  Shared memory: q*(p+1) + bT*p floats (kernels/bdmm.py:smem_bytes).
#include "common.cuh"

template <typename XT, typename WT>
__global__ void bdmm_kernel(const XT* __restrict__ x,
                            const WT* __restrict__ w, XT* __restrict__ out,
                            int T, int k, int q, int p, int bT, long long sx_t,
                            long long sx_j, long long sx_p) {
  extern __shared__ float smem[];
  const int wstride = p + 1;
  float* ws = smem;                 // (q, p + 1)
  float* xs = ws + q * wstride;     // (bT, p)
  const int j = blockIdx.x;
  const int t0 = blockIdx.y * bT;
  const int tid = threadIdx.x, nth = blockDim.x;

  const WT* wj = w + (size_t)j * q * p;
  for (int e = tid; e < q * p; e += nth) {
    const int c = e / p, pp = e - c * p;
    ws[c * wstride + pp] = to_f(wj[e]);
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

template <typename XT, typename WT>
static int launch(const void* x, const void* w, void* out, int T, int k, int q,
                  int p, int bT, long long sx_t, long long sx_j,
                  long long sx_p, size_t smem, cudaStream_t stream) {
  auto kern = bdmm_kernel<XT, WT>;
  cudaError_t err = prepare_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(k, (T + bT - 1) / bT);
  kern<<<grid, 256, smem, stream>>>(static_cast<const XT*>(x),
                                    static_cast<const WT*>(w),
                                    static_cast<XT*>(out), T, k, q, p, bT,
                                    sx_t, sx_j, sx_p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bdmm_launch(const void* x, const void* w, void* out, int T,
                           int k, int q, int p, int bT, long long sx_t,
                           long long sx_j, long long sx_p, int x_dtype,
                           int w_dtype, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)q * (p + 1) + (size_t)bT * p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == DT_F32 && w_dtype == DT_F32)
    return launch<float, float>(x, w, out, T, k, q, p, bT, sx_t, sx_j, sx_p,
                                smem, st);
  if (x_dtype == DT_F32 && w_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(x, w, out, T, k, q, p, bT, sx_t, sx_j,
                                        sx_p, smem, st);
  if (x_dtype == DT_BF16 && w_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(x, w, out, T, k, q, p, bT, sx_t, sx_j,
                                        sx_p, smem, st);
  if (x_dtype == DT_BF16 && w_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, T, k, q, p, bT,
                                                sx_t, sx_j, sx_p, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
