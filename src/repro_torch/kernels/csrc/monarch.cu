// Fused two-stage Monarch product y = R . P . L . x for one token tile per
// thread block.  Replaces the Pallas kernels ``monarch_fused`` /
// ``_monarch_kernel`` (float factors) and ``monarch_fused_q`` /
// ``_monarch_q_kernel`` (int8 or nibble-packed int4 factors with one fp32
// scale per diagonal block) of repro/kernels/monarch.py.
//
// x: (T, k*p), L: (k, q, p), R: (q, s, k) -> y: (T, q*s) in x's dtype.
// Quantized: Lq (k, q, p[/2]) int8, Ls (k,) fp32, Rq (q, s, k[/2]) int8,
// Rs (q,) fp32; the int4 axis is the contraction axis of each factor.
//
// The TPU kernel pins both whole factors in VMEM; a Hopper block has at most
// 227 KB of shared memory, less than one gpt2-medium FFN factor pair in
// fp32.  So the block keeps only the token tile's intermediate on chip and
// streams the factors through it one diagonal block at a time:
//
//   stage 1  for j < k: stage L[j] (q x p) and x[tile, j*p:(j+1)*p] in shared
//            memory, write u[t, j, :] = L[j] . x[t, j, :] (fp32 FMA) into the
//            shared intermediate, rounded to x's dtype as the reference
//            rounds it between the stages (monarch.py:46);
//   stage 2  for i < q: stage R[i] (s x k), read u[t, :, i] -- the stride
//            permutation P is only this index -- and write y[t, i*s:(i+1)*s].
//
// A factor block is staged as fp32 through a reader (common.cuh): a float
// factor is widened, a quantized one dequantized as float(v) * scale of its
// block, one fp32 multiply, exactly core.quant.dequantize_factor.  After
// staging the two instances run the same code, so the quantized kernel is
// bitwise the float kernel on the dequantized factors, and only the bytes
// read from device memory shrink (1 or 0.5 per weight instead of 4).
//
// Shared memory: bT*k*q (intermediate) + max(q*(p+1), s*(k+1)) (one factor
// block, rows padded by one float against bank conflicts) + bT*p (x slice)
// floats, whatever the factors' stored width.  kernels/monarch.py:
// fused_smem_bytes is the same formula, and ops.monarch_mm[_q] take the
// staged bdmm branch when no tile fits.  The ragged T edge is masked
// instead of padded.
#include <algorithm>

#include "common.cuh"

template <typename XT, typename W>
__global__ void monarch_fused_kernel(const XT* __restrict__ x, W Lw, W Rw,
                                     XT* __restrict__ y, int T, int k, int q,
                                     int p, int s, int bT) {
  extern __shared__ float smem[];
  const int kq = k * q;
  const int lstride = p + 1, rstride = k + 1;
  const int wsize = max(q * lstride, s * rstride);
  float* u = smem;                          // (bT, k, q)
  float* wbuf = u + (size_t)bT * kq;        // one factor block, padded rows
  float* xs = wbuf + wsize;                 // (bT, p) slice of x
  const int t0 = blockIdx.x * bT;
  const int din = k * p, dout = q * s;
  const int tid = threadIdx.x, nth = blockDim.x;

  // stage 1: u[t, j, c] = sum_pp L[j, c, pp] * x[t, j*p + pp]
  for (int j = 0; j < k; ++j) {
    for (int e = tid; e < q * p; e += nth) {
      const int c = e / p, pp = e - c * p;
      wbuf[c * lstride + pp] = Lw(j, c, pp);
    }
    for (int e = tid; e < bT * p; e += nth) {
      const int t = e / p, pp = e - t * p;
      const int tg = t0 + t;
      xs[e] = tg < T ? to_f(x[(size_t)tg * din + (size_t)j * p + pp]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < bT * q; e += nth) {
      const int t = e / q, c = e - t * q;
      const float* xr = xs + t * p;
      const float* wr = wbuf + c * lstride;
      float acc = 0.f;
      for (int pp = 0; pp < p; ++pp) acc = fmaf(xr[pp], wr[pp], acc);
      u[(size_t)t * kq + j * q + c] = to_f(from_f<XT>(acc));
    }
    __syncthreads();
  }

  // stage 2: y[t, i*s + c] = sum_jj R[i, c, jj] * u[t, jj, i]
  for (int i = 0; i < q; ++i) {
    for (int e = tid; e < s * k; e += nth) {
      const int c = e / k, jj = e - c * k;
      wbuf[c * rstride + jj] = Rw(i, c, jj);
    }
    __syncthreads();
    for (int e = tid; e < bT * s; e += nth) {
      const int t = e / s, c = e - t * s;
      const int tg = t0 + t;
      if (tg < T) {
        const float* ur = u + (size_t)t * kq + i;
        const float* wr = wbuf + c * rstride;
        float acc = 0.f;
        for (int jj = 0; jj < k; ++jj)
          acc = fmaf(ur[(size_t)jj * q], wr[jj], acc);
        y[(size_t)tg * dout + (size_t)i * s + c] = from_f<XT>(acc);
      }
    }
    __syncthreads();
  }
}

template <typename XT, typename W>
static int launch(const void* x, W Lw, W Rw, void* y, int T, int k, int q,
                  int p, int s, int bT, cudaStream_t stream) {
  const size_t wsize = (size_t)std::max(q * (p + 1), s * (k + 1));
  const size_t smem =
      sizeof(float) * ((size_t)bT * k * q + wsize + (size_t)bT * p);
  auto kern = monarch_fused_kernel<XT, W>;
  cudaError_t err = prepare_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (T + bT - 1) / bT;
  kern<<<grid, 256, smem, stream>>>(static_cast<const XT*>(x), Lw, Rw,
                                    static_cast<XT*>(y), T, k, q, p, s, bT);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT>
static int launch_float(const void* x, const void* L, const void* R, void* y,
                        int T, int k, int q, int p, int s, int bT, int x_dtype,
                        cudaStream_t st) {
  const FloatBlocks<WT> Lw{static_cast<const WT*>(L), q, p};
  const FloatBlocks<WT> Rw{static_cast<const WT*>(R), s, k};
  if (x_dtype == DT_F32)
    return launch<float>(x, Lw, Rw, y, T, k, q, p, s, bT, st);
  if (x_dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, Lw, Rw, y, T, k, q, p, s, bT, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BITS>
static int launch_quant(const void* x, const void* Lq, const void* Ls,
                        const void* Rq, const void* Rs, void* y, int T, int k,
                        int q, int p, int s, int bT, int x_dtype,
                        cudaStream_t st) {
  const QuantBlocks<BITS> Lw{static_cast<const int8_t*>(Lq),
                             static_cast<const float*>(Ls), q, p};
  const QuantBlocks<BITS> Rw{static_cast<const int8_t*>(Rq),
                             static_cast<const float*>(Rs), s, k};
  if (x_dtype == DT_F32)
    return launch<float>(x, Lw, Rw, y, T, k, q, p, s, bT, st);
  if (x_dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, Lw, Rw, y, T, k, q, p, s, bT, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int monarch_fused_launch(const void* x, const void* L,
                                    const void* R, void* y, int T, int k,
                                    int q, int p, int s, int bT, int x_dtype,
                                    int w_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == DT_F32)
    return launch_float<float>(x, L, R, y, T, k, q, p, s, bT, x_dtype, st);
  if (w_dtype == DT_BF16)
    return launch_float<__nv_bfloat16>(x, L, R, y, T, k, q, p, s, bT, x_dtype,
                                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bits 8: int8 factors; bits 4: both factors nibble-packed along their
// contraction axis (p for L, k for R, both even)
extern "C" int monarch_fused_q_launch(const void* x, const void* Lq,
                                      const void* Ls, const void* Rq,
                                      const void* Rs, void* y, int T, int k,
                                      int q, int p, int s, int bT, int x_dtype,
                                      int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    return launch_quant<8>(x, Lq, Ls, Rq, Rs, y, T, k, q, p, s, bT, x_dtype,
                           st);
  if (bits == 4 && p % 2 == 0 && k % 2 == 0)
    return launch_quant<4>(x, Lq, Ls, Rq, Rs, y, T, k, q, p, s, bT, x_dtype,
                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}
