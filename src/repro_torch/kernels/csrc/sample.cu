// The engine's token draw on Hopper: greedy argmax, or a threefry Gumbel
// draw at temperature > 0, for each row of the step's fp32 logits, with each
// row's PRNG key split in place.
//
// Replaces the reference's _split_rows and _sample_rows
// (src/repro/serving/engine.py:119-145): jax.random.split and
// jax.random.categorical, jnp code that XLA compiles into the jitted step
// (not a Pallas kernel).  The port's plain version (kernels/sample.py:
// sample_tokens_plain, core/prng.py) runs the threefry rounds as ~120
// eager int64 ops over B x V.  For a row b with key k (two 32-bit words):
//
//   draw  = threefry(k, 0, 0), carry = threefry(k, 0, 1)    (split(k, 2))
//   bits_j = x ^ y of threefry(draw, 0, j)                  (random_bits)
//   u_j = max(tiny, ((bits_j >> 9 | 0x3f800000) as float - 1) + tiny)
//   g_j = -log(-log(u_j))                                   (gumbel "low")
//   token = argmax_j (logit_j / max(t, 1e-6) + g_j)  where t > 0 and the
//           step draws, else argmax_j logit_j; ties to the first index
//   k <- carry where the row samples this step
//
// A block draw (block = 1) is the legacy ServeEngine's
// jax.random.categorical(key, logits / t) over the whole (B, V) block
// under ONE key (src/repro/serving/engine.py:1149-1153): the key keys[0]
// is the draw key as it is (no split), row b's column j takes the bits of
// the flat count b * V + j (64 bits: hi, lo words), as jax's partitionable
// threefry gives gumbel(key, (B, V)), and no key is written.
//
// IEEE division (__fdiv_rn) and logf (not __logf), no contraction: the
// scores are bitwise those of the plain version on the card, whose
// torch.log is logf and whose division is a tensor division.
//
// Two launches a call, in stream order:
//   1. sample_partial_kernel  grid (chunks, B), CHUNK columns a block: each
//        thread scores its columns and keeps the first maximum; a warp
//        shuffle and one pass over the warps give the block's (max, index),
//        written to the call's (B, chunks) scratch.
//   2. sample_merge_kernel    one warp a row: the row's partials merged
//        (larger score, else smaller index: the same winner in any order),
//        the token written, and the key split in place.  Launch 1 has read
//        every key before this one writes any.
// A debug entry (sample_noise_launch) writes g for given draw keys, so that
// the noise can be held bitwise against the plain version.
//
// Bound on an H100 SXM: bytes, the B x V fp32 logits read once (8 MB at
// nemotron-4-15b's vocab, B = 8) over 3.35 TB/s.  The threefry rounds are
// some 110 integer operations a column at a temperature > 0, which the
// card's table of peak rates does not list; a greedy step skips them.

#include <climits>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int CHUNK = 4096;   // columns a block (kernels/sample.py: CHUNK)
constexpr unsigned PARITY = 0x1BD11BDAu;

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

// jax/_src/prng.py: _threefry2x32_lowering, unrolled
__device__ __forceinline__ uint2 threefry(uint2 k, unsigned x0,
                                          unsigned x1) {
  const unsigned ks[3] = {k.x, k.y, k.x ^ k.y ^ PARITY};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = x0 ^ rotl(x1, rot[i & 1][j]);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<unsigned>(i + 1);
  }
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint2 key_of(const int* keys, int b) {
  return make_uint2(static_cast<unsigned>(keys[2 * b]),
                    static_cast<unsigned>(keys[2 * b + 1]));
}

// jax.random.gumbel (mode "low") at the 64-bit count c under draw key d
__device__ __forceinline__ float gumbel_at(uint2 d, unsigned long long c) {
  const uint2 h = threefry(d, static_cast<unsigned>(c >> 32),
                           static_cast<unsigned>(c));
  const unsigned bits = ((h.x ^ h.y) >> 9) | 0x3f800000u;
  const float tiny = 1.17549435e-38f;  // finfo(float32).tiny
  const float f = __fsub_rn(__uint_as_float(bits), 1.f);
  const float u = fmaxf(tiny, __fadd_rn(f, tiny));
  return -logf(-logf(u));
}

// (score, index) a is the better of the two: larger, else first
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(v2, i2, v, i)) v = v2, i = i2;
  }
}

__global__ void __launch_bounds__(NT)
    sample_partial_kernel(const float* __restrict__ logits, long long ld,
                          int V, const float* __restrict__ temps,
                          const int* __restrict__ keys, int draw,
                          int block, float* __restrict__ part_v,
                          int* __restrict__ part_i) {
  const int b = blockIdx.y, c = blockIdx.x, n_chunks = gridDim.x;
  const float t = temps[b];
  const bool drawn = draw && t > 0.f;
  const float safe = fmaxf(t, 1e-6f);
  const uint2 d = !drawn  ? make_uint2(0, 0)
                  : block ? key_of(keys, 0)
                          : threefry(key_of(keys, b), 0u, 0u);
  const unsigned long long base =
      block ? static_cast<unsigned long long>(b) * V : 0ull;
  const float* row = logits + b * ld;
  const int lo = c * CHUNK, hi = min(V, lo + CHUNK);
  float best = -INFINITY;
  int arg = INT_MAX;
  for (int j = lo + threadIdx.x; j < hi; j += NT) {
    float s = row[j];
    if (drawn) s = __fadd_rn(gumbel_at(d, base + j), __fdiv_rn(s, safe));
    if (better(s, j, best, arg)) best = s, arg = j;
  }
  warp_best(best, arg);
  __shared__ float sv[NT / 32];
  __shared__ int si[NT / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sv[warp] = best, si[warp] = arg;
  __syncthreads();
  if (warp == 0) {
    best = lane < NT / 32 ? sv[lane] : -INFINITY;
    arg = lane < NT / 32 ? si[lane] : INT_MAX;
    warp_best(best, arg);
    if (lane == 0) {
      part_v[b * n_chunks + c] = best;
      part_i[b * n_chunks + c] = arg;
    }
  }
}

__global__ void __launch_bounds__(32)
    sample_merge_kernel(const float* __restrict__ part_v,
                        const int* __restrict__ part_i, int n_chunks,
                        int* __restrict__ keys,
                        const unsigned char* __restrict__ mask,
                        int block, int* __restrict__ tokens) {
  const int b = blockIdx.x;
  float best = -INFINITY;
  int arg = INT_MAX;
  for (int c = threadIdx.x; c < n_chunks; c += 32) {
    const float v = part_v[b * n_chunks + c];
    const int i = part_i[b * n_chunks + c];
    if (better(v, i, best, arg)) best = v, arg = i;
  }
  warp_best(best, arg);
  if (threadIdx.x == 0) {
    // a row whose scores are all NaN has no winner: index 0
    tokens[b] = arg == INT_MAX ? 0 : arg;
    if (!block && mask[b]) {
      const uint2 carry = threefry(key_of(keys, b), 0u, 1u);
      keys[2 * b] = static_cast<int>(carry.x);
      keys[2 * b + 1] = static_cast<int>(carry.y);
    }
  }
}

__global__ void __launch_bounds__(NT)
    sample_noise_kernel(const int* __restrict__ keys, int V, int block,
                        float* __restrict__ noise) {
  const int b = blockIdx.y;
  const uint2 d = key_of(keys, block ? 0 : b);
  const int j = blockIdx.x * NT + threadIdx.x;
  const unsigned long long base =
      block ? static_cast<unsigned long long>(b) * V : 0ull;
  if (j < V) noise[(size_t)b * V + j] = gumbel_at(d, base + j);
}

}  // namespace

// logits (B, V) fp32, columns contiguous, rows ld elements apart; temps (B,)
// fp32; keys (B, 2) int32 words, split in place where mask (B,) bool is
// set; tokens (B,) int32; scratch: B * ceil(V / CHUNK) floats, then as many
// int32s.  draw 0: every row greedy (the keys still split).  block 1: the
// block draw under the one draw key keys[0] (2 words, never written; mask
// unread, may be null).
extern "C" int sample_launch(const void* logits, long long ld, int B, int V,
                             const void* temps, void* keys, const void* mask,
                             int draw, int block, void* tokens, void* scratch,
                             void* stream) {
  if (B < 1 || V < 1 || ld < V || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (V + CHUNK - 1) / CHUNK;
  float* pv = static_cast<float*>(scratch);
  int* pi = reinterpret_cast<int*>(pv + (size_t)B * n_chunks);
  sample_partial_kernel<<<dim3(n_chunks, B), NT, 0, st>>>(
      static_cast<const float*>(logits), ld, V,
      static_cast<const float*>(temps), static_cast<const int*>(keys), draw,
      block, pv, pi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sample_merge_kernel<<<B, 32, 0, st>>>(
      pv, pi, n_chunks, static_cast<int*>(keys),
      static_cast<const unsigned char*>(mask), block,
      static_cast<int*>(tokens));
  return static_cast<int>(cudaGetLastError());
}

// debug entry: noise (B, V) fp32, the Gumbel noise of draw keys (B, 2), or
// with block 1 of the block draw under the one key keys[0]
extern "C" int sample_noise_launch(const void* keys, int B, int V, int block,
                                   void* noise, void* stream) {
  if (B < 1 || V < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  sample_noise_kernel<<<dim3((V + NT - 1) / NT, B), NT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), V, block, static_cast<float*>(noise));
  return static_cast<int>(cudaGetLastError());
}
