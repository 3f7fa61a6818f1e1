// quantize_kv_write on Hopper: new K (or V) span rows scattered into the
// int8 page pool in place, with the per-(page, KV head) fp32 scales kept.
//
// Replaces src/repro/core/quant.py:238 quantize_kv_write, jnp code that XLA
// compiles into the reference's jitted engine step (it is not a Pallas
// kernel).  The port's plain version, core/quant.py:quantize_kv_write, is
// about 40 eager ops a call.  Its four steps -- reset the scale of each
// page whose offset-0 row is written, scatter-max the rows' absmax / 127
// into the scales, rescale the stored rows of the rescale set by old / new,
// quantize and write the new rows -- depend on each other across blocks,
// so one call here is a memset of its scratch and three launches in stream
// order:
//
//   1. kv_scales_kernel   one block a span position.  Its page's slot (see
//        below) takes the position's per-head absmax / 127 (__fdiv_rn, the
//        plain version's one division) by atomicMax on the bit pattern,
//        which orders floats >= 0 as their values, so the max is exact and
//        the same in every order.  The slot is flagged touched, the page
//        the position resets is flagged reset (its own at offset 0, else
//        the sink, page 0: the plain version's where(off == 0, phys, 0)),
//        and 1 + the position is maxed into the (slot, offset) writer, so
//        the last position naming a (page, offset) writes it.
//   2. kv_rescale_kernel  one block a slot.  A flagged slot computes its
//        page's scale before (0 where reset) and after (the max with its
//        candidates), stores the new one, and, for a page of the rescale
//        set, rescales the stored rows by old / new (__fdiv_rn, then
//        __fmul_rn and rintf, round half to even); a head whose ratio is
//        exactly 1.0 is left alone, since round(q * 1.0) == q, and one
//        whose ratio is 0 (its old scale was 0: a reset or never-written
//        page) is zeroed without reading its rows, since round(q * 0) == 0.
//   3. kv_store_kernel    one block a span position, the writer of its
//        (page, offset) only: the row quantized under the final scale
//        (rintf of __fdiv_rn, clamped to +-127) into the page, as an
//        index_put resolves duplicates on the CPU (the last one wins).
//
// A slot gathers one page's work: rescale-set entry j for the first j that
// names the page; else, for the sink, slot B*K; else B*K + 1 + the first
// position that names the page (a page outside the rescale set, which the
// model never passes: its scale moves, its stored rows do not, as in the
// plain version).  Only the first entry of a page is ever flagged, so a
// page listed twice in the rescale set (the sink, a shared page, a
// clamped column at the end of the page table) is done once, whatever its
// ratio.  No division or multiply is contracted or reassociated, so pages
// and scales are bitwise the plain version's.
//
// Bound on an H100 SXM: bytes -- the span rows, the int8 rows written, the
// scales of the touched pages, the stored rows of each rescale-set head
// whose scale grew from a nonzero one, read and written, and those of each
// whose old scale was 0, written -- over 3.35 TB/s.  At decode a call moves
// a few tens of KB: its four nodes' latency bounds it, and the engine's
// CUDA graph keeps their issue off the host.

#include <climits>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr float KV_QMAX = 127.f;

// One call's shape, as kernels/kv_write.py packs it: B x S span positions
// (rows (B, S, KV, hd)), a (B, K) rescale set, pages (P, pg, KV, hd), and
// the rows' dtype code.
struct Args {
  int B, S, K, KV, hd, pg, P, rows_dtype;
};

// The call's int32 scratch, E = B*K + 1 + B*S slots; all but ``slot`` are
// zeroed before launch 1 (kernels/kv_write.py: scratch_words).
struct Scratch {
  unsigned* cand;  // (E, KV): candidate scale bits, then the final scales
  int* flag;       // (E,): 1 reset, 2 touched
  int* writer;     // (E, pg): 1 + the last position writing (page, offset)
  int* slot;       // (B*S,): each position's slot
};

// the slot of a page that no rescale-set entry names: the sink's own, or
// that of the first position naming the page (one thread; the model never
// passes such a page but the sink)
__device__ __forceinline__ int slot_beyond(long long page, int n_rp,
                                           const long long* phys, int i) {
  if (page == 0) return n_rp;
  for (int j = 0; j < i; ++j)
    if (phys[j] == page) return n_rp + 1 + j;
  return n_rp + 1 + i;
}

// atomicMax / atomicOr after a read that finds them needed: the values
// only grow within a launch, so a read that is not below the value skips
// a contended atomic (the sink's slot takes every padding position's)
__device__ __forceinline__ void grow(unsigned* at, unsigned v) {
  if (__ldcg(at) < v) atomicMax(at, v);
}
__device__ __forceinline__ void grow(int* at, int v) {
  if (__ldcg(at) < v) atomicMax(at, v);
}
__device__ __forceinline__ void set_bits(int* at, int bits) {
  if ((__ldcg(at) & bits) != bits) atomicOr(at, bits);
}

template <typename RT>
__global__ void __launch_bounds__(NT)
    kv_scales_kernel(const RT* __restrict__ rows, long long sb, long long ss,
                     const long long* __restrict__ phys,
                     const long long* __restrict__ off,
                     const long long* __restrict__ rp, Scratch w, Args a) {
  const int i = blockIdx.x;
  const int n_rp = a.B * a.K;
  const long long p = phys[i], o = off[i];
  // the first rescale-set entries naming the page and the sink, found by
  // the whole block
  __shared__ int first[2];
  if (threadIdx.x < 2) first[threadIdx.x] = INT_MAX;
  __syncthreads();
  for (int j = threadIdx.x; j < n_rp; j += NT) {
    const long long r = rp[j];
    if (r == p) atomicMin(&first[0], j);
    if (r == 0) atomicMin(&first[1], j);
  }
  __syncthreads();
  const int s = first[0] < INT_MAX ? first[0] : slot_beyond(p, n_rp, phys, i);
  if (threadIdx.x == 0) {
    if (p < 0 || p >= a.P || o < 0 || o >= a.pg) __trap();
    const int sink = first[1] < INT_MAX ? first[1] : n_rp;
    w.slot[i] = s;
    set_bits(&w.flag[s], 2);
    set_bits(&w.flag[o == 0 ? s : sink], 1);
    grow(&w.writer[(size_t)s * a.pg + o], i + 1);
  }
  const int b = i / a.S;
  const RT* row = rows + b * sb + (i - b * a.S) * ss;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kv = warp; kv < a.KV; kv += NT / 32) {
    float m = 0.f;
    for (int d = lane; d < a.hd; d += 32)
      m = fmaxf(m, fabsf(to_f(row[kv * a.hd + d])));
    for (int sh = 16; sh > 0; sh >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, sh));
    if (lane == 0)
      grow(&w.cand[(size_t)s * a.KV + kv],
           __float_as_uint(__fdiv_rn(m, KV_QMAX)));
  }
}

__device__ __forceinline__ signed char rescaled(signed char q, float r) {
  return static_cast<signed char>(
      rintf(__fmul_rn(static_cast<float>(q), r)));
}

// 16-byte units a thread rescales with all its loads issued before its
// stores
constexpr int UNITS = 4;

__global__ void __launch_bounds__(NT)
    kv_rescale_kernel(int8_t* __restrict__ pages, float* __restrict__ scales,
                      const long long* __restrict__ rp,
                      const long long* __restrict__ phys, Scratch w,
                      Args a) {
  extern __shared__ float ratio[];  // (KV,)
  const int e = blockIdx.x;
  const int n_rp = a.B * a.K;
  const int fl = w.flag[e];
  if (fl == 0) return;  // a later duplicate, or a page nothing touched
  const long long p = e < n_rp ? rp[e] : e == n_rp ? 0 : phys[e - n_rp - 1];
  if (p < 0 || p >= a.P) __trap();
  for (int kv = threadIdx.x; kv < a.KV; kv += NT) {
    const float s0 = (fl & 1) ? 0.f : scales[p * a.KV + kv];
    const float c = __uint_as_float(w.cand[(size_t)e * a.KV + kv]);
    const float s1 = c > s0 ? c : s0;
    ratio[kv] = s1 > 0.f ? __fdiv_rn(s0, s1) : 1.f;
    scales[p * a.KV + kv] = s1;
    w.cand[(size_t)e * a.KV + kv] = __float_as_uint(s1);
  }
  if (e >= n_rp) return;  // outside the rescale set: stored rows stay
  __syncthreads();
  int8_t* page = pages + (size_t)p * a.pg * a.KV * a.hd;
  const int n = a.pg * a.KV * a.hd;
  if (a.hd % 16 == 0 && reinterpret_cast<size_t>(page) % 16 == 0) {
    int4* p16 = reinterpret_cast<int4*>(page);
    for (int x0 = threadIdx.x; x0 < n / 16; x0 += UNITS * NT) {
      int4 v[UNITS];
      float r[UNITS];
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int x = x0 + u * NT;
        r[u] = x < n / 16 ? ratio[(16 * x / a.hd) % a.KV] : 1.f;
        if (r[u] != 1.f && r[u] != 0.f) v[u] = p16[x];
      }
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        if (r[u] == 1.f) continue;
        if (r[u] == 0.f) {
          p16[x0 + u * NT] = make_int4(0, 0, 0, 0);
          continue;
        }
        signed char* q = reinterpret_cast<signed char*>(&v[u]);
#pragma unroll
        for (int k = 0; k < 16; ++k) q[k] = rescaled(q[k], r[u]);
        p16[x0 + u * NT] = v[u];
      }
    }
  } else {
    for (int x = threadIdx.x; x < n; x += NT) {
      const float r = ratio[(x / a.hd) % a.KV];
      if (r == 0.f)
        page[x] = 0;
      else if (r != 1.f)
        page[x] = rescaled(page[x], r);
    }
  }
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

__device__ __forceinline__ signed char quantized(float x, float s1) {
  const float q = rintf(__fdiv_rn(x, s1 > 0.f ? s1 : 1.f));
  return static_cast<signed char>(fminf(fmaxf(q, -KV_QMAX), KV_QMAX));
}

template <typename RT>
__global__ void __launch_bounds__(NT)
    kv_store_kernel(int8_t* __restrict__ pages, const RT* __restrict__ rows,
                    long long sb, long long ss,
                    const long long* __restrict__ phys,
                    const long long* __restrict__ off, Scratch w, Args a) {
  const int i = blockIdx.x;
  const int s = w.slot[i];
  const long long o = off[i];
  if (w.writer[(size_t)s * a.pg + o] != i + 1) return;  // a later one writes
  const int b = i / a.S;
  const RT* row = rows + b * sb + (i - b * a.S) * ss;
  const unsigned* sc = w.cand + (size_t)s * a.KV;
  int8_t* dst = pages + ((size_t)phys[i] * a.pg + o) * a.KV * a.hd;
  const int n = a.KV * a.hd;
  if (a.hd % 4 == 0 && reinterpret_cast<size_t>(row) % (4 * sizeof(RT)) == 0
      && reinterpret_cast<size_t>(dst) % 4 == 0) {
    for (int x = 4 * threadIdx.x; x < n; x += 4 * NT) {
      float v[4];
      load4(row + x, v);
      const float s1 = __uint_as_float(sc[x / a.hd]);
      char4 q;
      q.x = quantized(v[0], s1);
      q.y = quantized(v[1], s1);
      q.z = quantized(v[2], s1);
      q.w = quantized(v[3], s1);
      *reinterpret_cast<char4*>(dst + x) = q;
    }
  } else {
    for (int x = threadIdx.x; x < n; x += NT)
      dst[x] = quantized(to_f(row[x]), __uint_as_float(sc[x / a.hd]));
  }
}

template <typename RT>
int launch(void* pages, void* scales, const long long* phys,
           const long long* off, const long long* rp, const void* rows,
           long long sb, long long ss, int* scratch, const Args& a,
           cudaStream_t st) {
  const long long n = (long long)a.B * a.S;
  const long long n_rp = (long long)a.B * a.K;
  const long long E = n_rp + 1 + n;
  if (a.B < 1 || a.S < 1 || a.K < 1 || a.KV < 1 || a.hd < 1 || a.pg < 1 ||
      a.P < 1 || E > (1LL << 30) || (size_t)a.KV * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch w{reinterpret_cast<unsigned*>(scratch),
                  scratch + E * a.KV, scratch + E * (a.KV + 1),
                  scratch + E * (a.KV + 1 + a.pg)};
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(int) * (size_t)E * (a.KV + 1 + a.pg), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RT* r = static_cast<const RT*>(rows);
  int8_t* pg8 = static_cast<int8_t*>(pages);
  kv_scales_kernel<RT><<<static_cast<unsigned>(n), NT, 0, st>>>(
      r, sb, ss, phys, off, rp, w, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_rescale_kernel<<<static_cast<unsigned>(E), NT, a.KV * sizeof(float),
                      st>>>(
      pg8, static_cast<float*>(scales), rp, phys, w, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_store_kernel<RT><<<static_cast<unsigned>(n), NT, 0, st>>>(
      pg8, r, sb, ss, phys, off, w, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pages (P, pg, KV, hd) int8 and scales (P, KV) fp32, both contiguous and
// written in place; phys / off (B, S) and rescale_phys (B, K) int64,
// contiguous; rows (B, S, KV, hd) fp32 or bf16, each position's (KV, hd)
// contiguous, positions at strides sb (batch) and ss (span), in elements;
// scratch: kernels/kv_write.py:scratch_words int32s; args: Args.
extern "C" int kv_write_launch(void* pages, void* scales, const void* phys,
                               const void* off, const void* rescale_phys,
                               const void* rows, long long sb, long long ss,
                               void* scratch, const int* args,
                               void* stream) {
  const Args a{args[0], args[1], args[2], args[3],
               args[4], args[5], args[6], args[7]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* ph = static_cast<const long long*>(phys);
  const long long* of = static_cast<const long long*>(off);
  const long long* rp = static_cast<const long long*>(rescale_phys);
  int* sc = static_cast<int*>(scratch);
  if (a.rows_dtype == DT_F32)
    return launch<float>(pages, scales, ph, of, rp, rows, sb, ss, sc, a, st);
  if (a.rows_dtype == DT_BF16)
    return launch<__nv_bfloat16>(pages, scales, ph, of, rp, rows, sb, ss,
                                 sc, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
