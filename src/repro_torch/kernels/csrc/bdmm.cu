// One block-diagonal Monarch stage on Hopper: out[t, j, :] = x[t, j, :] . W[j]^T.
// Replaces the Pallas kernels ``bdmm`` / ``_bdmm_kernel`` (float blocks) and
// ``bdmm_q`` / ``_bdmm_q_kernel`` (int8 or nibble-packed int4 blocks with one
// fp32 scale per block) of repro/kernels/bdmm.py.  They are the staged branch
// of the Monarch product: stage 1 reads x, stage 2 the stage-1 output through
// a transposed view, so its reduction axis has stride q.
//
// x: (T, k, p) with arbitrary strides, w: (k, q, p) contiguous, or wq (k, q,
// p[/2]) int8 with scale (k,) fp32 -> out: (T, k, q) contiguous in x's dtype.
//
// Two instances, chosen and sized by kernels/bdmm.py:bdmm_geometry from the
// shapes alone (never from the weights' dtype, so the quantized kernel sums in
// the float kernel's order):
//
//   decode (T <= TMAX tokens).  Bound by the weight bytes (each weight feeds T
//     products) and, at the 128-block shapes, by one launch's chain of
//     latencies.  A block owns a group of G diagonal blocks and a slab of
//     rows of each, one pass: every row gets a group of ``lanes`` lanes, lane
//     l takes the row's units l, l + lanes, ... (UNIT = 4 consecutive values,
//     one 16/8/4/2-byte load for fp32/bf16/int8/int4 weights; single values
//     where 4 does not divide p), and issues those loads first, straight into
//     registers, so they are in flight while x[:, j0:j0+G, :] is staged in
//     shared memory as fp32 (G, T, p), read along its contiguous axis (p, or
//     the blocks for stage 2's transposed input).  Lanes of one row sum with a
//     reduce-scatter butterfly (9 shuffles for 32 lanes and 8 tokens, not 40)
//     and each lane stores its tokens.  The lanes a row grow with the block's
//     row count shrinking (up to 32 for 8-row blocks) so that a block's warps
//     have rows; diagonal blocks are packed several to a block only where even
//     32 lanes a row leave lane groups idle.
//   prefill (larger T).  Bound by operations.  A block owns a tile of 32 * mw
//     tokens, G diagonal blocks and a slab of 8 * nt * nw rows of each; its 8
//     warps are laid out G x mw x nw, each with a 32-token x (8 * nt)-row
//     register tile of the output.  p is walked in chunks of KC values through
//     a ring of NSTAGE shared-memory buffers, NSTAGE - 1 chunks ahead, one
//     barrier a chunk: W rows (and x rows, where p is x's contiguous axis) are
//     copied raw with cp.async, zero-filled past p; stage 2's transposed input
//     is read as runs of the group's G blocks (one 4-16 byte load per token
//     and value, scattered into the rows), which is why the traffic model of
//     bdmm_geometry gives it 8 blocks a tile.  The warps multiply with
//     mma.sync m16n8k8 TF32 on the tensor cores, widening (and dequantizing)
//     each operand as its fragment is read.  Each fp32 operand a is split as
//     a = big + small, both TF32 rounded to nearest (cvt.rna), and a . b =
//     small_a big_b + big_a small_b + big_a big_b with fp32 accumulation
//     ("3xTF32": the dropped small . small term is below 2^-22 of the
//     product), so the result holds fp32 2e-5 of the plain version.  A bf16 x
//     is exact in TF32: its small part is zero and that pass is skipped (2
//     products).  The output tile goes through shared memory and leaves as
//     contiguous 16-byte stores.  W[j] is never staged whole, so any block
//     size fits; each W[j] is read once per token tile.
//
// Both instances: no split of the p axis across blocks and no atomics, so a
// launch is deterministic; the ragged edges of T, p, q and k are masked (zeros
// in shared memory, no store), never padded in device memory.  A quantized
// weight is widened as float(v) * scale[j] (one __fmul_rn, as in
// core.quant.dequantize_factor and common.cuh) where it is read, and then runs
// the float kernel's arithmetic on the same values in the same order, so
// bdmm_q is bitwise bdmm on the dequantized blocks.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NTH = 256;    // threads a block (kernels/bdmm.py: THREADS)
constexpr int TMAX = 16;    // most tokens of the decode instance (DECODE_MAX_T)
constexpr int UBATCH = 8;   // units a decode lane has in flight
constexpr int KC = 16;      // p values of one prefill chunk (PREFILL_KC)
constexpr int LKC = 4;      // log2(KC)

// n / d for a divisor fixed for the launch and 0 <= n < 2^31 (division by an
// invariant integer: one multiply-high, an add and a shift); the magic
// numbers are made on the host (fast_div), once a launch
struct FastDiv {
  unsigned m, s;
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>((__umulhi(static_cast<unsigned>(n), m) +
                             static_cast<unsigned>(n)) >> s);
  }
};

FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  return FastDiv{
      static_cast<unsigned>(((1ull << 32) * ((1ull << s) - d)) / d + 1), s};
}

// ---------------------------------------------------------------------------
// decode: UNIT consecutive values of row r of block blk from value v0, widened
// (and dequantized); ``vec``: the weights' base address allows one load a unit

template <int UNIT>
__device__ __forceinline__ void load_unit(const FloatBlocks<float>& w, int blk,
                                          int r, int v0, bool vec, float,
                                          float* o) {
  const float* src = reinterpret_cast<const float*>(w.row(blk, r)) + v0;
  if (UNIT == 4 && vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    o[0] = a.x;
    o[1] = a.y;
    o[2] = a.z;
    o[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < UNIT; ++i) o[i] = __ldg(src + i);
  }
}

template <int UNIT>
__device__ __forceinline__ void load_unit(
    const FloatBlocks<__nv_bfloat16>& w, int blk, int r, int v0, bool vec,
    float, float* o) {
  const __nv_bfloat16* src =
      reinterpret_cast<const __nv_bfloat16*>(w.row(blk, r)) + v0;
  if (UNIT == 4 && vec) {
    // a bf16 value is the top half of its fp32 widening
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(src));
    o[0] = __uint_as_float(a.x << 16);
    o[1] = __uint_as_float(a.x & 0xffff0000u);
    o[2] = __uint_as_float(a.y << 16);
    o[3] = __uint_as_float(a.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < UNIT; ++i) o[i] = __bfloat162float(src[i]);
  }
}

template <int UNIT>
__device__ __forceinline__ void load_unit(const QuantBlocks<8>& w, int blk,
                                          int r, int v0, bool vec, float sc,
                                          float* o) {
  const int8_t* src = reinterpret_cast<const int8_t*>(w.row(blk, r)) + v0;
  if (UNIT == 4 && vec) {
    const unsigned a =
        static_cast<unsigned>(__ldg(reinterpret_cast<const int*>(src)));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = static_cast<int>(a << (24 - 8 * i)) >> 24;  // byte i
      o[i] = __fmul_rn(static_cast<float>(v), sc);
    }
  } else {
#pragma unroll
    for (int i = 0; i < UNIT; ++i)
      o[i] = __fmul_rn(static_cast<float>(src[i]), sc);
  }
}

template <int UNIT>
__device__ __forceinline__ void load_unit(const QuantBlocks<4>& w, int blk,
                                          int r, int v0, bool vec, float sc,
                                          float* o) {
  const char* row = w.row(blk, r);
  if (UNIT == 4 && vec) {
    // 4 values in 2 bytes: value i is nibble i, the even index low
    const unsigned a = __ldg(
        reinterpret_cast<const unsigned short*>(row + (v0 >> 1)));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = static_cast<int>(((a >> (4 * i)) & 0xFu) ^ 8u) - 8;
      o[i] = __fmul_rn(static_cast<float>(v), sc);
    }
  } else {
#pragma unroll
    for (int i = 0; i < UNIT; ++i) o[i] = QuantBlocks<4>::at(row, v0 + i, sc);
  }
}

template <int UNIT, int TM, typename XT, typename W>
__global__ void __launch_bounds__(NTH, 3)
    bdmm_decode_kernel(const XT* __restrict__ x, W w, XT* __restrict__ out,
                       int T, int k, int q, int p, int G, int slab, int lanes,
                       int vec, int by_block, FastDiv d_inner, FastDiv d_mid,
                       FastDiv d_slab, long long sx_t, long long sx_j,
                       long long sx_p) {
  extern __shared__ __align__(16) float xs[];  // (G, T, ldx) fp32
  const int ldx = (p + 3) & ~3;
  const int nslab = (q + slab - 1) / slab;
  const int sl = blockIdx.x % nslab, grp = blockIdx.x / nslab;
  const int j0 = grp * G, n0 = sl * slab;
  const int ng = min(G, k - j0);    // live diagonal blocks
  const int ns = min(slab, q - n0);  // live rows of each

  // thread -> row (gg, n) of the block's G x slab rows, ``lanes`` lanes a
  // row: the geometry gives every row a group of lanes (one pass)
  const int li = threadIdx.x & (lanes - 1);
  const int r = threadIdx.x / lanes;
  const int gg = d_slab.div(r), n = r - gg * slab;
  const bool live = gg < ng && n < ns;
  const int blk = live ? j0 + gg : j0;
  const int nu = p / UNIT;
  const float sc = w.scale_of(blk);

  // the first UBATCH of this lane's units (li, li + lanes, ...), in flight
  // while x is staged
  float wv[UBATCH][UNIT];
#pragma unroll
  for (int b = 0; b < UBATCH; ++b) {
    const int u = li + b * lanes;
    if (live && u < nu)
      load_unit<UNIT>(w, blk, n0 + n, u * UNIT, vec, sc, wv[b]);
  }

  // x[:, j0:j0+ng, :] -> xs as fp32, along the axis that is contiguous in
  // memory (the blocks, for an x whose p axis is strided), 8 loads in
  // flight a thread
  const int total = G * T * p;
  for (int e0 = threadIdx.x; e0 < total; e0 += 8 * NTH) {
    float v[8];
    int at[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + i * NTH;
      at[i] = -1;
      if (e < total) {
        const int r1 = d_inner.div(e), i0 = e - r1 * (by_block ? G : p);
        const int i2 = d_mid.div(r1), i1 = r1 - i2 * (by_block ? p : T);
        // by_block: (gg, pp, t) = (i0, i1, i2); else (pp, t, gg)
        const int bg = by_block ? i0 : i2, pp = by_block ? i1 : i0,
                  t = by_block ? i2 : i1;
        if (bg < ng) {
          v[i] = to_f(x[t * sx_t + (j0 + bg) * sx_j + pp * sx_p]);
          at[i] = (bg * T + t) * ldx + pp;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (at[i] >= 0) xs[at[i]] = v[i];
  }
  __syncthreads();

  float acc[TM];
#pragma unroll
  for (int t = 0; t < TM; ++t) acc[t] = 0.f;
  if (live) {
    const float* xb = xs + gg * T * ldx;
    for (int u0 = li;; u0 += lanes * UBATCH) {
#pragma unroll
      for (int b = 0; b < UBATCH; ++b) {
        const int u = u0 + b * lanes;
        if (u < nu) {
          const float* xu = xb + u * UNIT;
#pragma unroll
          for (int t = 0; t < TM; ++t) {
            if (t < T) {
              if (UNIT == 4) {
                const float4 xv =
                    *reinterpret_cast<const float4*>(xu + t * ldx);
                acc[t] = fmaf(xv.x, wv[b][0], acc[t]);
                acc[t] = fmaf(xv.y, wv[b][1], acc[t]);
                acc[t] = fmaf(xv.z, wv[b][2], acc[t]);
                acc[t] = fmaf(xv.w, wv[b][3], acc[t]);
              } else {
                acc[t] = fmaf(xu[t * ldx], wv[b][0], acc[t]);
              }
            }
          }
        }
      }
      if (u0 + lanes * UBATCH >= nu) break;
      // the next batch (rows of more than lanes * UBATCH units)
#pragma unroll
      for (int b = 0; b < UBATCH; ++b) {
        const int u = u0 + lanes * UBATCH + b * lanes;
        if (u < nu) load_unit<UNIT>(w, blk, n0 + n, u * UNIT, vec, sc, wv[b]);
      }
    }
  }
  // Sum each row's lanes with a reduce-scatter butterfly from the lowest
  // lane bit up: at level L (partner lane ^ 2^L) a lane keeps half of its c
  // sums, the upper half where its bit L is set, and adds the partner's
  // copy of that half (c / 2 shuffles); once one sum is left, the remaining
  // levels add it whole.  The active levels are L < log2(lanes), a prefix,
  // so each level's c is known when compiled.  A lane ends with the sums of
  // tokens tb .. tb + TM / lanes - 1 (one token where lanes >= TM, held by
  // every lane of equal low bits).
  int tb = 0;
#pragma unroll
  for (int L = 0; L < 5; ++L) {
    const int o = 1 << L, c = TM >> L;
    if (o >= lanes) break;
    if (c > 1) {
      const bool up = li & o;
#pragma unroll
      for (int i = 0; i < c / 2; ++i) {
        const float send = up ? acc[i] : acc[i + c / 2];
        const float keep = up ? acc[i + c / 2] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      if (up) tb += c / 2;
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
    }
  }
  if (live && (lanes < TM || li < TM)) {
    const int held = lanes < TM ? TM / lanes : 1;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if (i < held && tb + i < T)
        out[((size_t)(tb + i) * k + blk) * q + n0 + n] = from_f<XT>(acc[i]);
  }
}

// ---------------------------------------------------------------------------
// prefill: 3xTF32 on the tensor cores

// v rounded to nearest TF32 (ties away from zero); the low 13 bits cleared
__device__ __forceinline__ unsigned tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// d += a . b for a 16x8 A (row), an 8x8 B (col), fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of ``n`` bytes of a ``N``-byte unit, the rest zero-filled
template <int N>
__device__ __forceinline__ void cp_async_fill(void* dst, const void* src,
                                              int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(n)
                 : "memory");
}

// one unit of ``vec`` bytes (16, 8, 4: asynchronous; 1: a plain byte), of
// which the first n come from src and the rest are zero
__device__ __forceinline__ void copy_unit(char* dst, const char* src, int vec,
                                          int n) {
  if (vec == 16)
    cp_async_fill<16>(dst, src, n);
  else if (vec == 8)
    cp_async_fill<8>(dst, src, n);
  else if (vec == 4)
    cp_async_fill<4>(dst, src, n);
  else
    *dst = n > 0 ? *src : 0;
}

// Shared memory of one prefill block; kernels/bdmm.py:_prefill_smem is the
// same formula.  A buffer holds one chunk: the x rows (gg, m) of KC raw x
// values and the W rows (gg, n) of KC raw weights (wcb bytes), each row
// followed by PAD bytes; a ring of NSTAGE buffers, fewer when p takes fewer
// chunks.  After the last chunk the same memory holds the output tile, rows
// (gg, m) of bn values in x's type, for coalesced stores.
constexpr int PAD = 16;
constexpr int NSTAGE = 3;
struct PLayout {
  int xrow, wrow, orow, nbuf;
  size_t xbytes, buf, total;
};

__host__ __device__ inline PLayout playout(int G, int bm, int bn, int p,
                                           int xb, int wcb) {
  PLayout o;
  o.xrow = KC * xb + PAD;
  o.wrow = wcb + PAD;
  o.orow = bn * xb + PAD;
  o.xbytes = r16((size_t)G * bm * o.xrow);
  o.buf = o.xbytes + r16((size_t)G * bn * o.wrow);
  o.nbuf = min(NSTAGE, (p + KC - 1) / KC);
  o.total = o.nbuf * o.buf;
  const size_t out_tile = r16((size_t)G * bm * o.orow);
  if (out_tile > o.total) o.total = out_tile;
  return o;
}

// ``n`` (4, 8 or 16) bytes from global memory as four words
__device__ __forceinline__ uint4 load_piece(const char* src, int n) {
  if (n == 16) return __ldg(reinterpret_cast<const uint4*>(src));
  if (n == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    return make_uint4(v.x, v.y, 0u, 0u);
  }
  return make_uint4(__ldg(reinterpret_cast<const unsigned*>(src)), 0u, 0u, 0u);
}

template <typename XT, typename W>
__global__ void __launch_bounds__(NTH, 2)
    bdmm_prefill_kernel(const XT* __restrict__ x, W w, XT* __restrict__ out,
                        int T, int k, int q, int p, int G, int bm, int bn,
                        int mw, int nw, int nt, long long sx_t, long long sx_j,
                        long long sx_p) {
  // the x operand's small halves are kept only for an fp32 x
  constexpr bool XSPLIT = std::is_same<XT, float>::value;
  constexpr int xb = sizeof(XT);
  extern __shared__ __align__(16) char sm[];
  const int wrb = w.row_bytes();
  const int wcb = KC * wrb / p;  // bytes of KC weights (int4: p even)
  const PLayout lay = playout(G, bm, bn, p, xb, wcb);

  // block -> (token tile, group of diagonal blocks, slab), slab fastest
  const int nslab = (q + bn - 1) / bn, ngrp = (k + G - 1) / G;
  int b = blockIdx.x;
  const int sl = b % nslab;
  b /= nslab;
  const int t0 = (b / ngrp) * bm, j0 = (b % ngrp) * G, n0 = sl * bn;
  const int lg = __ffs(G) - 1, lbm = __ffs(bm) - 1, lbn = __ffs(bn) - 1;
  const int nchunks = (p + KC - 1) / KC;
  const char* xg = reinterpret_cast<const char*>(x);

  // W rows are contiguous: cp.async in the widest unit the addresses allow
  const int vw = vec_of(reinterpret_cast<size_t>(w.row(0, 0)) |
                        static_cast<size_t>(wrb) | static_cast<size_t>(wcb));
  const int lw = __ffs(wcb / vw) - 1;  // units a row: a power of two
  // x: rows along p (cp.async) where p is its contiguous axis; runs of the
  // group's G blocks (one load of 4-16 bytes a piece, then scattered into
  // the rows) where the blocks are (stage 2's transposed input) and the
  // group is whole; else value by value
  const int xmode = sx_p == 1 ? 0 : (sx_j == 1 && G * xb >= 4 && j0 + G <= k)
                                        ? 1 : 2;
  const int vx = vec_of(reinterpret_cast<size_t>(x) |
                        static_cast<size_t>(sx_t * xb) |
                        static_cast<size_t>((xmode == 0 ? sx_j : sx_p) * xb) |
                        static_cast<size_t>(xmode == 0 ? KC * xb : G * xb));
  const int lx = __ffs(KC * xb / vx) - 1;
  const int pb = min(16, G * xb);  // bytes of one piece of a run
  const int npc = G * xb / pb;     // pieces a run: 1 or 2
  const bool runs = xmode == 1 && vx >= pb;

  // chunk c into buffer bi: W (and x rows) asynchronously, x runs or values
  // synchronously
  auto issue = [&](int c, int bi) {
    char* buf = sm + bi * lay.buf;
    const int vv = min(KC, p - c * KC);  // values of the chunk within p
    const int wvalid = vv * wrb / p;
    for (int u = threadIdx.x; u < (G * bn) << lw; u += NTH) {
      const int row = u >> lw, o = (u - (row << lw)) * vw;
      const int j = j0 + (row >> lbn), r = n0 + (row & (bn - 1));
      const bool ok = j < k && r < q;
      copy_unit(buf + lay.xbytes + row * lay.wrow + o,
                ok ? w.row(j, r) + c * wcb + o : w.row(0, 0), vw,
                ok ? max(0, min(vw, wvalid - o)) : 0);
    }
    if (xmode == 0) {
      for (int u = threadIdx.x; u < (G * bm) << lx; u += NTH) {
        const int row = u >> lx, o = (u - (row << lx)) * vx;
        const int t = t0 + (row & (bm - 1)), j = j0 + (row >> lbm);
        const bool ok = t < T && j < k;
        copy_unit(buf + row * lay.xrow + o,
                  ok ? xg + (t * sx_t + j * sx_j + c * KC) * xb + o : xg,
                  vx, ok ? max(0, min(vx, vv * xb - o)) : 0);
      }
    } else if (runs) {
      // piece f: run (m, kk) = x[t0 + m, j0:j0+G, c*KC + kk], piece f % npc
      const int npieces = bm * KC * npc;
      for (int f0 = threadIdx.x; f0 < npieces; f0 += 4 * NTH) {
        uint4 v[4];
        int at[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int f = f0 + i * NTH;
          const int pc = f & (npc - 1), run = f / npc;
          const int kk = run & (KC - 1), m = run >> LKC;
          const int t = t0 + m, pp = c * KC + kk;
          at[i] = f < npieces ? (pc * pb / xb * bm + m) * lay.xrow + kk * xb
                              : -1;
          v[i] = make_uint4(0u, 0u, 0u, 0u);
          if (f < npieces && t < T && pp < p)
            v[i] = load_piece(xg + (t * sx_t + j0 + pp * sx_p) * xb + pc * pb,
                              pb);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (at[i] < 0) continue;
          const unsigned wd[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
          // value e of the piece is block pc * pb / xb + e: row + e * bm
#pragma unroll
          for (int e = 0; e < 16 / xb; ++e) {
            if (e * xb >= pb) break;
            const unsigned word = wd[e * xb / 4];
            char* d = buf + at[i] + e * bm * lay.xrow;
            if (xb == 4)
              *reinterpret_cast<unsigned*>(d) = word;
            else
              *reinterpret_cast<unsigned short*>(d) =
                  static_cast<unsigned short>(word >> (16 * (e & 1)));
          }
        }
      }
    } else {
      const int nx = G * bm * KC;
      for (int f0 = threadIdx.x; f0 < nx; f0 += 4 * NTH) {
        XT v[4];
        int at[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int f = f0 + i * NTH;
          const int kk = f & (KC - 1), m = (f >> LKC) & (bm - 1),
                    gg = f >> (LKC + lbm);
          const int t = t0 + m, j = j0 + gg, pp = c * KC + kk;
          at[i] = f < nx ? (gg * bm + m) * lay.xrow + kk * xb : -1;
          v[i] = from_f<XT>(0.f);
          if (f < nx && t < T && j < k && pp < p)
            v[i] = x[t * sx_t + j * sx_j + pp * sx_p];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (at[i] >= 0) *reinterpret_cast<XT*>(buf + at[i]) = v[i];
      }
    }
  };

  // warp -> (block gw of the group, 32 tokens wm, 8 * nt rows wn)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % nw, wm = (warp / nw) % mw, gw = warp / (nw * mw);
  const int gq = lane >> 2, tg = lane & 3;
  const float sc = w.scale_of(min(j0 + gw, k - 1));
  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][c][e] = 0.f;

  // a ring of nbuf buffers: chunk c in buffer c % nbuf, issued nbuf - 1
  // chunks ahead into the buffer whose chunk every warp has finished (one
  // barrier a chunk)
  const int nbuf = lay.nbuf, ahead = max(1, nbuf - 1);
  for (int c = 0; c < ahead; ++c) {
    issue(c, c);
    cp_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    if (ahead == 2)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();  // chunk c is in buffer c % nbuf; chunk c - 1 is done
    if (nbuf > 1 && c + ahead < nchunks) issue(c + ahead, (c + ahead) % nbuf);
    cp_commit();  // maybe empty: one group a chunk keeps the count
    const char* buf = sm + (c % nbuf) * lay.buf;
    const char* xw = buf + (gw * bm + wm * 32) * lay.xrow;
    const char* ww = buf + lay.xbytes + (gw * bn + wn * nt * 8) * lay.wrow;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 8) {
      if (c * KC + ks >= p) break;  // the chunk's zero tail
      unsigned ab[2][4], as[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        // A fragment: (row gq, col tg), (gq + 8, tg), (gq, tg + 4),
        // (gq + 8, tg + 4) of the warp's 16-row tile a
        const XT* r0 =
            reinterpret_cast<const XT*>(xw + (a * 16 + gq) * lay.xrow) + ks +
            tg;
        const XT* r8 = reinterpret_cast<const XT*>(
                           xw + (a * 16 + gq + 8) * lay.xrow) +
                       ks + tg;
        const float v[4] = {to_f(r0[0]), to_f(r8[0]), to_f(r0[4]),
                            to_f(r8[4])};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[a][e] = XSPLIT ? tf32(v[e]) : __float_as_uint(v[e]);
          as[a][e] = XSPLIT ? tf32(v[e] - __uint_as_float(ab[a][e])) : 0u;
        }
      }
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        if (bb < nt) {
          // B fragment: (k tg, col gq), (k tg + 4, col gq) of rows 8 bb ..
          const char* rw = ww + (bb * 8 + gq) * lay.wrow;
          const float w0 = W::at(rw, ks + tg, sc);
          const float w1 = W::at(rw, ks + tg + 4, sc);
          const unsigned b0 = tf32(w0), b1 = tf32(w1);
          const unsigned s0 = tf32(w0 - __uint_as_float(b0));
          const unsigned s1 = tf32(w1 - __uint_as_float(b1));
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            if (XSPLIT) mma_tf32(acc[a][bb], as[a], b0, b1);
            mma_tf32(acc[a][bb], ab[a], s0, s1);
            mma_tf32(acc[a][bb], ab[a], b0, b1);
          }
        }
      }
    }
  }

  // the output tile through shared memory: C fragment (row gq, cols 2 tg,
  // 2 tg + 1) and (row gq + 8, the same cols) into rows (gg, m) of bn values,
  // then each row's live values stored as contiguous 16-byte units
  __syncthreads();  // every warp is done with the last chunk
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      if (bb >= nt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        XT* o = reinterpret_cast<XT*>(
                    sm + (gw * bm + wm * 32 + a * 16 + gq + 8 * h) * lay.orow) +
                wn * nt * 8 + bb * 8 + 2 * tg;
        o[0] = from_f<XT>(acc[a][bb][2 * h]);
        o[1] = from_f<XT>(acc[a][bb][2 * h + 1]);
      }
    }
  __syncthreads();
  const int ns = min(bn, q - n0);  // live values a row
  const int vo = vec_of(reinterpret_cast<size_t>(out) |
                        static_cast<size_t>(q * xb) |
                        static_cast<size_t>(n0 * xb) |
                        static_cast<size_t>(ns * xb));
  const int upr = bn * xb / vo;  // units a row (covering ns)
  for (int u = threadIdx.x; u < G * bm * upr; u += NTH) {
    const int row = u / upr, o = (u - row * upr) * vo;
    const int t = t0 + (row & (bm - 1)), j = j0 + (row >> lbm);
    if (t >= T || j >= k || o >= ns * xb) continue;
    const char* src = sm + row * lay.orow + o;
    char* dst = reinterpret_cast<char*>(out) +
                (((size_t)t * k + j) * q + n0) * xb + o;
    if (vo == 16)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else if (vo == 8)
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    else if (vo == 4)
      *reinterpret_cast<unsigned*>(dst) =
          *reinterpret_cast<const unsigned*>(src);
    else  // vo == 1: byte by byte up to the row's live end
      *dst = *src;
  }
}

// One launch's arguments, as kernels/bdmm.py:_launch_args packs them into
// one int array: the shape, the geometry from kernels/bdmm.py:bdmm_geometry,
// x's dtype code and the weights' dtype code (float) or bits (quantized).
struct Args {
  int T, k, q, p, instance, tile_t, G, slab, lanes, unit, mw, nw, nt, grid,
      threads, smem, x_dtype, w;
};

// What one call adds: x's strides (elements)
struct Call {
  long long sx_t, sx_j, sx_p;
};

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The launch refuses a geometry that does not tile the output or whose
// shared memory is not this kernel's.
template <typename XT, typename W>
int launch(const void* x, W w, void* out, const Args& a, const Call& cl,
           cudaStream_t stream) {
  if (a.T < 1 || a.k < 1 || a.q < 1 || a.p < 1 || a.G < 1 || a.slab < 1 ||
      a.threads != NTH || cl.sx_t < 0 || cl.sx_j < 0 || cl.sx_p < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const XT* xp = static_cast<const XT*>(x);
  XT* op = static_cast<XT*>(out);
  const long long groups = (a.k + a.G - 1) / a.G;
  const long long slabs = (a.q + a.slab - 1) / a.slab;
  if (a.instance == 0) {
    const size_t smem = sizeof(float) * (size_t)a.G * a.T * ((a.p + 3) & ~3);
    if (a.T > TMAX || a.tile_t != a.T || !pow2(a.lanes) || a.lanes > 32 ||
        !(a.unit == 4 || a.unit == 1) || a.p % a.unit != 0 ||
        (long long)a.G * a.slab > NTH / a.lanes ||
        smem != static_cast<size_t>(a.smem) || groups * slabs != a.grid)
      return static_cast<int>(cudaErrorInvalidValue);
    auto kern = a.unit == 4 ? (a.T <= 8 ? bdmm_decode_kernel<4, 8, XT, W>
                                        : bdmm_decode_kernel<4, 16, XT, W>)
                            : (a.T <= 8 ? bdmm_decode_kernel<1, 8, XT, W>
                                        : bdmm_decode_kernel<1, 16, XT, W>);
    cudaError_t err = prepare_smem(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // one load a unit where the weights' base address allows it (the row
    // and unit offsets are multiples of a unit's bytes when 4 divides p)
    const int ub = a.unit * w.row_bytes() / a.p;
    const int vec =
        a.unit == 4 && reinterpret_cast<size_t>(w.row(0, 0)) % ub == 0;
    const int by_block = cl.sx_j == 1 && cl.sx_p != 1 && a.G > 1;
    kern<<<a.grid, NTH, smem, stream>>>(
        xp, w, op, a.T, a.k, a.q, a.p, a.G, a.slab, a.lanes, vec, by_block,
        fast_div(by_block ? a.G : a.p), fast_div(by_block ? a.p : a.T),
        fast_div(a.slab), cl.sx_t, cl.sx_j, cl.sx_p);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.instance != 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = playout(a.G, a.tile_t, a.slab, a.p, sizeof(XT),
                              KC * w.row_bytes() / a.p)
                          .total;
  const long long tiles = (a.T + a.tile_t - 1) / a.tile_t;
  if (!pow2(a.G) || !pow2(a.mw) || !pow2(a.nw) || !pow2(a.nt) || a.nt > 4 ||
      a.G * a.mw * a.nw != NTH / 32 || a.tile_t != 32 * a.mw ||
      a.slab != 8 * a.nt * a.nw || smem != static_cast<size_t>(a.smem) ||
      tiles * groups * slabs != a.grid)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = bdmm_prefill_kernel<XT, W>;
  cudaError_t err = prepare_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<a.grid, NTH, smem, stream>>>(xp, w, op, a.T, a.k, a.q, a.p, a.G,
                                      a.tile_t, a.slab, a.mw, a.nw, a.nt,
                                      cl.sx_t, cl.sx_j, cl.sx_p);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_x(const void* x, W w, void* out, const Args& a, const Call& cl,
             cudaStream_t st) {
  if (a.x_dtype == DT_F32) return launch<float>(x, w, out, a, cl, st);
  if (a.x_dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, w, out, a, cl, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args unpack(const int* v) {
  return Args{v[0],  v[1],  v[2],  v[3],  v[4],  v[5],  v[6],  v[7],  v[8],
              v[9],  v[10], v[11], v[12], v[13], v[14], v[15], v[16], v[17]};
}

}  // namespace

// args: Args, with w the weights' dtype code; sx_*: x's strides
extern "C" int bdmm_launch(const void* x, const void* w, void* out,
                           const int* args, long long sx_t, long long sx_j,
                           long long sx_p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a = unpack(args);
  const Call cl{sx_t, sx_j, sx_p};
  if (a.w == DT_F32)
    return launch_x(x, FloatBlocks<float>{static_cast<const float*>(w), a.q,
                                          a.p},
                    out, a, cl, st);
  if (a.w == DT_BF16)
    return launch_x(x,
                    FloatBlocks<__nv_bfloat16>{
                        static_cast<const __nv_bfloat16*>(w), a.q, a.p},
                    out, a, cl, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// args: Args, with w the bits: 8 for int8 blocks; 4 for blocks nibble-packed
// along p (p even)
extern "C" int bdmm_q_launch(const void* x, const void* wq, const void* scale,
                             void* out, const int* args, long long sx_t,
                             long long sx_j, long long sx_p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a = unpack(args);
  const Call cl{sx_t, sx_j, sx_p};
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(scale);
  if (a.w == 8)
    return launch_x(x, QuantBlocks<8>{w8, sc, a.q, a.p}, out, a, cl, st);
  if (a.w == 4 && a.p % 2 == 0)
    return launch_x(x, QuantBlocks<4>{w8, sc, a.q, a.p}, out, a, cl, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
