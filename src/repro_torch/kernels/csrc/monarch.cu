// Fused two-stage Monarch product y = R . P . L . x, split over the card's SMs
// by output block.  Replaces the Pallas kernels ``monarch_fused`` /
// ``_monarch_kernel`` (float factors) and ``monarch_fused_q`` /
// ``_monarch_q_kernel`` (int8 or nibble-packed int4 factors with one fp32 scale
// per diagonal block) of repro/kernels/monarch.py.
//
// x: (T, k*p), L: (k, q, p), R: (q, s, k) -> y: (T, q*s) in x's dtype.
// Quantized: Lq (k, q, p[/2]) int8, Ls (k,) fp32, Rq (q, s, k[/2]) int8, Rs
// (q,) fp32; the int4 axis is the contraction axis of each factor.
//
// The split.  Output block i, y[:, i*s:(i+1)*s], needs only L[:, i, :] (k x p),
// R[i] (s x k) and the token rows of x:
//
//   u_i[t, j] = sum_pp L[j, i, pp] * x[t, j*p + pp]        (stage 1)
//   y[t, i*s + c] = sum_j R[i, c, j] * u_i[t, j]           (stage 2)
//
// so a thread block owns one token tile, a group of qg q-blocks and one slab of
// their s output rows, and needs no other block's data: the intermediate never
// reaches device memory, and nothing is summed across blocks.  The stride
// permutation P is only the index i.  The grid is tiles x (q / qg) x slabs,
// slab fastest, so the slabs of one group run side by side and share L[:, i, :]
// in L2.  kernels/monarch.py:fused_geometry picks the tile, qg, the slab and
// the chunk:
//
//   decode (T <= 16): one tile of all T tokens, qg = 1 and slab = s: one
//     block a q-block, q blocks a launch (8-96 over gpt2-medium's serving
//     shapes).  This ran 11-21% faster on the H100 than s cut into slabs to
//     put a block on each of the 132 SMs (chip_smoke.py, monarch_geometry):
//     a decode launch is bound by one block's chain of loads, barriers and
//     shuffles, not by how many SMs stream the factors, and each extra slab
//     repeats stage 1 and re-reads x.
//   prefill (T > 16): 32-token tiles and the largest qg (up to 4) that
//     leaves at least 128 blocks.  Each group re-reads the x tile from L2,
//     so grouping q-blocks cuts that traffic qg-fold, and each x value
//     read from shared memory feeds qg FMAs.
//
//   A slab is fewer than s rows only where R[i]'s rows do not fit shared
//   memory beside the rest; the last slab is then masked.
//
// Splitting by output block was chosen over a thread-block cluster that shares
// u_i through distributed shared memory: it needs no cluster launch and no
// second synchronisation domain, and no block waits on another.
//
// Staging.  Stage 1 walks the k diagonal blocks in chunks of jc: the x tile's
// columns of the chunk and the chunk's rows of L[:, i0:i0+qg, :] (contiguous in
// L) are copied raw (stored width) with cp.async, 16 bytes a thread on
// neighbouring addresses where the rows allow it (else 8, 4, or plain byte
// loads), into one of two buffers while the other is consumed; the group's slab
// rows of R are issued with the first chunk.  Each staged row is followed by 16
// bytes of padding, so the groups of a warp that read neighbouring rows at one
// offset fall on different banks.  Factors are widened in registers at use
// through the reader (common.cuh): a float factor is widened, a quantized one
// dequantized as float(v) * scale of its block, one __fmul_rn, exactly
// core.quant.dequantize_factor.  So the two instances run the same arithmetic
// on the same values and the quantized kernel is bitwise the float kernel on
// the dequantized factors; only the bytes read shrink (1 or 0.5 per weight
// instead of 4).
//
// Arithmetic.  fp32 FMA throughout, the intermediate rounded to x's dtype as
// the reference rounds it between the stages (monarch.py:46).  Each thread owns
// a register micro-tile: TT tokens x qg q-blocks of one diagonal block in stage
// 1 (each L value feeds TT FMAs, each x value qg), TT tokens x CC output
// columns of one q-block in stage 2; when there are fewer micro-tiles than
// threads, a power-of-two group of lanes shares each dot product and sums it
// with xor shuffles.  The summation order depends only on the geometry, which
// does not depend on the factor dtype, so the bitwise twin holds.
//
// What bounds it on the H100.  At decode (T = 8) the launch reads each factor
// byte once from device memory, so the bound is the factor bytes at 3.35 TB/s:
// 0.08-0.4 us a launch in fp32, under the few microseconds a launch costs, so
// a decode launch is latency-bound (one round trip of loads per chunk, then a
// few hundred FMAs a thread).  At prefill (T = 512) the product is
// 2*T*(kqp + qsk) FLOPs, operations-bound at 67 TFLOP/s fp32; the kernel meets
// the shared-memory reads that feed the FMAs and the x tile's re-reads from L2
// (q / qg per tile) first.
// No tensor cores: the served factors are fp32, the kernels are held to fp32
// 2e-5 of their plain versions, the card's logits to 1e-5 relative of the
// CPU's, and B4 bitwise to B1; TF32 or bf16 wgmma on these factors would break
// all three, and at T = 512 a whole prefill step's Monarch work is ~0.28 ms at
// the fp32 FMA bound, far below its attention time.  A split-bf16 (hi + lo)
// tensor-core path for T >= 64 is queued in ROADMAP.md.
//
// The ragged T edge and the last slab's rows are masked, never padded.
#include "common.cuh"

namespace {

constexpr int NTH = 256;  // threads a block (kernels/monarch.py: THREADS)
constexpr int TT = 4;     // tokens of a register micro-tile
constexpr int CC = 4;     // output columns of a stage-2 micro-tile
constexpr int QG = 4;     // most q-blocks a block owns (MAX_Q_GROUP)
constexpr int PAD = 16;   // bytes after every staged row

// Shared memory of one block; kernels/monarch.py:_smem_bytes is the same
// formula.  xbuf: (bT, jc) x rows of p values; lbuf: jc rows of
// L[j, i0:i0+qg, :] (contiguous in L); two of each when there is more than
// one chunk; u: (qg, bT, k + 1) fp32; r: (qg, slab) rows of R.
struct Layout {
  size_t xbuf, buf, nbuf, u, r, total;
};

__host__ __device__ inline Layout layout(int k, int p, int bT, int qg,
                                         int slab, int jc, int xb, int lrow,
                                         int rrow) {
  Layout o;
  o.xbuf = r16((size_t)bT * jc * (p * xb + PAD));
  o.buf = o.xbuf + r16((size_t)jc * (qg * lrow + PAD));
  o.nbuf = jc == k ? 1 : 2;
  o.u = r16((size_t)qg * bT * (k + 1) * sizeof(float));
  o.r = r16((size_t)qg * slab * (rrow + PAD));
  o.total = o.nbuf * o.buf + o.u + o.r;
  return o;
}

template <typename XT, typename W>
__global__ void __launch_bounds__(NTH)
    monarch_fused_kernel(const XT* __restrict__ x, W Lw, W Rw,
                         XT* __restrict__ y, int T, int k, int q, int p,
                         int s, int bT, int qg, int slab, int jc) {
  extern __shared__ __align__(16) char smem[];
  constexpr int xb = sizeof(XT);
  const int lrow = Lw.row_bytes(), rrow = Rw.row_bytes();
  const Layout lay = layout(k, p, bT, qg, slab, jc, xb, lrow, rrow);
  const int seg_x = p * xb + PAD, seg_l = qg * lrow + PAD,
            seg_r = rrow + PAD;
  float* u = reinterpret_cast<float*>(smem + lay.nbuf * lay.buf);
  char* rs = smem + lay.nbuf * lay.buf + lay.u;
  const int ku = k + 1;

  // block -> (token tile, q-blocks i0 .. i0+qg-1, slab), slab fastest
  const int nslab = (s + slab - 1) / slab, ngroup = q / qg;
  int b = blockIdx.x;
  const int sl = b % nslab;
  b /= nslab;
  const int i0 = (b % ngroup) * qg;
  const int t0 = (b / ngroup) * bT, c0 = sl * slab;
  const int nt = min(bT, T - t0), ns = min(slab, s - c0);
  const int din = k * p, dout = q * s;
  const int nchunks = k / jc;

  const char* xg = reinterpret_cast<const char*>(x);
  const int vx = vec_of(reinterpret_cast<size_t>(xg) | (size_t)din * xb |
                        (size_t)p * xb);
  const int vl = vec_of(reinterpret_cast<size_t>(Lw.row(0, 0)) |
                        static_cast<size_t>(lrow));
  const int vr = vec_of(reinterpret_cast<size_t>(Rw.row(0, 0)) |
                        static_cast<size_t>(rrow));

  // chunk c (diagonal blocks c*jc ...) of x and L[:, i0:i0+qg, :] into
  // buffer bi
  auto issue = [&](int c, int bi) {
    char* xs = smem + bi * lay.buf;
    const int j0 = c * jc;
    stage<NTH>(xs, seg_x, nt * jc, p * xb, vx, [&](int g) {
      const int t = g / jc, jj = g - t * jc;
      return xg + ((size_t)(t0 + t) * din + (size_t)(j0 + jj) * p) * xb;
    });
    stage<NTH>(xs + lay.xbuf, seg_l, jc, qg * lrow, vl,
          [&](int g) { return Lw.row(j0 + g, i0); });
  };
  issue(0, 0);
  stage<NTH>(rs, seg_r, qg * ns, rrow, vr, [&](int g) {
    const int ii = g / ns;
    return Rw.row(i0 + ii, c0 + g - ii * ns);
  });
  cp_commit();

  // stage 1: u[ii, t, j] = sum_pp L[j, i0+ii, pp] * x[t, j*p + pp],
  // rounded to x's dtype; a micro-tile is (diagonal block jj, TT tokens,
  // all qg q-blocks): each x value feeds qg FMAs, each L value TT
  const int ntb = (bT + TT - 1) / TT;
  const int items1 = jc * ntb;
  const int g1 = lanes_for<NTH>(items1, p);
  const int lane1 = threadIdx.x % g1, grp1 = threadIdx.x / g1;
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      issue(c + 1, (c + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const char* xs = smem + (c & 1) * lay.buf;
    const char* ls = xs + lay.xbuf;
    const int j0 = c * jc;
    for (int base = 0; base < items1; base += NTH / g1) {
      const int item = base + grp1;
      const int jj = item % jc, tb = item / jc;
      const bool live = item < items1 && tb * TT < nt;
      float acc[TT][QG];
#pragma unroll
      for (int a = 0; a < TT; ++a)
#pragma unroll
        for (int e = 0; e < QG; ++e) acc[a][e] = 0.f;
      if (live) {
        const char* lr = ls + jj * seg_l;
        const float sc = Lw.scale_of(j0 + jj);
        for (int pp = lane1; pp < p; pp += g1) {
          float w[QG];
#pragma unroll
          for (int e = 0; e < QG; ++e)
            w[e] = e < qg ? W::at(lr + e * lrow, pp, sc) : 0.f;
#pragma unroll
          for (int a = 0; a < TT; ++a) {
            const int t = tb * TT + a;
            if (t < nt) {
              const XT* xr =
                  reinterpret_cast<const XT*>(xs + (t * jc + jj) * seg_x);
              const float xv = to_f(xr[pp]);
#pragma unroll
              for (int e = 0; e < QG; ++e)
                acc[a][e] = fmaf(xv, w[e], acc[a][e]);
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < TT; ++a)
#pragma unroll
        for (int e = 0; e < QG; ++e) {
          if (e < qg) acc[a][e] = group_sum(acc[a][e], g1);
        }
      if (live && lane1 == 0) {
#pragma unroll
        for (int a = 0; a < TT; ++a) {
          const int t = tb * TT + a;
          if (t >= nt) continue;
#pragma unroll
          for (int e = 0; e < QG; ++e)
            if (e < qg)
              u[(e * bT + t) * ku + j0 + jj] = to_f(from_f<XT>(acc[a][e]));
        }
      }
    }
    __syncthreads();  // buffer c & 1 is free for chunk c + 2
  }

  // stage 2: y[t, i*s + c] = sum_j R[i, c, j] * u[i - i0, t, j]; a
  // micro-tile is (one q-block, TT tokens, CC slab rows)
  const int ncb = (slab + CC - 1) / CC;
  const int items2 = qg * ntb * ncb;
  const int g2 = lanes_for<NTH>(items2, k);
  const int lane2 = threadIdx.x % g2, grp2 = threadIdx.x / g2;
  for (int base = 0; base < items2; base += NTH / g2) {
    const int item = base + grp2;
    const int cb = item % ncb, rest = item / ncb;
    const int tb = rest % ntb, ii = rest / ntb;
    const bool live = item < items2 && tb * TT < nt && cb * CC < ns;
    const float rsc = Rw.scale_of(i0 + (live ? ii : 0));
    const float* ui = u + (size_t)ii * bT * ku;
    const char* ri = rs + (size_t)ii * ns * seg_r;
    float acc[TT][CC];
#pragma unroll
    for (int a = 0; a < TT; ++a)
#pragma unroll
      for (int e = 0; e < CC; ++e) acc[a][e] = 0.f;
    if (live) {
      for (int jj = lane2; jj < k; jj += g2) {
        float uv[TT], rv[CC];
#pragma unroll
        for (int a = 0; a < TT; ++a) {
          const int t = tb * TT + a;
          uv[a] = t < nt ? ui[t * ku + jj] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < CC; ++e) {
          const int cc = cb * CC + e;
          rv[e] = cc < ns ? W::at(ri + cc * seg_r, jj, rsc) : 0.f;
        }
#pragma unroll
        for (int a = 0; a < TT; ++a)
#pragma unroll
          for (int e = 0; e < CC; ++e)
            acc[a][e] = fmaf(uv[a], rv[e], acc[a][e]);
      }
    }
#pragma unroll
    for (int a = 0; a < TT; ++a)
#pragma unroll
      for (int e = 0; e < CC; ++e) acc[a][e] = group_sum(acc[a][e], g2);
    if (live && lane2 == 0) {
#pragma unroll
      for (int a = 0; a < TT; ++a) {
        const int t = tb * TT + a;
        if (t >= nt) continue;
        XT* yr = y + (size_t)(t0 + t) * dout + (size_t)(i0 + ii) * s + c0;
#pragma unroll
        for (int e = 0; e < CC; ++e) {
          const int cc = cb * CC + e;
          if (cc < ns) yr[cc] = from_f<XT>(acc[a][e]);
        }
      }
    }
  }
}

// One launch's arguments, as kernels/monarch.py:_launch_args packs them
// into one int array (a ctypes call costs host time per argument, and a
// decode launch is short): the shape, the geometry from
// kernels/monarch.py:fused_geometry, x's dtype code, and the factors'
// dtype code (float) or bits (quantized).
struct Args {
  int T, k, q, p, s, bT, qg, slab, jc, grid, threads, smem, x_dtype, w;
};

// The launch refuses a geometry that does not tile the output or whose
// shared memory is not this layout's.
template <typename XT, typename W>
int launch(const void* x, W Lw, W Rw, void* y, const Args& a,
           cudaStream_t stream) {
  if (a.T < 1 || a.bT < 1 || a.qg < 1 || a.qg > QG || a.q % a.qg != 0 ||
      a.slab < 1 || a.jc < 1 || a.k % a.jc != 0 || a.threads != NTH)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(a.k, a.p, a.bT, a.qg, a.slab, a.jc, sizeof(XT),
                            Lw.row_bytes(), Rw.row_bytes());
  const long long n_blocks = (long long)((a.T + a.bT - 1) / a.bT) *
                             (a.q / a.qg) * ((a.s + a.slab - 1) / a.slab);
  if (lay.total != static_cast<size_t>(a.smem) || n_blocks != a.grid)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = monarch_fused_kernel<XT, W>;
  cudaError_t err = prepare_smem(kern, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<a.grid, NTH, lay.total, stream>>>(
      static_cast<const XT*>(x), Lw, Rw, static_cast<XT*>(y), a.T, a.k, a.q,
      a.p, a.s, a.bT, a.qg, a.slab, a.jc);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_x(const void* x, W Lw, W Rw, void* y, const Args& a,
             cudaStream_t st) {
  if (a.x_dtype == DT_F32) return launch<float>(x, Lw, Rw, y, a, st);
  if (a.x_dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, Lw, Rw, y, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// args: Args, with w the factors' dtype code
extern "C" int monarch_fused_launch(const void* x, const void* L,
                                    const void* R, void* y, const int* args,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{args[0], args[1], args[2],  args[3],  args[4],
               args[5], args[6], args[7],  args[8],  args[9],
               args[10], args[11], args[12], args[13]};
  if (a.w == DT_F32)
    return launch_x(
        x, FloatBlocks<float>{static_cast<const float*>(L), a.q, a.p},
        FloatBlocks<float>{static_cast<const float*>(R), a.s, a.k}, y, a,
        st);
  if (a.w == DT_BF16)
    return launch_x(x,
                    FloatBlocks<__nv_bfloat16>{
                        static_cast<const __nv_bfloat16*>(L), a.q, a.p},
                    FloatBlocks<__nv_bfloat16>{
                        static_cast<const __nv_bfloat16*>(R), a.s, a.k},
                    y, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// args: Args, with w the bits: 8 for int8 factors; 4 for both factors
// nibble-packed along their contraction axis (p for L, k for R, both even)
extern "C" int monarch_fused_q_launch(const void* x, const void* Lq,
                                      const void* Ls, const void* Rq,
                                      const void* Rs, void* y,
                                      const int* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{args[0], args[1], args[2],  args[3],  args[4],
               args[5], args[6], args[7],  args[8],  args[9],
               args[10], args[11], args[12], args[13]};
  const int8_t* l8 = static_cast<const int8_t*>(Lq);
  const int8_t* r8 = static_cast<const int8_t*>(Rq);
  const float* ls = static_cast<const float*>(Ls);
  const float* rs = static_cast<const float*>(Rs);
  if (a.w == 8)
    return launch_x(x, QuantBlocks<8>{l8, ls, a.q, a.p},
                    QuantBlocks<8>{r8, rs, a.s, a.k}, y, a, st);
  if (a.w == 4 && a.p % 2 == 0 && a.k % 2 == 0)
    return launch_x(x, QuantBlocks<4>{l8, ls, a.q, a.p},
                    QuantBlocks<4>{r8, rs, a.s, a.k}, y, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
