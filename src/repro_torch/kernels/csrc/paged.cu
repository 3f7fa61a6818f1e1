// Flash attention of each row's S-query span over KV pages gathered through
// a page table, split over the card's SMs along the page axis
// (flash-decoding).  Replaces the Pallas kernels ``paged_attention_span`` /
// ``_paged_attention_span`` / ``_paged_span_kernel`` / ``_span_attend``
// (fp32 and bf16 pages) and ``_paged_attention_span_q`` /
// ``_paged_span_kernel_q`` (int8 pages with per-(page, head) fp32 scales)
// of repro/kernels/paged.py; launched per rank on its heads, also
// ``paged_attention_span_sharded``.
//
// q: (B, S, H, hd); k/v pages: (P, pg, KV, hd); page_table: (B, MP) int32;
// start, span_len: (B,) int32; window: int -> out: (B, S, H, hd), q's dtype.
// int8 pages come with k/v scales (P, KV) fp32.
// Row b's query i sits at position start[b] + i and is valid iff
// i < span_len[b]; it attends key t iff t <= start[b] + i and
// start[b] + i - t < window (window = 1e9 means global).  GQA: query head h
// reads KV head h / (H / KV).
//
// Grid (query tiles x splits, H, B).  A block owns one sequence b, one query
// head h, one tile of ST query rows and one split: the PPS consecutive
// absolute pages [s*PPS, (s+1)*PPS) of its row.  It intersects the split with
// the pages the tile's valid queries attend, [first, last] (computed on the
// device from start, span_len and window), and returns at once when they do
// not meet.  kernels/paged.py:span_geometry picks ST, PPS and the number of
// splits from (S, hd, pg, MP) alone -- never from start/span_len, which live
// on the device, and never from H or KV, so a rank's launch on its H/tp
// heads computes each (b, h) exactly as the launch on all heads does.
//
// Combine.  Where a tile has one non-empty split, that block writes the
// output itself.  Otherwise every non-empty split writes its fp32 partial
// (m, l, acc[hd] of each valid row) to a workspace, fences, and takes a
// ticket; the last of them merges the partials in split order (not arrival
// order, so every run gives the same bits), m* = max m_s,
// l = sum l_s exp(m_s - m*), acc = sum acc_s exp(m_s - m*),
// out = acc / max(l, 1e-30), and resets the ticket to 0 for the next launch.
// One launch, no second merge kernel: the serving path is host-bound and a
// second launch a layer would cost the host more than the merge costs the card.
//
// A block's page loop.  Each page's (pg, hd) K and V rows of its KV head are
// copied as stored (fp32, bf16 or int8) with 16-byte cp.async (narrower
// where rows or addresses are not aligned) from the physical page the table
// names into one of two buffers, one page ahead of the compute (one buffer,
// no overlap, where two do not fit: span_geometry's stages).  Values are
// widened to fp32 where they are used, through the page reader: a float page
// is widened, an int8 page dequantized as float(v) * scale[page, head], one
// __fmul_rn, exactly core.quant.dequantize_kv_pages.  So the int8 instance
// runs the float instance's arithmetic on the same values (bitwise B3 on
// dequantized pages) and reads a quarter of the fp32 bytes.  Three passes a
// page, three barriers:
//   scores   a group of gs lanes a (key, RB query rows) micro-tile, q and K
//            read four values at a time, the group summed with xor shuffles
//            (8 lanes a key at decode, one lane at a 64-row tile);
//   softmax  online, a segment of lanes a row (16 lanes at page 16);
//   P.V      a group of gv lanes a (dim, RB rows) micro-tile, four keys'
//            probabilities read at a time; acc stays in shared memory.
// A one-row tile (decode) runs the RB = 1 instance with 128 threads, larger
// tiles the RB = 8 instance with 256.  The reference's semantics hold: m
// starts at -1e30 (not -inf), masked scores are -1e30, probabilities are
// multiplied by the mask (a fully masked page, or split, adds nothing), a
// bf16 output is rounded once after the merge, and rows i >= span_len are
// zero.  fp32 FMA throughout, no tensor cores: the kernel is held to fp32
// 2e-5 of its plain version.
//
// What bounds it on the H100.  The bytes: the queries, the K/V rows of every
// page a valid query attends and the output, once each, at 3.35 TB/s (4 us
// for the 214 bf16 pages of the decode call set); the 4*hd FLOPs a (query,
// key) pair are far below that at decode.  Unsplit, a decode launch had one
// block per (row, head) walking up to 64 pages in series, so it took the
// latency of the longest row's 64 dependent page rounds; split, a block walks
// at most PPS pages and the rows' splits run side by side.
//
// Shared memory: see Layout (kernels/paged.py:smem_bytes is the same formula
// at fp32 pages, the most of every page dtype).
#include "common.cuh"

#define NEG_BIG (-1e30f)
#define DT_I8 2  // int8 pages (kernels/paged.py: INT8_CODE)

namespace {

// A one-row tile (decode) runs with 128 threads and one query row a
// register micro-tile; a tile of more rows with 256 threads and micro-tiles
// of 8 rows.  span_geometry's tile decides, so B3, B6 and B7 run one
// instance on one shape.
constexpr int NT_ROW = 128, NT_TILE = 256;
constexpr int RB_TILE = 8;

// Page readers: where a page row lives, and its elements widened to fp32
// (``at``: element d; ``at4``: elements 4c .. 4c+3 from one aligned load);
// the two instances differ only here.
template <typename KT>
struct FloatPages {
  const KT* p;
  static constexpr int kBytes = sizeof(KT);
  static constexpr bool kScaled = false;
  __device__ __forceinline__ const char* row(size_t elem) const {
    return reinterpret_cast<const char*>(p + elem);
  }
  __device__ __forceinline__ const float* scale(size_t) const {
    return nullptr;
  }
  __device__ static __forceinline__ float at(const char* row, int d, float) {
    return to_f(reinterpret_cast<const KT*>(row)[d]);
  }
  __device__ static __forceinline__ float4 at4(const char* row, int c,
                                               float) {
    if constexpr (sizeof(KT) == 4) {
      return reinterpret_cast<const float4*>(row)[c];
    } else {  // bf16: the high half of an fp32, as __bfloat162float widens
      const uint2 u = reinterpret_cast<const uint2*>(row)[c];
      return make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
    }
  }
};

struct Int8Pages {
  const int8_t* p;
  const float* s;  // (P, KV)
  static constexpr int kBytes = 1;
  static constexpr bool kScaled = true;
  __device__ __forceinline__ const char* row(size_t elem) const {
    return reinterpret_cast<const char*>(p + elem);
  }
  __device__ __forceinline__ const float* scale(size_t sidx) const {
    return s + sidx;
  }
  __device__ static __forceinline__ float at(const char* row, int d,
                                             float sc) {
    return __fmul_rn(static_cast<float>(reinterpret_cast<const int8_t*>(row)[d]),
                     sc);
  }
  __device__ static __forceinline__ float4 at4(const char* row, int c,
                                               float sc) {
    const char4 v = reinterpret_cast<const char4*>(row)[c];
    return make_float4(__fmul_rn(static_cast<float>(v.x), sc),
                       __fmul_rn(static_cast<float>(v.y), sc),
                       __fmul_rn(static_cast<float>(v.z), sc),
                       __fmul_rn(static_cast<float>(v.w), sc));
  }
};

// launch arguments, in kernels/paged.py:_launch_args's order
struct Args {
  int B, S, H, hd, pg, KV, MP, window, tile, pps, n_splits, n_tiles, stages,
      q_dtype, kv_dtype;
};

// Shared memory of one block, offsets in bytes: q (ST, hdp) and acc
// (ST, hd) fp32, scores (ST, pg rounded up to 4), m/l/alpha (3, ST), two
// scales a stage, and ``stages`` page buffers of K and V rows as stored,
// each row padded to ``rawst`` bytes (hdp values, then up to an odd number
// of 16-byte units, so that neighbouring keys' rows start on other banks).
struct Layout {
  int hdp, rawst;
  size_t q, acc, sc, ml, scl, raw, slot, total;
};

__host__ __device__ inline Layout layout(int ST, int hd, int pg, int stages,
                                         int pbytes) {
  Layout o;
  o.hdp = (hd + 3) & ~3;
  o.rawst = static_cast<int>(r16((size_t)o.hdp * pbytes));
  if ((o.rawst / 16) % 2 == 0) o.rawst += 16;
  size_t at = 0;
  o.q = at;
  at += r16(4 * (size_t)ST * o.hdp);
  o.acc = at;
  at += r16(4 * (size_t)ST * hd);
  o.sc = at;
  at += r16(4 * (size_t)ST * ((pg + 3) & ~3));
  o.ml = at;
  at += r16(4 * 3 * (size_t)ST);
  o.scl = at;
  at += 16 * (size_t)stages;
  o.slot = 2 * (size_t)pg * o.rawst;
  o.raw = at;
  at += stages * o.slot;
  o.total = at;
  return o;
}

template <typename QT, typename PR, int RB, int NT>
__global__ void __launch_bounds__(NT)
    paged_span_kernel(const QT* __restrict__ q, PR kp, PR vp,
                      const int* __restrict__ page_table,
                      const int* __restrict__ start,
                      const int* __restrict__ span_len, QT* __restrict__ out,
                      float* __restrict__ ws, int* __restrict__ tickets,
                      const Args a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int is_last;
  constexpr int NW = NT / 32;
  const int hd = a.hd, pg = a.pg, ST = a.tile, pps = a.pps;
  const int b = blockIdx.z, h = blockIdx.y;
  const int tile = blockIdx.x / a.n_splits;
  const int split = blockIdx.x - tile * a.n_splits;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this block's query rows are i0 .. i0 + R - 1 of the span; the first
  // nval of them are valid (i < span_len)
  const int i0 = tile * ST, R = min(ST, a.S - i0);
  const int st = start[b] + i0;
  const int nval = max(0, min(R, span_len[b] - i0));
  // output row i of this block: out[(orow + i * H) * hd + d]
  const size_t orow = ((size_t)b * a.S + i0) * a.H + h;

  // pages holding any key a valid query of the tile attends: [first, last];
  // the splits that meet them: s_first .. s_last
  int first = 0, last = -1;
  if (nval > 0) {
    const long long lo = (long long)st - (long long)a.window + 1;
    first = lo > 0 ? static_cast<int>(lo / pg) : 0;
    last = min((st + nval - 1) / pg, a.MP - 1);
  }
  const int s_first = first / pps, s_last = last / pps;
  const int n_live = first <= last ? s_last - s_first + 1 : 0;
  if (n_live == 0) {  // nothing attended: split 0 writes the zeros
    if (split == 0)
      for (int e = tid; e < R * hd; e += NT) {
        const int i = e / hd, d = e - i * hd;
        out[(orow + (size_t)i * a.H) * hd + d] = from_f<QT>(0.f);
      }
    return;
  }
  if (split < s_first || split > s_last) return;
  const int p_lo = max(first, split * pps);
  const int n = min(last, split * pps + pps - 1) - p_lo + 1;

  const Layout L = layout(ST, hd, pg, a.stages, PR::kBytes);
  const int hdp = L.hdp, hq = hdp >> 2;
  const int pgs = (pg + 3) & ~3, pg4 = pgs >> 2;  // a score row, in float4s
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* m = reinterpret_cast<float*>(smem + L.ml);
  float* l = m + ST;
  float* alpha = l + ST;
  float* scl = reinterpret_cast<float*>(smem + L.scl);
  char* raw = smem + L.raw;
  const int rawst = L.rawst;

  const int rowb = hd * PR::kBytes;
  const int padb = hdp * PR::kBytes - rowb;
  const int vec = vec_of(reinterpret_cast<size_t>(kp.p) |
                         reinterpret_cast<size_t>(vp.p) | (size_t)rowb);
  // page ``phys``'s K and V rows of head kvh, as stored, into buffer
  // ``slot`` (K rows, then V rows), with its two scales
  auto copy_page = [&](int phys, int slot) {
    const size_t base = (size_t)phys * pg;
    const int nkv = a.KV;  // captured by value: no local memory
    auto krow = [=](int r) { return kp.row(((base + r) * nkv + kvh) * hd); };
    auto vrow = [=](int r) { return vp.row(((base + r) * nkv + kvh) * hd); };
    char* dst = raw + slot * L.slot;
    stage<NT>(dst, rawst, pg, rowb, vec, krow);
    stage<NT>(dst + (size_t)pg * rawst, rawst, pg, rowb, vec, vrow);
    if constexpr (PR::kScaled) {
      const size_t sidx = (size_t)phys * a.KV + kvh;
      if (tid == 0) cp_async<4>(scl + 4 * slot, kp.scale(sidx));
      if (tid == 1) cp_async<4>(scl + 4 * slot + 1, vp.scale(sidx));
    }
    cp_commit();
  };

  const int* ptab = page_table + (size_t)b * a.MP;
  const bool ring = a.stages == 2;
  int ph_next = 0;  // the table entry of the next page to copy
  if (ring) {  // the first page's copy overlaps the block's set-up
    copy_page(ptab[p_lo], 0);
    if (n > 1) ph_next = ptab[p_lo + 1];
  }

  for (int e = tid; e < R * hdp; e += NT) {
    const int i = e / hdp, d = e - i * hdp;
    qs[e] = d < hd ? to_f(q[(orow + (size_t)i * a.H) * hd + d]) : 0.f;
  }
  for (int e = tid; e < R * hd; e += NT) acc[e] = 0.f;
  for (int e = tid; e < R * (pgs - pg); e += NT)  // P.V reads the pad
    sc[(e / (pgs - pg)) * pgs + pg + e % (pgs - pg)] = 0.f;
  for (int i = tid; i < R; i += NT) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
  }
  if (padb > 0)  // read by at4 beside the last values: zeros, never copied
    for (int e = tid; e < a.stages * 2 * pg * padb; e += NT) {
      const int rr = e / padb;
      raw[(size_t)rr * rawst + rowb + (e - rr * padb)] = 0;
    }

  // the work of a page, mapped from R, hd and pg alone: a score item is
  // (key r, rows rb*RB ..), a P.V item (dim d, rows rb*RB ..); gs / gv
  // lanes share one
  const int nrb = (R + RB - 1) / RB, rk = min(R, RB);
  const int items_s = pg * nrb, gs = lanes_for<NT>(items_s, hq);
  const int items_v = hd * nrb, gv = lanes_for<NT>(items_v, pg4);
  int seg = 32;  // lanes a softmax row: the fewest powers of two >= pg
  while (seg > 1 && seg / 2 >= pg) seg >>= 1;
  const float sq = sqrtf((float)hd);

  for (int j = 0; j < n; ++j) {
    const int p = p_lo + j;
    if (!ring) {  // one buffer: page j - 1 must be done with it
      __syncthreads();
      copy_page(ptab[p], 0);
    }
    cp_wait<0>();
    __syncthreads();  // page j landed; page j - 1's buffer is free
    if (ring && j + 1 < n) {
      copy_page(ph_next, (j + 1) & 1);
      if (j + 2 < n) ph_next = ptab[p + 2];
    }
    const int slot = ring ? j & 1 : 0;
    const char* K = raw + slot * L.slot;
    const char* V = K + (size_t)pg * rawst;
    const float sk = PR::kScaled ? scl[4 * slot] : 1.f;
    const float sv = PR::kScaled ? scl[4 * slot + 1] : 1.f;

    // scores of this page, masked, scaled by 1/sqrt(hd)
    {
      const float4* Q4 = reinterpret_cast<const float4*>(qs);
      const int lg = tid % gs, grp = tid / gs;
      for (int base = 0; base < items_s; base += NT / gs) {
        const int item = base + grp;
        const int r = item % pg, rb = item / pg;
        const bool live = item < items_s;
        float dot[RB];
#pragma unroll
        for (int k = 0; k < RB; ++k) dot[k] = 0.f;
        if (live) {
          const char* kr = K + (size_t)r * rawst;
          for (int c = lg; c < hq; c += gs) {
            const float4 kv = PR::at4(kr, c, sk);
#pragma unroll
            for (int k = 0; k < RB; ++k) {
              const int i = rb * RB + k;
              if (i < R) {
                const float4 qv = Q4[i * hq + c];
                dot[k] = fmaf(qv.x, kv.x, dot[k]);
                dot[k] = fmaf(qv.y, kv.y, dot[k]);
                dot[k] = fmaf(qv.z, kv.z, dot[k]);
                dot[k] = fmaf(qv.w, kv.w, dot[k]);
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < RB; ++k)
          if (k < rk) dot[k] = group_sum(dot[k], gs);
        if (live && lg == 0) {
          const int t = p * pg + r;
#pragma unroll
          for (int k = 0; k < RB; ++k) {
            const int i = rb * RB + k;
            if (i < R) {
              const int qpos = st + i;
              const bool ok = (t <= qpos) && (qpos - t < a.window);
              sc[i * pgs + r] = ok ? dot[k] / sq : NEG_BIG;
            }
          }
        }
      }
    }
    __syncthreads();
    // online softmax update, a segment of seg lanes a query row; the
    // probabilities are multiplied by the mask
    for (int base = warp * (32 / seg); base < R; base += NW * (32 / seg)) {
      const int i = base + lane / seg, sl = lane % seg;
      const bool row = i < R;
      const int qpos = st + i;
      float mx = NEG_BIG;
      if (row)
        for (int r = sl; r < pg; r += seg) mx = fmaxf(mx, sc[i * pgs + r]);
      for (int o = seg >> 1; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = row ? m[i] : NEG_BIG;
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      if (row)
        for (int r = sl; r < pg; r += seg) {
          const int t = p * pg + r;
          const float ok = (t <= qpos) && (qpos - t < a.window) ? 1.f : 0.f;
          const float pv = expf(sc[i * pgs + r] - m_new) * ok;
          sc[i * pgs + r] = pv;
          psum += pv;
        }
      for (int o = seg >> 1; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (row && sl == 0) {
        const float al = expf(m_prev - m_new);
        l[i] = l[i] * al + psum;
        m[i] = m_new;
        alpha[i] = al;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P . V
    {
      const int lg = tid % gv, grp = tid / gv;
      for (int base = 0; base < items_v; base += NT / gv) {
        const int item = base + grp;
        const int d = item % hd, rb = item / hd;
        const bool live = item < items_v;
        float pv[RB];
#pragma unroll
        for (int k = 0; k < RB; ++k) pv[k] = 0.f;
        if (live) {  // keys 4c .. 4c+3 at a time (the score pad is 0)
          for (int c = lg; c < pg4; c += gv) {
            float vv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              vv[u] = 4 * c + u < pg
                          ? PR::at(V + (size_t)(4 * c + u) * rawst, d, sv)
                          : 0.f;
#pragma unroll
            for (int k = 0; k < RB; ++k) {
              const int i = rb * RB + k;
              if (i < R) {
                const float4 pr = reinterpret_cast<const float4*>(sc)[i * pg4 + c];
                pv[k] = fmaf(pr.x, vv[0], pv[k]);
                pv[k] = fmaf(pr.y, vv[1], pv[k]);
                pv[k] = fmaf(pr.z, vv[2], pv[k]);
                pv[k] = fmaf(pr.w, vv[3], pv[k]);
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < RB; ++k)
          if (k < rk) pv[k] = group_sum(pv[k], gv);
        if (live && lg == 0) {
#pragma unroll
          for (int k = 0; k < RB; ++k) {
            const int i = rb * RB + k;
            if (i < R) acc[i * hd + d] = acc[i * hd + d] * alpha[i] + pv[k];
          }
        }
      }
    }
  }
  __syncthreads();

  const size_t tix = ((size_t)b * a.H + h) * a.n_tiles + tile;
  if (n_live == 1) {  // the tile's only split: the output itself
    for (int e = tid; e < R * hd; e += NT) {
      const int i = e / hd, d = e - i * hd;
      const float o = i < nval ? acc[e] / fmaxf(l[i], 1e-30f) : 0.f;
      out[(orow + (size_t)i * a.H) * hd + d] = from_f<QT>(o);
    }
    return;
  }
  // this split's partial, then a ticket; the last split merges
  const size_t part = (size_t)ST * (hd + 2);
  float* wt = ws + tix * a.n_splits * part;  // the tile's partials
  float* wp = wt + (size_t)split * part;
  for (int i = tid; i < nval; i += NT) {
    wp[i] = m[i];
    wp[ST + i] = l[i];
  }
  for (int e = tid; e < nval * hd; e += NT) wp[2 * ST + e] = acc[e];
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + tix, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // a warp per (row, 32 dims): m* over the splits, then l and acc summed in
  // split order, read from L2 (other SMs wrote them)
  const int ndc = (hd + 31) >> 5;
  for (int u = warp; u < R * ndc; u += NW) {
    const int i = u / ndc, d = (u - i * ndc) * 32 + lane;
    float o = 0.f;
    if (i < nval) {
      float mx = NEG_BIG;
      for (int s = s_first + lane; s <= s_last; s += 32)
        mx = fmaxf(mx, __ldcg(wt + (size_t)s * part + i));
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float ls = 0.f, av = 0.f;
      for (int s = s_first; s <= s_last; ++s) {
        const float* ps = wt + (size_t)s * part;
        const float w = expf(__ldcg(ps + i) - mx);
        ls += __ldcg(ps + ST + i) * w;
        if (d < hd) av += __ldcg(ps + 2 * ST + (size_t)i * hd + d) * w;
      }
      o = av / fmaxf(ls, 1e-30f);
    }
    if (d < hd) out[(orow + (size_t)i * a.H) * hd + d] = from_f<QT>(o);
  }
  if (tid == 0) tickets[tix] = 0;
}

// The launch refuses a geometry that does not cover the span and the pages.
template <typename QT, typename PR>
int launch(const void* q, PR kp, PR vp, const void* pt, const void* start,
           const void* span_len, void* out, void* ws, void* tickets,
           const Args& a, cudaStream_t stream) {
  const int n_splits = a.MP > 0 ? (a.MP + a.pps - 1) / a.pps : 1;
  if (a.B < 1 || a.B > 65535 || a.S < 1 || a.H < 1 || a.H > 65535 ||
      a.KV < 1 || a.H % a.KV != 0 || a.hd < 1 || a.pg < 1 || a.MP < 0 ||
      a.tile < 1 || a.pps < 1 || a.stages < 1 || a.stages > 2 ||
      a.n_tiles != (a.S + a.tile - 1) / a.tile || a.n_splits != n_splits ||
      (a.n_splits > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(a.tile, a.hd, a.pg, a.stages, PR::kBytes);
  const bool row = a.tile == 1;
  auto kern = row ? paged_span_kernel<QT, PR, 1, NT_ROW>
                  : paged_span_kernel<QT, PR, RB_TILE, NT_TILE>;
  cudaError_t err = prepare_smem(kern, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.n_tiles * a.n_splits, a.H, a.B);
  kern<<<grid, row ? NT_ROW : NT_TILE, lay.total, stream>>>(
      static_cast<const QT*>(q), kp, vp, static_cast<const int*>(pt),
      static_cast<const int*>(start), static_cast<const int*>(span_len),
      static_cast<QT*>(out), static_cast<float*>(ws),
      static_cast<int*>(tickets), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename PR>
int launch_q(const void* q, PR kp, PR vp, const void* pt, const void* start,
             const void* span_len, void* out, void* ws, void* tickets,
             const Args& a, cudaStream_t st) {
  if (a.q_dtype == DT_F32)
    return launch<float>(q, kp, vp, pt, start, span_len, out, ws, tickets, a,
                         st);
  if (a.q_dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, kp, vp, pt, start, span_len, out, ws,
                                 tickets, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args args_of(const int* v) {
  return Args{v[0], v[1], v[2],  v[3],  v[4],  v[5],  v[6], v[7],
              v[8], v[9], v[10], v[11], v[12], v[13], v[14]};
}

}  // namespace

// fp32 or bf16 pages; args: Args, with kv_dtype the pages' dtype code.
// ws / tickets: the fp32 workspace and the zeroed int32 tickets of
// kernels/paged.py:_workspace (unused, and may be null, unsplit)
extern "C" int paged_span_launch(const void* q, const void* kp, const void* vp,
                                 const void* page_table, const void* start,
                                 const void* span_len, void* out, void* ws,
                                 void* tickets, const int* args,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a = args_of(args);
  if (a.kv_dtype == DT_F32)
    return launch_q(q, FloatPages<float>{static_cast<const float*>(kp)},
                    FloatPages<float>{static_cast<const float*>(vp)},
                    page_table, start, span_len, out, ws, tickets, a, st);
  if (a.kv_dtype == DT_BF16)
    return launch_q(
        q, FloatPages<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(kp)},
        FloatPages<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(vp)},
        page_table, start, span_len, out, ws, tickets, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 pages with (P, KV) fp32 scale rows for K and V; args as above, with
// kv_dtype DT_I8
extern "C" int paged_span_q_launch(const void* q, const void* kp,
                                   const void* vp, const void* k_scales,
                                   const void* v_scales,
                                   const void* page_table, const void* start,
                                   const void* span_len, void* out, void* ws,
                                   void* tickets, const int* args,
                                   void* stream) {
  const Args a = args_of(args);
  if (a.kv_dtype != DT_I8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_q(q,
                  Int8Pages{static_cast<const int8_t*>(kp),
                            static_cast<const float*>(k_scales)},
                  Int8Pages{static_cast<const int8_t*>(vp),
                            static_cast<const float*>(v_scales)},
                  page_table, start, span_len, out, ws, tickets, a,
                  static_cast<cudaStream_t>(stream));
}
