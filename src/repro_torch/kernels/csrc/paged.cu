// Flash attention of each row's S-query span over KV pages gathered through
// a page table.  Replaces the Pallas kernels ``paged_attention_span`` /
// ``_paged_attention_span`` / ``_paged_span_kernel`` / ``_span_attend``
// (fp32 and bf16 pages) and ``_paged_attention_span_q`` /
// ``_paged_span_kernel_q`` (int8 pages with per-(page, head) fp32 scales)
// of repro/kernels/paged.py.
//
// q: (B, S, H, hd); k/v pages: (P, pg, KV, hd); page_table: (B, MP) int32;
// start, span_len: (B,) int32; window: int -> out: (B, S, H, hd), q's dtype.
// int8 pages come with k/v scales (P, KV) fp32.
// Row b's query i sits at position start[b] + i and is valid iff
// i < span_len[b]; it attends key t iff t <= start[b] + i and
// start[b] + i - t < window (window = 1e9 means global).  GQA: query head h
// reads KV head h / (H / KV).
//
// Grid (B, H, ceil(S / ST)): one block per (sequence, query head, tile of
// ST query rows), so a block's working set does not grow with the span.
// The TPU's sequential page grid axis becomes a loop inside the block, which
// reads the physical page id from the page table itself and stages that
// page's (pg, hd) K and V rows of its KV head in shared memory as fp32
// through a page reader: float pages are widened; an int8 page is
// dequantized as float(v) * scale[page, head], one fp32 multiply
// (core.quant.dequantize_kv_pages), so the int8 instance is bitwise the
// float one on dequantized pages and reads a quarter of the fp32 bytes.
// The running max m, normalizer l and accumulator acc of the block's ST
// queries stay in shared memory across the loop, with the reference's
// semantics: m starts at -1e30 (not -inf),
// masked scores are -1e30, probabilities are multiplied by the mask (a fully
// masked page adds nothing), the output is acc / max(l, 1e-30), and rows
// i >= span_len are zero.  Pages wholly before the tile's window or after
// its last valid position are skipped: under those semantics they would
// leave m, l and acc bit-identical.
//
// Shared memory (floats), the same for every page width: 2*ST*hd (q, acc)
// + pg*(hd+1) + pg*hd (K, V) + 2*ST*pg (scores, mask) + 3*ST (m, l,
// rescale); kernels/paged.py:smem_bytes.  The two scales of a page are read
// straight into registers.
#include "common.cuh"

#define NEG_BIG (-1e30f)

// Page readers: element ``src`` of a page array, widened to fp32; ``sidx``
// is the (page, kv head) index of its scale row.
template <typename KT>
struct FloatPages {
  const KT* p;
  __device__ __forceinline__ float operator()(size_t src, size_t) const {
    return to_f(p[src]);
  }
};

struct Int8Pages {
  const int8_t* p;
  const float* scale;
  __device__ __forceinline__ float operator()(size_t src,
                                              size_t sidx) const {
    return __fmul_rn(static_cast<float>(p[src]), scale[sidx]);
  }
};

template <typename QT, typename PR>
__global__ void paged_span_kernel(const QT* __restrict__ q, PR kp, PR vp,
                                  const int* __restrict__ page_table,
                                  const int* __restrict__ start,
                                  const int* __restrict__ span_len,
                                  int window, QT* __restrict__ out, int S,
                                  int H, int hd, int pg, int KV, int MP,
                                  int ST) {
  extern __shared__ float smem[];
  const int kstride = hd + 1;
  float* qs = smem;                      // (ST, hd)
  float* acc = qs + ST * hd;             // (ST, hd)
  float* ks = acc + ST * hd;             // (pg, hd + 1)
  float* vs = ks + pg * kstride;         // (pg, hd)
  float* sc = vs + pg * hd;              // (ST, pg) scores, then probabilities
  float* okm = sc + ST * pg;             // (ST, pg) 1.0 where attended
  float* m = okm + ST * pg;              // (ST,)
  float* l = m + ST;                     // (ST,)
  float* alpha = l + ST;                 // (ST,) rescale of this page

  const int b = blockIdx.x, h = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nth >> 5;
  // this block's query rows are i0 .. i0 + R - 1 of the span; the first
  // nval of them are valid (i < span_len)
  const int i0 = blockIdx.z * ST, R = min(ST, S - i0);
  const int st = start[b] + i0, nval = max(0, min(R, span_len[b] - i0));
  const float sq = sqrtf((float)hd);

  for (int e = tid; e < R * hd; e += nth) {
    const int i = e / hd, d = e - i * hd;
    qs[e] = to_f(q[(((size_t)b * S + i0 + i) * H + h) * hd + d]);
    acc[e] = 0.f;
  }
  for (int i = tid; i < R; i += nth) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
  }

  // pages holding any key a valid query of the tile attends: [first, last]
  int first = 0, last = -1;
  if (nval > 0) {
    const long long lo = (long long)st - (long long)window + 1;
    first = lo > 0 ? (int)(lo / pg) : 0;
    last = min((st + nval - 1) / pg, MP - 1);
  }
  __syncthreads();

  for (int pi = first; pi <= last; ++pi) {
    const size_t phys = (size_t)page_table[(size_t)b * MP + pi];
    const size_t sidx = phys * KV + kvh;
    for (int e = tid; e < pg * hd; e += nth) {
      const int r = e / hd, d = e - r * hd;
      const size_t src = ((phys * pg + r) * KV + kvh) * hd + d;
      ks[r * kstride + d] = kp(src, sidx);
      vs[e] = vp(src, sidx);
    }
    __syncthreads();
    // scores of this page, masked
    for (int e = tid; e < R * pg; e += nth) {
      const int i = e / pg, r = e - i * pg;
      const int t = pi * pg + r, qpos = st + i;
      const bool ok = (t <= qpos) && (qpos - t < window);
      const float* qr = qs + i * hd;
      const float* kr = ks + r * kstride;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      sc[e] = ok ? dot / sq : NEG_BIG;
      okm[e] = ok ? 1.f : 0.f;
    }
    __syncthreads();
    // online softmax update, one warp per query row
    for (int i = warp; i < R; i += nwarp) {
      float mx = NEG_BIG;
      for (int r = lane; r < pg; r += 32) mx = fmaxf(mx, sc[i * pg + r]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[i];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int r = lane; r < pg; r += 32) {
        const float pv = expf(sc[i * pg + r] - m_new) * okm[i * pg + r];
        sc[i * pg + r] = pv;
        psum += pv;
      }
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        l[i] = l[i] * a + psum;
        m[i] = m_new;
        alpha[i] = a;
      }
    }
    __syncthreads();
    for (int e = tid; e < R * hd; e += nth) {
      const int i = e / hd, d = e - i * hd;
      const float* pr = sc + i * pg;
      float pv = 0.f;
      for (int r = 0; r < pg; ++r) pv = fmaf(pr[r], vs[r * hd + d], pv);
      acc[e] = acc[e] * alpha[i] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < R * hd; e += nth) {
    const int i = e / hd, d = e - i * hd;
    const float o = i < nval ? acc[e] / fmaxf(l[i], 1e-30f) : 0.f;
    out[(((size_t)b * S + i0 + i) * H + h) * hd + d] = from_f<QT>(o);
  }
}

template <typename QT, typename PR>
static int launch(const void* q, PR kp, PR vp, const int* pt,
                  const int* start, const int* span_len, int window,
                  void* out, int B, int S, int H, int hd, int pg, int KV,
                  int MP, int ST, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)ST * hd +
                                       (size_t)pg * (hd + 1) +
                                       (size_t)pg * hd + 2 * (size_t)ST * pg +
                                       3 * (size_t)ST);
  auto kern = paged_span_kernel<QT, PR>;
  cudaError_t err = prepare_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, H, (S + ST - 1) / ST);
  kern<<<grid, 128, smem, stream>>>(static_cast<const QT*>(q), kp, vp, pt,
                                    start, span_len, window,
                                    static_cast<QT*>(out), S, H, hd, pg, KV,
                                    MP, ST);
  return static_cast<int>(cudaGetLastError());
}

template <typename PR>
static int launch_q(const void* q, PR kp, PR vp, const void* page_table,
                    const void* start, const void* span_len, int window,
                    void* out, int B, int S, int H, int hd, int pg, int KV,
                    int MP, int ST, int q_dtype, cudaStream_t st) {
  if (ST < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int* pt = static_cast<const int*>(page_table);
  const int* sp = static_cast<const int*>(start);
  const int* sl = static_cast<const int*>(span_len);
  if (q_dtype == DT_F32)
    return launch<float>(q, kp, vp, pt, sp, sl, window, out, B, S, H, hd, pg,
                         KV, MP, ST, st);
  if (q_dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, kp, vp, pt, sp, sl, window, out, B, S, H,
                                 hd, pg, KV, MP, ST, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int paged_span_launch(const void* q, const void* kp, const void* vp,
                                 const void* page_table, const void* start,
                                 const void* span_len, int window, void* out,
                                 int B, int S, int H, int hd, int pg, int KV,
                                 int MP, int ST, int q_dtype, int kv_dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == DT_F32)
    return launch_q(q, FloatPages<float>{static_cast<const float*>(kp)},
                    FloatPages<float>{static_cast<const float*>(vp)},
                    page_table, start, span_len, window, out, B, S, H, hd, pg,
                    KV, MP, ST, q_dtype, st);
  if (kv_dtype == DT_BF16)
    return launch_q(
        q, FloatPages<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(kp)},
        FloatPages<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(vp)},
        page_table, start, span_len, window, out, B, S, H, hd, pg, KV, MP, ST,
        q_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 pages with (P, KV) fp32 scale rows for K and V
extern "C" int paged_span_q_launch(const void* q, const void* kp,
                                   const void* vp, const void* k_scales,
                                   const void* v_scales,
                                   const void* page_table, const void* start,
                                   const void* span_len, int window, void* out,
                                   int B, int S, int H, int hd, int pg, int KV,
                                   int MP, int ST, int q_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_q(q,
                  Int8Pages{static_cast<const int8_t*>(kp),
                            static_cast<const float*>(k_scales)},
                  Int8Pages{static_cast<const int8_t*>(vp),
                            static_cast<const float*>(v_scales)},
                  page_table, start, span_len, window, out, B, S, H, hd, pg,
                  KV, MP, ST, q_dtype, st);
}
