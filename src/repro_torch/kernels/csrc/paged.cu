// Flash attention of each row's S-query span over KV pages gathered through
// a page table.  Replaces the Pallas kernel ``paged_attention_span`` /
// ``_paged_attention_span`` / ``_paged_span_kernel`` / ``_span_attend`` of
// repro/kernels/paged.py (fp32 and bf16 pages).
//
// q: (B, S, H, hd); k/v pages: (P, pg, KV, hd); page_table: (B, MP) int32;
// start, span_len: (B,) int32; window: int -> out: (B, S, H, hd), q's dtype.
// Row b's query i sits at position start[b] + i and is valid iff
// i < span_len[b]; it attends key t iff t <= start[b] + i and
// start[b] + i - t < window (window = 1e9 means global).  GQA: query head h
// reads KV head h / (H / KV).
//
// Grid (B, H, ceil(S / ST)): one block per (sequence, query head, tile of
// ST query rows), so a block's working set does not grow with the span.
// The TPU's sequential page grid axis becomes a loop inside the block, which
// reads the physical page id from the page table itself and stages that
// page's (pg, hd) K and V rows of its KV head in shared memory.  The running
// max m, normalizer l and accumulator acc of the block's ST queries stay in
// shared memory across the loop, with the reference's semantics: m starts
// at -1e30 (not -inf),
// masked scores are -1e30, probabilities are multiplied by the mask (a fully
// masked page adds nothing), the output is acc / max(l, 1e-30), and rows
// i >= span_len are zero.  Pages wholly before the tile's window or after
// its last valid position are skipped: under those semantics they would
// leave m, l and acc bit-identical.
//
// Shared memory (floats): 2*ST*hd (q, acc) + pg*(hd+1) + pg*hd (K, V) +
// 2*ST*pg (scores, mask) + 3*ST (m, l, rescale); kernels/paged.py:smem_bytes.
#include "common.cuh"

#define NEG_BIG (-1e30f)

template <typename QT, typename KT>
__global__ void paged_span_kernel(const QT* __restrict__ q,
                                  const KT* __restrict__ kp,
                                  const KT* __restrict__ vp,
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
    for (int e = tid; e < pg * hd; e += nth) {
      const int r = e / hd, d = e - r * hd;
      const size_t src = ((phys * pg + r) * KV + kvh) * hd + d;
      ks[r * kstride + d] = to_f(kp[src]);
      vs[e] = to_f(vp[src]);
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

template <typename QT, typename KT>
static int launch(const void* q, const void* kp, const void* vp,
                  const int* pt, const int* start, const int* span_len,
                  int window, void* out, int B, int S, int H, int hd, int pg,
                  int KV, int MP, int ST, size_t smem, cudaStream_t stream) {
  auto kern = paged_span_kernel<QT, KT>;
  cudaError_t err = prepare_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, H, (S + ST - 1) / ST);
  kern<<<grid, 128, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), pt, start, span_len, window,
      static_cast<QT*>(out), S, H, hd, pg, KV, MP, ST);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int paged_span_launch(const void* q, const void* kp, const void* vp,
                                 const void* page_table, const void* start,
                                 const void* span_len, int window, void* out,
                                 int B, int S, int H, int hd, int pg, int KV,
                                 int MP, int ST, int q_dtype, int kv_dtype,
                                 void* stream) {
  if (ST < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * (size_t)ST * hd +
                                       (size_t)pg * (hd + 1) +
                                       (size_t)pg * hd + 2 * (size_t)ST * pg +
                                       3 * (size_t)ST);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* sp = static_cast<const int*>(start);
  const int* sl = static_cast<const int*>(span_len);
  if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    return launch<float, float>(q, kp, vp, pt, sp, sl, window, out, B, S, H,
                                hd, pg, KV, MP, ST, smem, st);
  if (q_dtype == DT_F32 && kv_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(q, kp, vp, pt, sp, sl, window, out, B,
                                        S, H, hd, pg, KV, MP, ST, smem, st);
  if (q_dtype == DT_BF16 && kv_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(q, kp, vp, pt, sp, sl, window, out, B,
                                        S, H, hd, pg, KV, MP, ST, smem, st);
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kp, vp, pt, sp, sl, window,
                                                out, B, S, H, hd, pg, KV, MP,
                                                ST, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
