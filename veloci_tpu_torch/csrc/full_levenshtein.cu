// Full-width Levenshtein dictionary sweep, hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel levenshtein_sweep_pallas
// (veloci_tpu/ops/pallas_levenshtein.py:72; body _kernel :39, is-prefix pass
// :111-116), and with it the XLA sweep levenshtein.levenshtein_sweep (:57)
// that the JAX package runs for starts_with leaves and distances above 4.
// For every (query, term) pair it gives the true full-term distance, the
// minimum distance over the term's prefixes (the starts_with criterion) and
// the is-prefix flag. Rows of length 0 give 1 << 20 for both distances and
// is_prefix false; a query of length 0 gives dist = term length and
// prefix_dist = 0; a query longer than 32 chars is swept on its first 32 and
// is no term's prefix.
//
// Design: Myers' bit-parallel algorithm in Hyyro's edit-distance form. The
// query (at most 32 chars) is the pattern, one bit per char in a 32-bit word;
// the term is the text. After j term chars the running score is
// lev(query, term[:j]), so dist is the score at the term's length and
// prefix_dist the least score over j <= length: one step of ~16 integer
// operations per term char replaces a column of the DP (qlen cells of ~6
// operations each). Bit j of the step's match mask Eq says query[j] ==
// term[j], so the is-prefix test rides along in the same walk.
//
// One thread per dictionary term; its 32 chars live in registers, read once
// per launch from the [32, N] layout (coalesced). A block stages a chunk of
// 32 queries in shared memory as match tables: Peq[q][c] for the code points
// c < 256 (1 KB a query), and per query the list of its distinct code points
// above 255 with their masks. A warp whose terms are all below 256 (the
// common case, known once per launch) takes a walk that only reads the
// table; any other warp takes one that also scans the list, kept rolled so
// the unrolled walk stays small. The walk is unrolled with every register
// index a constant and leaves at the warp's longest term, a warp-uniform
// exit; past its own length a thread's results are masked, not branched on
// (a per-thread exit made every step a divergent branch, which cost 4x in
// the DP kernel this replaces). The index sorts each field's rows by length,
// so a warp's terms are alike and few steps are masked.
//
// Bound. Integer work: ~16 operations per (query, term char) pair, about
// Q * sum(term lengths) * 16 in all, against 64 + 4 bytes read per term and
// 9 bytes written per (query, term) pair: the integer pipes bound it, the
// 9-byte outputs come second. The match-table lookup is a shared-memory load
// per step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 32;         // term and query width (MAX_TERM_CHARS)
constexpr int kBig = 1 << 20;  // distance reported for rows of length 0
constexpr int kQChunk = 32;    // queries staged in shared memory at a time
constexpr int kThreads = 256;
constexpr int kTable = 256;    // code points with a direct match-table entry

// One query's walk over one term: Myers / Hyyro bit-parallel steps, one a
// term char. kHigh: some term of the warp has a code point >= 256, so a
// char's match mask comes from the table only below 256 and from the
// query's list of code points >= 256 above.
template <bool kHigh>
__device__ __forceinline__ void walk(const int (&c)[kL], int len, int warp_len, int m,
                                     const uint32_t* __restrict__ peq,
                                     const uint16_t* __restrict__ hc,
                                     const uint32_t* __restrict__ hm, int nh,
                                     int& d, int& pd, bool& pref) {
  const int top = m - 1;  // the bit of the last query char
  uint32_t pv = ~0u, mv = 0u;
  int score = m;  // lev(query, "")
  pd = m;
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    if (j >= warp_len) break;
    const int ch = c[j];
    uint32_t eq;
    if (kHigh) {
      eq = ch < kTable ? peq[min(ch, kTable - 1)] : 0u;
#pragma unroll 1
      for (int h = 0; h < nh; ++h) eq = hc[h] == ch ? hm[h] : eq;
    } else {
      eq = peq[ch];
    }
    const uint32_t xv = eq | mv;
    const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
    uint32_t ph = mv | ~(xh | pv);
    const uint32_t mh = pv & xh;
    score += (int)((ph >> top) & 1u) - (int)((mh >> top) & 1u);
    ph = (ph << 1) | 1u;  // row 0 of the DP grows by one per term char
    pv = (mh << 1) | ~(xv | ph);
    mv = ph & xv;
    if (j < len) pd = min(pd, score);
    if (j + 1 == len) d = score;
    if (j < m) pref = pref && ((eq >> j) & 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
full_sweep_kernel(const uint16_t* __restrict__ chars_t,   // [32, n]
                  const int32_t* __restrict__ term_lens,  // [n], each in [0, 32]
                  int n,
                  const uint16_t* __restrict__ queries,     // [q, 32]
                  const int32_t* __restrict__ query_lens,   // [q]
                  int q,
                  int32_t* __restrict__ dist,         // [q, n]
                  int32_t* __restrict__ prefix_dist,  // [q, n]
                  uint8_t* __restrict__ is_prefix) {  // [q, n]
  __shared__ uint32_t s_peq[kQChunk][kTable];  // bit i: query[i] == c
  __shared__ uint16_t s_q[kQChunk][kL];
  __shared__ uint16_t s_hc[kQChunk][kL];  // a query's distinct code points >= 256
  __shared__ uint32_t s_hm[kQChunk][kL];  // and their masks
  __shared__ int32_t s_nh[kQChunk];
  __shared__ int32_t s_qlen[kQChunk];

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = t < n;
  int c[kL];
#pragma unroll
  for (int j = 0; j < kL; ++j) c[j] = live ? chars_t[(size_t)j * n + t] : 0;
  const int len = live ? term_lens[t] : 0;
  const int warp_len = __reduce_max_sync(0xffffffffu, len);
  bool high = false;
#pragma unroll
  for (int j = 0; j < kL; ++j) high = high || c[j] >= kTable;
  const bool warp_high = __any_sync(0xffffffffu, high);

  for (int base = 0; base < q; base += kQChunk) {
    const int nq = min(kQChunk, q - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < nq * kTable; k += blockDim.x) (&s_peq[0][0])[k] = 0u;
    for (int k = threadIdx.x; k < nq * kL; k += blockDim.x)
      s_q[k / kL][k % kL] = queries[(size_t)base * kL + k];
    for (int k = threadIdx.x; k < nq; k += blockDim.x) s_qlen[k] = query_lens[base + k];
    __syncthreads();
    for (int k = threadIdx.x; k < nq * kL; k += blockDim.x) {
      const int qq = k / kL, i = k % kL;
      const int ch = s_q[qq][i];
      if (i < min(s_qlen[qq], kL) && ch < kTable) atomicOr(&s_peq[qq][ch], 1u << i);
    }
    for (int qq = threadIdx.x; qq < nq; qq += blockDim.x) {
      const int m = min(s_qlen[qq], kL);
      int nh = 0;
      for (int i = 0; i < m; ++i) {
        const uint16_t ch = s_q[qq][i];
        if (ch < kTable) continue;
        int h = 0;
        while (h < nh && s_hc[qq][h] != ch) ++h;
        if (h == nh) {
          s_hc[qq][h] = ch;
          s_hm[qq][h] = 0u;
          ++nh;
        }
        s_hm[qq][h] |= 1u << i;
      }
      s_nh[qq] = nh;
    }
    __syncthreads();
    if (!live) continue;

    for (int qq = 0; qq < nq; ++qq) {
      const int qlen_raw = s_qlen[qq];
      const int m = min(qlen_raw, kL);
      bool pref = len > 0 && len >= qlen_raw;
      int d = len;  // lev("", term) for an empty query
      int pd = 0;
      if (m > 0) {
        if (warp_high)
          walk<true>(c, len, warp_len, m, s_peq[qq], s_hc[qq], s_hm[qq], s_nh[qq], d, pd, pref);
        else
          walk<false>(c, len, warp_len, m, s_peq[qq], s_hc[qq], s_hm[qq], s_nh[qq], d, pd, pref);
      }
      const size_t idx = (size_t)(base + qq) * n + t;
      dist[idx] = len > 0 ? d : kBig;
      prefix_dist[idx] = len > 0 ? pd : kBig;
      is_prefix[idx] = pref ? 1 : 0;
    }
  }
}

}  // namespace

// Launches the sweep on `stream`; returns cudaGetLastError() of the launch.
extern "C" int veloci_full_sweep(const void* chars_t, const void* term_lens, int n,
                                 const void* queries, const void* query_lens, int q,
                                 void* dist, void* prefix_dist, void* is_prefix,
                                 void* stream) {
  if (n <= 0 || q <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads);
  full_sweep_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(chars_t), static_cast<const int32_t*>(term_lens), n,
      static_cast<const uint16_t*>(queries), static_cast<const int32_t*>(query_lens), q,
      static_cast<int32_t*>(dist), static_cast<int32_t*>(prefix_dist),
      static_cast<uint8_t*>(is_prefix));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* veloci_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
