// Banded Levenshtein dictionary sweep, hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in veloci_tpu/ops/pallas_levenshtein.py:
//   * levenshtein_sweep_pallas_banded_batch (:341; default body
//     _kernel_banded_batch_dyn :198) -- Q queries against the dictionary;
//   * levenshtein_sweep_pallas_banded (:412; body _kernel_banded :133) --
//     the single-query form, launched here with q == 1, and, for a lone
//     request's fuzzy leaf, banded_select_kernel below.
// For every (query, term) pair it runs the Levenshtein DP restricted to the
// diagonal band |i - j| <= BAND (BAND 2 or 4) and writes the full-term
// distance, the minimum distance over term prefixes (1 << 20 outside the
// band and for empty terms) and the is-prefix flag, which the TPU code
// computes outside its kernel.
//
// Design. One thread per dictionary term. The term's 32 characters and the
// 2*BAND+1 band cells live in registers: the loop over query characters is
// fully unrolled (and left at each query's own length), so every character
// index is a compile-time constant. A block stages a chunk of the batch's
// queries in shared memory and loops over all of them, so each term's
// 64 bytes are read from device memory once per launch, not once per query.
// The transposed [32, N] layout is kept because it makes the term loads
// coalesce: for each character row, neighbouring threads read neighbouring
// terms.
//
// Bound. Integer work, not bytes: about Q * qlen * (2*BAND+1) cells of
// ~6 compare/min/add operations per term against 64 bytes read once, plus
// 9 bytes written per (query, term) pair. Making it fast (a length and
// bag-of-chars prefilter that drops rows before the DP, warp-level layouts)
// is later work.
//
// banded_select_kernel: one query's matches, compacted. A lone request's
// fuzzy leaf needs only the few rows with banded distance <= d (d <= BAND),
// not three [N] planes that the host then compares, sorts and reads back.
// One thread per term; the query rides in the kernel's parameters, so the
// call uploads nothing. lev >= |len - qlen|, so a row with |len - qlen| > d
// cannot match and skips the DP; the field's rows are sorted by length, so
// whole warps leave together after reading only the lengths. The DP is
// banded_dp below, shared with the batch kernel. Matches are appended with
// warp-aggregated compaction (a ballot, one atomicAdd per warp) as
// (row, term id, distance << 1 | is_prefix) into the call's output behind a
// count; the host reads the count and the matches back in one copy and
// sorts the few matches into (distance, row) order. Bound: 4 bytes read a
// term (its length), 64 more a term that passes the length test, 4 read
// and 12 written a match; 3 operations a band cell for those terms.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 32;         // term and query width (MAX_TERM_CHARS)
constexpr int kBig = 1 << 20;  // distance outside the band
constexpr int kQChunk = 64;    // queries staged in shared memory at a time
constexpr int kThreads = 256;

// The banded DP of one (query, term) pair: the full-term distance d, its
// minimum over term prefixes pd (kBig outside the band) and the is-prefix
// flag. c: the term's 32 chars; qchar(i): the query's char i.
template <int BAND, typename QChar>
__device__ __forceinline__ void banded_dp(const int (&c)[kL], int len, int qlen_raw, QChar qchar,
                                          int& d, int& pd, bool& pref) {
  constexpr int W = 2 * BAND + 1;
  const int qlen = min(qlen_raw, kL);
  // B[oi] = D[i][i + oi - BAND]; B[W] is a fixed out-of-band cell
  int B[W + 1];
#pragma unroll
  for (int oi = 0; oi <= W; ++oi) B[oi] = (oi < W && oi >= BAND) ? oi - BAND : kBig;
#pragma unroll
  for (int i = 1; i <= kL; ++i) {
    if (i > qlen) break;
    const int qc = qchar(i - 1);
    int prev = kBig;
#pragma unroll
    for (int oi = 0; oi < W; ++oi) {
      const int j = i + oi - BAND;
      int val;
      if (j < 0 || j > kL) {
        val = kBig;
      } else if (j == 0) {
        val = i;
      } else {
        // B[oi + 1] and B[oi] still hold row i - 1 here
        const int up = B[oi + 1] + 1;
        const int diag = B[oi] + (c[j - 1] != qc);
        val = min(min(min(up, diag), prev + 1), kBig);
      }
      prev = val;
      B[oi] = val;
    }
  }

  const int off = len - qlen + BAND;  // band cell of the term's end
  d = kBig;
  pd = kBig;
#pragma unroll
  for (int oi = 0; oi < W; ++oi) {
    const int pj = qlen + oi - BAND;  // term prefix length of this cell
    if (off == oi) d = B[oi];
    if (pj >= 0 && pj <= len) pd = min(pd, B[oi]);
  }
  pref = len > 0 && len >= qlen_raw;
#pragma unroll
  for (int j = 0; j < kL; ++j) pref = pref && (j >= qlen_raw || c[j] == qchar(j));
}

template <int BAND>
__global__ void __launch_bounds__(kThreads)
banded_sweep_kernel(const uint16_t* __restrict__ chars_t,  // [32, n]
                    const int32_t* __restrict__ term_lens,  // [n]
                    int n,
                    const uint16_t* __restrict__ queries,  // [q, 32]
                    const int32_t* __restrict__ query_lens,  // [q]
                    int q,
                    int32_t* __restrict__ dist,         // [q, n]
                    int32_t* __restrict__ prefix_dist,  // [q, n]
                    uint8_t* __restrict__ is_prefix) {  // [q, n]
  __shared__ int32_t s_q[kQChunk][kL];
  __shared__ int32_t s_qlen[kQChunk];

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = t < n;
  int c[kL];
  int len = 0;
#pragma unroll
  for (int j = 0; j < kL; ++j) c[j] = live ? chars_t[(size_t)j * n + t] : 0;
  if (live) len = term_lens[t];

  for (int base = 0; base < q; base += kQChunk) {
    const int nq = min(kQChunk, q - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < nq * kL; k += blockDim.x)
      s_q[k / kL][k % kL] = queries[(size_t)base * kL + k];
    for (int k = threadIdx.x; k < nq; k += blockDim.x) s_qlen[k] = query_lens[base + k];
    __syncthreads();
    if (!live) continue;

    for (int qq = 0; qq < nq; ++qq) {
      int d, pd;
      bool pref;
      banded_dp<BAND>(c, len, s_qlen[qq], [&](int i) { return s_q[qq][i]; }, d, pd, pref);

      const size_t idx = (size_t)(base + qq) * n + t;
      dist[idx] = len > 0 ? d : kBig;
      prefix_dist[idx] = len > 0 ? pd : kBig;
      is_prefix[idx] = pref ? 1 : 0;
    }
  }
}

// The query of banded_select_kernel, passed by value (kernel parameters).
struct SelectQuery {
  uint16_t c[kL];
  int len;
};

template <int BAND>
__global__ void __launch_bounds__(kThreads)
banded_select_kernel(const uint16_t* __restrict__ chars_t,   // [32, n], rows sorted by length
                     const int32_t* __restrict__ term_lens,  // [n]
                     const int32_t* __restrict__ sweep_ids,  // [n] row -> term id
                     int n,
                     const SelectQuery q,
                     int limit,                              // d <= BAND
                     int32_t* __restrict__ out) {            // [1 + 3 * n]: count, then matches
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int len = t < n ? term_lens[t] : 0;
  const bool near = len > 0 && abs(len - min(q.len, kL)) <= limit;
  if (!__any_sync(kAll, near)) return;  // the whole warp: no row within the limit's lengths

  bool match = false;
  int d = kBig;
  bool pref = false;
  if (near) {
    int c[kL];
#pragma unroll
    for (int j = 0; j < kL; ++j) c[j] = chars_t[(size_t)j * n + t];
    int pd;
    banded_dp<BAND>(c, len, q.len, [q](int i) { return (int)q.c[i]; }, d, pd, pref);
    match = d <= limit;
  }
  const unsigned mask = __ballot_sync(kAll, match);
  if (!mask) return;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(out, __popc(mask));
  base = __shfl_sync(kAll, base, leader);
  if (match) {
    int32_t* m = out + 1 + 3 * (base + __popc(mask & ((1u << lane) - 1u)));
    m[0] = t;
    m[1] = sweep_ids[t];
    m[2] = (d << 1) | (pref ? 1 : 0);
  }
}

}  // namespace

// Launches the sweep on `stream`; returns cudaGetLastError() of the launch.
extern "C" int veloci_banded_sweep(const void* chars_t, const void* term_lens, int n,
                                   const void* queries, const void* query_lens, int q,
                                   int band, void* dist, void* prefix_dist,
                                   void* is_prefix, void* stream) {
  if (n <= 0 || q <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ct = static_cast<const uint16_t*>(chars_t);
  const auto* tl = static_cast<const int32_t*>(term_lens);
  const auto* qs = static_cast<const uint16_t*>(queries);
  const auto* ql = static_cast<const int32_t*>(query_lens);
  auto* d = static_cast<int32_t*>(dist);
  auto* pd = static_cast<int32_t*>(prefix_dist);
  auto* ip = static_cast<uint8_t*>(is_prefix);
  if (band == 2) {
    banded_sweep_kernel<2><<<grid, kThreads, 0, s>>>(ct, tl, n, qs, ql, q, d, pd, ip);
  } else if (band == 4) {
    banded_sweep_kernel<4><<<grid, kThreads, 0, s>>>(ct, tl, n, qs, ql, q, d, pd, ip);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One query's matches: zeroes the count, then launches banded_select_kernel
// on `stream`. `query` is a host array of 32 uint16 code points; `out`
// holds at least 1 + 3 * n int32. Returns cudaGetLastError() of the launch.
extern "C" int veloci_banded_select(const void* chars_t, const void* term_lens, const void* sweep_ids,
                                    int n, const void* query, int query_len, int band, int limit,
                                    void* out, void* stream) {
  if (limit < 0 || limit > band) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t), s);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  SelectQuery q;
  memcpy(q.c, query, sizeof(q.c));
  q.len = query_len;
  const dim3 grid((n + kThreads - 1) / kThreads);
  const auto* ct = static_cast<const uint16_t*>(chars_t);
  const auto* tl = static_cast<const int32_t*>(term_lens);
  const auto* ids = static_cast<const int32_t*>(sweep_ids);
  auto* o = static_cast<int32_t*>(out);
  if (band == 2) {
    banded_select_kernel<2><<<grid, kThreads, 0, s>>>(ct, tl, ids, n, q, limit, o);
  } else if (band == 4) {
    banded_select_kernel<4><<<grid, kThreads, 0, s>>>(ct, tl, ids, n, q, limit, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* veloci_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
