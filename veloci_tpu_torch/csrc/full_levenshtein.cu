// Full-width Levenshtein dictionary sweep, hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel levenshtein_sweep_pallas
// (veloci_tpu/ops/pallas_levenshtein.py:72; body _kernel :39, is-prefix pass
// :111-116), and with it the XLA sweep levenshtein.levenshtein_sweep (:57)
// that the JAX package runs for starts_with leaves and distances above 4.
// For every (query, term) pair it runs the whole Levenshtein DP, all 33
// columns, and writes the true full-term distance, the minimum distance over
// the term's prefixes (the starts_with criterion) and the is-prefix flag.
// Rows of length 0 give 1 << 20 for both distances and is_prefix false; a
// query of length 0 gives dist = term length and prefix_dist = 0.
//
// Design (the banded kernel's, without the band). One thread per dictionary
// term. The term's 32 characters and the 33 DP cells of the current row live
// in registers: both loops (query characters, term columns) are unrolled, so
// every index is a compile-time constant. The row is updated in place, left
// to right, keeping the previous row's cell j-1 in one register (the
// diagonal). The loop over query characters leaves at the query's own
// length, which is the same for the whole block. The row itself has no
// branch: all 32 columns are computed, and those past the term's length are
// ignored (no column feeds one before it). Leaving the row at each term's
// own length instead made every cell a divergent branch and the kernel
// 4-7x slower on the H100. A block stages a chunk of the batch's queries in shared memory and
// loops over all of them, so each term's 64 bytes are read from device memory
// once per launch, not once per query; the [32, N] layout makes those reads
// coalesce.
//
// Bound. Integer work: Q * qlen * 32 cells of ~5 compare/min/add operations
// per term, against 64 bytes read once and 9 bytes written per (query,
// term) pair. Making it faster (a length and bag-of-chars prefilter, a
// bit-parallel row) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 32;         // term and query width (MAX_TERM_CHARS)
constexpr int kBig = 1 << 20;  // distance reported for rows of length 0
constexpr int kQChunk = 64;    // queries staged in shared memory at a time
constexpr int kThreads = 256;

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
      const int qlen_raw = s_qlen[qq];
      const int qlen = min(qlen_raw, kL);
      int D[kL + 1];  // D[j] = lev(query[:i], term[:j]) for the current row i
#pragma unroll
      for (int j = 0; j <= kL; ++j) D[j] = j;
#pragma unroll
      for (int i = 1; i <= kL; ++i) {
        if (i > qlen) break;
        const int qc = s_q[qq][i - 1];
        int diag = D[0];  // row i - 1, column j - 1
        D[0] = i;
#pragma unroll
        for (int j = 1; j <= kL; ++j) {
          const int up = D[j];  // row i - 1, column j
          const int cand = min(up + 1, diag + (c[j - 1] != qc));
          D[j] = min(D[j - 1] + 1, cand);
          diag = up;
        }
      }

      int d = 0;
      int pd = kBig;
#pragma unroll
      for (int j = 0; j <= kL; ++j) {
        if (j == len) d = D[j];
        if (j <= len) pd = min(pd, D[j]);
      }
      bool pref = len > 0 && len >= qlen_raw;
#pragma unroll
      for (int j = 0; j < kL; ++j) pref = pref && (j >= qlen_raw || c[j] == s_q[qq][j]);

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
