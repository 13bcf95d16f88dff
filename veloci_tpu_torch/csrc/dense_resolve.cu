// Dense posting resolve, hand-written CUDA for Hopper (sm_90a).
//
// Replaces the XLA-built resolve of veloci_tpu/ops/postings.py
// (_resolve_kernel :83, wrapped by resolve_to_anchor_dense :126), which the
// reference's per-request executor runs for every search leaf. It is the
// one device step of that executor outside the Levenshtein sweeps.
//
// Function. A leaf's matched terms, each with a run of packed
// (anchor, f32 score bits) int32 rows in the combined posting CSR, give a
// [num_docs] f32 plane: per anchor, the maximum over the leaf's rows of
// bits_as_f32(row[1]) * term_score (one f32 multiply, rounded once), and 0
// where no row lands or the maximum is not finite. Anchors outside
// [0, num_docs) are dropped.
//
// Design. The plane is held as order-preserving uint32 keys of the f32
// values (the sign bit flipped for non-negative values, every bit for
// negative ones), so the float maximum is an integer atomicMax and 0 -- the
// key below every float but the negative NaNs -- means "no row". Three steps
// on the caller's stream:
//   1. cudaMemsetAsync the plane to key 0;
//   2. one thread per gathered posting row over the leaf's runs laid end to
//      end: a binary search of the runs' exclusive scan (row_starts) gives
//      the thread its term, the term's run start in the CSR gives its row;
//      atomicMax of the product's key into the plane;
//   3. one thread per document maps the key back to f32, 0 where not finite.
// The maximum does not depend on the order of the atomics, so the plane is
// bit-equal to the plain version (scatter_reduce "amax") on every run.
//
// Bound. Bytes: 8 per gathered row read (random anchors: each atomic is a
// 4-byte read-modify-write in L2), 4 per document written. The arithmetic
// is one multiply per row. A simple kernel first: the memset and the
// finalise pass each touch the whole plane once more.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t float_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__global__ void __launch_bounds__(kThreads)
scatter_max_kernel(const int64_t* __restrict__ offsets,      // [num_keys + 2]
                   const int2* __restrict__ packed,          // [nnz] (anchor, score bits)
                   const int32_t* __restrict__ term_ids,     // [t] global term ids
                   const float* __restrict__ term_scores,    // [t]
                   const int64_t* __restrict__ row_starts,   // [t + 1] exclusive scan of run lengths
                   int t,
                   int64_t total_rows,
                   int num_docs,
                   uint32_t* __restrict__ keys) {            // [num_docs]
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total_rows) return;
  // the last term whose run starts at or before row i (empty runs skipped)
  int lo = 0, hi = t - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (row_starts[mid] <= i) lo = mid; else hi = mid - 1;
  }
  const int2 row = packed[offsets[term_ids[lo]] + (i - row_starts[lo])];
  if (row.x < 0 || row.x >= num_docs) return;
  const float s = __fmul_rn(__int_as_float(row.y), term_scores[lo]);
  atomicMax(keys + row.x, float_key(s));
}

__global__ void __launch_bounds__(kThreads)
finalise_kernel(uint32_t* __restrict__ plane, int num_docs) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= num_docs) return;
  const float v = key_float(plane[d]);
  reinterpret_cast<float*>(plane)[d] = isfinite(v) ? v : 0.0f;
}

}  // namespace

extern "C" int veloci_dense_resolve(const void* offsets, const void* packed, const void* term_ids,
                                    const void* term_scores, const void* row_starts, int t,
                                    long long total_rows, int num_docs, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_docs <= 0) return cudaSuccess;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)num_docs * sizeof(uint32_t), s);
  if (err != cudaSuccess) return err;
  uint32_t* keys = static_cast<uint32_t*>(out);
  if (total_rows > 0 && t > 0) {
    const long long blocks = (total_rows + kThreads - 1) / kThreads;
    scatter_max_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const int64_t*>(offsets), static_cast<const int2*>(packed),
        static_cast<const int32_t*>(term_ids), static_cast<const float*>(term_scores),
        static_cast<const int64_t*>(row_starts), t, total_rows, num_docs, keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  finalise_kernel<<<(num_docs + kThreads - 1) / kThreads, kThreads, 0, s>>>(keys, num_docs);
  return cudaGetLastError();
}

extern "C" const char* veloci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
