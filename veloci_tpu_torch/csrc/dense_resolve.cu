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
// Two paths, both bit-equal to the plain version (scatter_reduce "amax",
// then non-finite -> 0):
//   * direct (the common case): when every row score and every term score
//     is a finite float with its sign bit clear and no product can overflow
//     (the host proves it: ops/postings.py, dense_fast_path), every product
//     is such a float too, and for those the int32 bit pattern orders like
//     the float. The plane is memset to 0 (+0.0, which also stands for "no
//     row") and each row does an integer atomicMax of its product's bits:
//     one kernel, no pass after it. -0.0 is why the sign bit must be clear:
//     it orders below +0.0 as an integer.
//   * keys: otherwise the plane holds order-preserving uint32 keys of the
//     f32 values (the sign bit flipped for non-negative values, every bit
//     for negative ones), 0 -- the key below every float but the negative
//     NaNs -- meaning "no row"; after the scatter, one pass maps the keys
//     back to f32, 0 where not finite.
// The maximum does not depend on the order of the atomics, so either plane
// is the same on every run.
//
// Design. The leaf's runs are laid end to end (row_starts, their exclusive
// scan) and cut into chunks of kChunk rows. A persistent grid walks the
// chunks; a block finds the terms of its chunk's first and last row once
// (every thread reads the same words, a broadcast), so a row needs a search
// only where a chunk spans several runs, and then only between those two
// terms. Leaves of at most kStageTerms terms (every leaf of the main path)
// stage each term's run start, row_starts and score in shared memory once
// per block: 8 resident blocks of 256 threads fill an SM's 2,048 threads,
// and 1,024 terms x 20 bytes (20 KB) stays below 227 KB / 8, so staging
// never costs occupancy. A warp reads kRowsPerThread rows per thread of one
// run at a time, consecutive 8-byte rows for consecutive lanes (coalesced),
// all loads issued before the atomics; the atomics return nothing, so they
// compile to RED.
//
// Bound. Bytes: 8 per gathered row read, 4 per document written (the
// arithmetic is one multiply per row). The memset writes the plane once;
// the keys path's finalise reads and writes it once more.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kChunk = kThreads * kRowsPerThread;
constexpr int kStageTerms = 1024;
constexpr int kBlocksPerSm = 2048 / kThreads;

__device__ __forceinline__ uint32_t float_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// the last term k in [lo, hi] whose run starts at or before row i (empty
// runs are skipped: the run that holds i is the last one starting <= i)
__device__ __forceinline__ int term_of(const int64_t* starts, int lo, int hi, int64_t i) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <bool KEYS, bool STAGED>
__global__ void __launch_bounds__(kThreads)
scatter_max_kernel(const int64_t* __restrict__ offsets,      // [num_keys + 2]
                   const int2* __restrict__ packed,          // [nnz] (anchor, score bits)
                   const int32_t* __restrict__ term_ids,     // [t] global term ids
                   const float* __restrict__ term_scores,    // [t]
                   const int64_t* __restrict__ row_starts,   // [t + 1] exclusive scan of run lengths
                   int t,
                   int64_t total_rows,
                   int num_docs,
                   uint32_t* __restrict__ plane) {           // [num_docs]
  // STAGED: row_starts [t + 1], each term's CSR start minus its row start
  // [t], its score [t]
  extern __shared__ int64_t smem[];
  int64_t* s_start = smem;
  int64_t* s_base = smem + t + 1;
  float* s_score = reinterpret_cast<float*>(s_base + t);
  if (STAGED) {
    for (int k = threadIdx.x; k <= t; k += kThreads) s_start[k] = row_starts[k];
    for (int k = threadIdx.x; k < t; k += kThreads) {
      s_base[k] = offsets[term_ids[k]] - row_starts[k];
      s_score[k] = term_scores[k];
    }
    __syncthreads();
  }
  const int64_t* starts = STAGED ? s_start : row_starts;

  for (int64_t cs = (int64_t)blockIdx.x * kChunk; cs < total_rows; cs += (int64_t)gridDim.x * kChunk) {
    const int64_t ce = min(cs + (int64_t)kChunk, total_rows);
    const int lo = term_of(starts, 0, t - 1, cs);
    const int hi = term_of(starts, lo, t - 1, ce - 1);
    int2 row[kRowsPerThread];
    float score[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int64_t i = cs + k * kThreads + threadIdx.x;
      row[k] = make_int2(-1, 0);
      score[k] = 0.0f;
      if (i < ce) {
        const int term = lo == hi ? lo : term_of(starts, lo, hi, i);
        const int64_t base = STAGED ? s_base[term] : offsets[term_ids[term]] - starts[term];
        score[k] = STAGED ? s_score[term] : term_scores[term];
        row[k] = packed[base + i];
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (row[k].x < 0 || row[k].x >= num_docs) continue;
      const float s = __fmul_rn(__int_as_float(row[k].y), score[k]);
      atomicMax(plane + row[k].x, KEYS ? float_key(s) : __float_as_uint(s));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
finalise_kernel(uint32_t* __restrict__ plane, int num_docs) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= num_docs) return;
  const float v = key_float(plane[d]);
  reinterpret_cast<float*>(plane)[d] = isfinite(v) ? v : 0.0f;
}

template <bool KEYS, bool STAGED>
cudaError_t launch_scatter(const int64_t* offsets, const int2* packed, const int32_t* term_ids,
                           const float* term_scores, const int64_t* row_starts, int t,
                           long long total_rows, int num_docs, uint32_t* plane, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long chunks = (total_rows + kChunk - 1) / kChunk;
  const long long blocks = chunks < (long long)sms * kBlocksPerSm ? chunks : (long long)sms * kBlocksPerSm;
  const size_t shared = STAGED ? (size_t)(t + 1 + t) * sizeof(int64_t) + (size_t)t * sizeof(float) : 0;
  scatter_max_kernel<KEYS, STAGED><<<(unsigned)blocks, kThreads, shared, s>>>(
      offsets, packed, term_ids, term_scores, row_starts, t, total_rows, num_docs, plane);
  return cudaGetLastError();
}

}  // namespace

// keys == 0: the direct path (the caller has proved its condition); else
// the keys path with its finalise pass.
extern "C" int veloci_dense_resolve(const void* offsets, const void* packed, const void* term_ids,
                                    const void* term_scores, const void* row_starts, int t,
                                    long long total_rows, int num_docs, int keys, void* out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_docs <= 0) return cudaSuccess;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)num_docs * sizeof(uint32_t), s);
  if (err != cudaSuccess) return err;
  uint32_t* plane = static_cast<uint32_t*>(out);
  if (total_rows > 0 && t > 0) {
    const auto* o = static_cast<const int64_t*>(offsets);
    const auto* p = static_cast<const int2*>(packed);
    const auto* ids = static_cast<const int32_t*>(term_ids);
    const auto* sc = static_cast<const float*>(term_scores);
    const auto* rs = static_cast<const int64_t*>(row_starts);
    const bool staged = t <= kStageTerms;
    if (keys) {
      err = staged ? launch_scatter<true, true>(o, p, ids, sc, rs, t, total_rows, num_docs, plane, s)
                   : launch_scatter<true, false>(o, p, ids, sc, rs, t, total_rows, num_docs, plane, s);
    } else {
      err = staged ? launch_scatter<false, true>(o, p, ids, sc, rs, t, total_rows, num_docs, plane, s)
                   : launch_scatter<false, false>(o, p, ids, sc, rs, t, total_rows, num_docs, plane, s);
    }
    if (err != cudaSuccess) return err;
  }
  if (!keys) return cudaSuccess;
  finalise_kernel<<<(num_docs + kThreads - 1) / kThreads, kThreads, 0, s>>>(plane, num_docs);
  return cudaGetLastError();
}

extern "C" const char* veloci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
