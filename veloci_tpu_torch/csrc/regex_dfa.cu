// Regex DFA walk over a field's terms, hand-written CUDA for Hopper (sm_90a).
//
// Replaces the XLA-built sweep of veloci_tpu/ops/regex_dfa.py
// (_sweep_kernel :339, wrapped by regex_match_device :384), the device
// prefilter of a regex leaf. There, every term's DFA state advances in
// lockstep, one lax.scan step a char position, each step C one-hot [S, S]
// matmuls on the MXU.
//
// Function. A DFA over character classes (at most 29 boundaries, so at
// most 30 classes, and at most 64 states) runs over each row of a [W, N]
// char matrix: a char's class is the number of boundaries <= its code
// point (above 0xFFFF it reads as U+FFFD, as the sweep matrix stores it);
// state 0 is the start; a row takes min(len, W) steps. Full mode: the row
// matches if its last state accepts. Prefix mode: it matches if state 0
// accepts or any state after a step does. A row of length 0 never matches.
// One byte a row out, 1 or 0.
//
// Design. The walk is a serial, data-dependent table walk with no product
// to feed tensor cores, so it is one thread a row. A row's time is its
// chain of dependent steps, and the design keeps all it can off that chain:
// - A char's class does not depend on the state. The host folds the class
//   search into the kernel's argument (ops/regex_dfa.build_walk_argument,
//   built once a CompiledDfa): an ASCII char's class offset is one read of
//   a 128-entry table; any other char's is one constant when no boundary
//   lies in (127, 0xFFFF] (as for every ASCII pattern), else a binary
//   search of those boundaries. So a chunk's class offsets are computed
//   ahead of its chain, without a branch for an ASCII pattern.
// - A transition entry holds the next state with its accept and dead bits,
//   so a step on the chain is one shared-memory read.
// - A row's chars do not depend on the state either. They are loaded a
//   chunk at a time (4 chars of a sweep row, 8 of a long row), and from the
//   second chunk on the next chunk is in flight while the current one is
//   walked (a row that stops in its first chunk reads no further). The transposed u16 sweep rows (stride_pos = N,
//   stride_row = 1) give a warp one coalesced line a position; the long
//   rows' row-major int32 codes (stride_pos = 1, stride_row = W) are read
//   16 or 8 bytes a load where the rows are so aligned, so a warp's load
//   touches 32 lines for 4 or 2 chars a lane instead of 1.
// - One launch walks both of a field's matrices, each block a range of one
//   matrix's rows, into one output.
// - The DFA travels as a __grid_constant__ argument (no copy from the
//   host), and each block stages the part in use in shared memory.
// A row stops at its length, at the dead state, or, in prefix mode, at its
// first accept, tested once a chunk.
//
// Bound. Bytes: 4 a row for its length, 2 a char walked of a u16 row or 4
// of an int32 row, 1 a row written. Operations: ceil(log2 C) + 2 integer
// operations a char step (the function's class search, table read and stop
// test, whatever this design does instead). The bytes bound is the larger.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShortChunk = 4;  // chars a u16 sweep row (at most 32) loads at once
constexpr int kLongChunk = 8;  // chars an int32 long row loads at once
constexpr int kMaxBounds = 32;  // MAX_CLASSES - 1 = 29 used
constexpr int kTable = 30 * 64;  // MAX_CLASSES x MAX_STATES
constexpr uint32_t kAccepts = 0x40;  // entry bit: the next state accepts
constexpr uint32_t kDead = 0x80;  // entry bit: the next state is the dead state

// The layout of ops/regex_dfa.WALK_ARG, byte for byte.
struct WalkDfa {
  uint8_t next[kTable];  // [class * states + state] = next state | kAccepts | kDead
  uint16_t ascii[128];  // class * states of each code point below 128
  uint32_t high[kMaxBounds];  // the boundaries in (127, 0xFFFF], ascending
  int32_t nhigh;  // how many
  int32_t high_class;  // the boundaries at or below 127: a char >= 128's least class
  int32_t states;
  int32_t start_accepts;  // state 0 accepts
  int32_t used;  // bytes of next in use: classes * states
};
static_assert(sizeof(WalkDfa) == kTable + 256 + 4 * kMaxBounds + 20, "WalkDfa must match WALK_ARG");

struct Rows {
  const void* chars;
  long long stride_pos, stride_row;
  const int32_t* lens;
  uint8_t* out;
  int n, width, elem_bytes, blocks;
  int vec;  // chars a load of a row-major int32 row reads: 4, 2 or 1
};

struct Launch {
  Rows part[2];
};

struct Tables {
  const uint8_t* next;
  const uint16_t* ascii;
  const uint32_t* high;
  int nhigh, high_class, states;
};

// The class offset (class * states) of code point c. kPlain, the same for
// the whole launch: no boundary lies in (127, 0xFFFF], so every char >= 128
// is in one class, and the offset takes no branch. Otherwise a char >= 128
// takes a binary search of those boundaries.
template <bool kPlain>
__device__ __forceinline__ uint32_t class_offset(uint32_t c, const Tables& t) {
  const uint32_t low = t.ascii[c & 127u];
  int above = 0;  // the count of high boundaries <= c (a code point past 0xFFFF reads as U+FFFD)
  if (!kPlain && c >= 128u) {
    const uint32_t w = c > 0xFFFFu ? 0xFFFDu : c;
    int hi = t.nhigh;
    while (above < hi) {
      const int mid = (above + hi) >> 1;
      if (t.high[mid] <= w) above = mid + 1;
      else hi = mid;
    }
  }
  return c < 128u ? low : static_cast<uint32_t>((t.high_class + above) * t.states);
}

// count chars of c (at most K are taken) walked from entry e; seen gathers
// every entry's bits. The class offsets do not depend on e: only the table
// reads form the chain.
template <int K, bool kPlain>
__device__ __forceinline__ void walk_chunk(const uint32_t (&c)[K], int count, const Tables& t, uint32_t& e,
                                           uint32_t& seen) {
  uint32_t off[K];
#pragma unroll
  for (int k = 0; k < K; ++k) off[k] = class_offset<kPlain>(c[k], t);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < count) {
      e = t.next[off[k] + (e & 0x3Fu)];
      seen |= e;
    }
  }
}

// The chars [base, base + K) of a row, 0 past len. V = 1: one load a char
// at stride_pos. V = 4 or 2 (int32 rows, stride_pos 1, rows and width
// aligned to V chars): one load for V chars, never past the row's width.
template <typename T, int K, int V>
__device__ __forceinline__ void load_chunk(uint32_t (&c)[K], const T* __restrict__ p, long long stride_pos, int base,
                                           int len) {
  if constexpr (V == 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = base + k;
      c[k] = j < len ? static_cast<uint32_t>(__ldg(p + (long long)j * stride_pos)) : 0u;
    }
  } else {
    static_assert(sizeof(T) == 4 && K % V == 0, "vector loads take int32 rows");
#pragma unroll
    for (int k = 0; k < K; k += V) {
      const int j = base + k;
      if constexpr (V == 4) {
        const int4 v = j < len ? __ldg(reinterpret_cast<const int4*>(p + j)) : make_int4(0, 0, 0, 0);
        c[k] = v.x, c[k + 1] = v.y, c[k + 2] = v.z, c[k + 3] = v.w;
      } else {
        const int2 v = j < len ? __ldg(reinterpret_cast<const int2*>(p + j)) : make_int2(0, 0);
        c[k] = v.x, c[k + 1] = v.y;
      }
    }
  }
}

// One row, its chars loaded K at a time.
template <typename T, int K, int V, bool kPlain>
__device__ void walk_row(const Rows& r, int row, const Tables& t, bool prefix, bool start_accepts) {
  int len = r.lens[row];
  if (len > r.width) len = r.width;
  bool matched = false;
  if (len > 0 && prefix && start_accepts) {
    matched = true;
  } else if (len > 0) {
    const T* p = static_cast<const T*>(r.chars) + (long long)row * r.stride_row;
    const uint32_t stop = prefix ? (kAccepts | kDead) : kDead;
    uint32_t cur[K], nxt[K];
    uint32_t e = 0, seen = 0;  // state 0, no bits
    load_chunk<T, K, V>(cur, p, r.stride_pos, 0, len);
    walk_chunk<K, kPlain>(cur, len, t, e, seen);
    if (K < len && !(seen & stop)) {
      load_chunk<T, K, V>(cur, p, r.stride_pos, K, len);
      for (int base = K;; base += K) {
        const bool more = base + K < len;
        if (more) load_chunk<T, K, V>(nxt, p, r.stride_pos, base + K, len);  // in flight during the walk
        walk_chunk<K, kPlain>(cur, len - base, t, e, seen);
        if (!more || (seen & stop)) break;
#pragma unroll
        for (int k = 0; k < K; ++k) cur[k] = nxt[k];
      }
    }
    matched = ((prefix ? seen : e) & kAccepts) != 0;
  }
  r.out[row] = matched ? 1 : 0;
}

template <bool kPlain>
__device__ void walk(const Rows& r, int row, const Tables& t, bool prefix, bool start_accepts) {
  if (r.elem_bytes == 2) walk_row<uint16_t, kShortChunk, 1, kPlain>(r, row, t, prefix, start_accepts);
  else if (r.vec == 4) walk_row<int32_t, kLongChunk, 4, kPlain>(r, row, t, prefix, start_accepts);
  else if (r.vec == 2) walk_row<int32_t, kLongChunk, 2, kPlain>(r, row, t, prefix, start_accepts);
  else walk_row<int32_t, kLongChunk, 1, kPlain>(r, row, t, prefix, start_accepts);
}

__global__ void __launch_bounds__(kThreads)
dfa_walk_kernel(const __grid_constant__ Launch launch, const __grid_constant__ WalkDfa dfa, int prefix) {
  __shared__ uint32_t s_next[kTable / 4];
  __shared__ uint32_t s_ascii[64];
  __shared__ uint32_t s_high[kMaxBounds];
  const auto* next_words = reinterpret_cast<const uint32_t*>(dfa.next);
  const auto* ascii_words = reinterpret_cast<const uint32_t*>(dfa.ascii);
  for (int i = threadIdx.x; i < (dfa.used + 3) / 4; i += blockDim.x) s_next[i] = next_words[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) s_ascii[i] = ascii_words[i];
  for (int i = threadIdx.x; i < dfa.nhigh; i += blockDim.x) s_high[i] = dfa.high[i];
  __syncthreads();
  const int a_blocks = launch.part[0].blocks;
  const bool first = static_cast<int>(blockIdx.x) < a_blocks;
  const Rows r = first ? launch.part[0] : launch.part[1];
  const int row = (first ? blockIdx.x : blockIdx.x - a_blocks) * kThreads + threadIdx.x;
  if (row >= r.n) return;
  const Tables t{reinterpret_cast<const uint8_t*>(s_next), reinterpret_cast<const uint16_t*>(s_ascii), s_high,
                 dfa.nhigh, dfa.high_class, dfa.states};
  const bool pre = prefix != 0, start = dfa.start_accepts != 0;
  if (dfa.nhigh == 0) walk<true>(r, row, t, pre, start);
  else walk<false>(r, row, t, pre, start);
}

// The chars a load of a row reads: 4 or 2 for row-major int32 rows whose
// start, row stride and width are aligned to that many chars, else 1.
int vec_of(const void* chars, int elem_bytes, long long stride_pos, long long stride_row, int width) {
  if (elem_bytes != 4 || stride_pos != 1) return 1;
  const auto addr = reinterpret_cast<uintptr_t>(chars);
  if (addr % 16 == 0 && stride_row % 4 == 0 && width % 4 == 0) return 4;
  if (addr % 8 == 0 && stride_row % 2 == 0 && width % 2 == 0) return 2;
  return 1;
}

Rows rows_of(const void* chars, int elem_bytes, long long stride_pos, long long stride_row, int width,
             const void* lens, int n, uint8_t* out) {
  return Rows{chars, stride_pos, stride_row, static_cast<const int32_t*>(lens), out, n, width, elem_bytes,
              (n + kThreads - 1) / kThreads, vec_of(chars, elem_bytes, stride_pos, stride_row, width)};
}

}  // namespace

// Walks matrix a (n_a rows) and matrix b (n_b rows, 0 for none) in one
// launch: out[0, n_a) for a, out[n_a, n_a + n_b) for b. elem_bytes 2:
// uint16 chars; 4: int32 codes. dfa: a host buffer of WALK_ARG's layout,
// copied into the kernel's argument.
extern "C" int veloci_regex_walk(const void* a_chars, int a_elem_bytes, long long a_stride_pos,
                                 long long a_stride_row, int a_width, const void* a_lens, int n_a,
                                 const void* b_chars, int b_elem_bytes, long long b_stride_pos,
                                 long long b_stride_row, int b_width, const void* b_lens, int n_b,
                                 const void* dfa, int prefix, void* out, void* stream) {
  if (n_a < 0 || n_b < 0) return cudaErrorInvalidValue;
  if (n_a + n_b == 0) return cudaSuccess;
  WalkDfa arg;
  std::memcpy(&arg, dfa, sizeof arg);
  if (arg.states < 1 || arg.states > 64 || arg.nhigh < 0 || arg.nhigh > kMaxBounds - 1 || arg.used < 1 ||
      arg.used > kTable)
    return cudaErrorInvalidValue;
  if ((a_elem_bytes != 2 && a_elem_bytes != 4) || (b_elem_bytes != 2 && b_elem_bytes != 4))
    return cudaErrorInvalidValue;
  auto* o = static_cast<uint8_t*>(out);
  Launch launch{{rows_of(a_chars, a_elem_bytes, a_stride_pos, a_stride_row, a_width, a_lens, n_a, o),
                 rows_of(b_chars, b_elem_bytes, b_stride_pos, b_stride_row, b_width, b_lens, n_b, o + n_a)}};
  const unsigned blocks = static_cast<unsigned>(launch.part[0].blocks + launch.part[1].blocks);
  dfa_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(launch, arg, prefix);
  return cudaGetLastError();
}

extern "C" const char* veloci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
