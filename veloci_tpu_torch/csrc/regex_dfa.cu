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
// Design. The walk is a serial, data-dependent gather, so it is one thread
// a row and a table walk, not matmuls. The DFA travels as a kernel argument
// (__grid_constant__, no copy from the host) and each block stages it in
// shared memory once: boundaries as u32, transitions as u8 [C][S] (at most
// 1,920 bytes), the accept set as a 64-bit mask in a register. A step is a
// binary search of the boundaries (at most 5 compares) and one table read.
// The matrix is addressed by two strides: a field's transposed u16 sweep
// matrix (stride_pos = N, stride_row = 1: a warp's 32 rows read one
// coalesced 64-byte line a position) and the long rows' row-major int32
// codes (stride_pos = 1, stride_row = W: each lane walks its own row,
// 32 chars a 128-byte line). A row stops at its length, at the dead state,
// or, in prefix mode, at its first accept. Sweep rows are sorted by length,
// so a warp's rows end together.
//
// Bound. Bytes: 4 a row for its length, 2 a char walked of a u16 row or 4
// of an int32 row, 1 a row written. Operations: ceil(log2 C) + 2 integer
// operations a char step. The bytes bound is the larger one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;
constexpr int kMaxBounds = 32;  // MAX_CLASSES - 1 = 29 used
constexpr int kMaxTable = 30 * 64;  // MAX_CLASSES x MAX_STATES

struct Dfa {
  uint32_t bounds[kMaxBounds];
  uint8_t trans[kMaxTable];  // [class][state], row-major
  unsigned long long accept;  // bit s: state s accepts
  int nb;                     // boundaries in use; classes = nb + 1
  int states;
  int dead;  // the absorbing reject state, or -1
  int prefix;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
regex_walk_kernel(const T* __restrict__ chars, long long stride_pos, long long stride_row, int width,
                  const int32_t* __restrict__ lens, int n, const __grid_constant__ Dfa dfa,
                  uint8_t* __restrict__ out) {
  __shared__ uint32_t sb[kMaxBounds];
  __shared__ uint8_t st[kMaxTable];
  const int nb = dfa.nb;
  const int states = dfa.states;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = dfa.bounds[i];
  for (int i = threadIdx.x; i < (nb + 1) * states; i += blockDim.x) st[i] = dfa.trans[i];
  __syncthreads();
  const unsigned long long accept = dfa.accept;
  const int dead = dfa.dead;
  const bool prefix = dfa.prefix != 0;
  const bool start_accepts = accept & 1ull;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += (long long)gridDim.x * blockDim.x) {
    int len = lens[row];
    if (len > width) len = width;
    bool matched = false;
    if (len > 0) {
      if (prefix && start_accepts) {
        matched = true;
      } else {
        const T* p = chars + row * stride_row;
        int state = 0;
        for (int j = 0; j < len; ++j) {
          uint32_t c = static_cast<uint32_t>(p[(long long)j * stride_pos]);
          if (c > 0xFFFFu) c = 0xFFFDu;
          int lo = 0, hi = nb;  // the count of boundaries <= c
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (sb[mid] <= c) lo = mid + 1;
            else hi = mid;
          }
          state = st[lo * states + state];
          if (prefix && ((accept >> state) & 1ull)) {
            matched = true;
            break;
          }
          if (state == dead) break;
        }
        if (!prefix) matched = (accept >> state) & 1ull;
      }
    }
    out[row] = matched ? 1 : 0;
  }
}

template <typename T>
cudaError_t launch(const void* chars, long long stride_pos, long long stride_row, int width,
                   const int32_t* lens, int n, const Dfa& dfa, uint8_t* out, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long need = ((long long)n + kThreads - 1) / kThreads;
  const long long blocks = need < (long long)sms * kBlocksPerSm ? need : (long long)sms * kBlocksPerSm;
  regex_walk_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(chars), stride_pos, stride_row, width, lens, n, dfa, out);
  return cudaGetLastError();
}

}  // namespace

// elem_bytes 2: uint16 chars; 4: int32 codes. bounds [nb] u32 and trans
// [(nb + 1) * states] u8 are host arrays, copied into the kernel's argument.
extern "C" int veloci_regex_match(const void* chars, int elem_bytes, long long stride_pos,
                                  long long stride_row, int width, const void* lens, int n,
                                  const void* bounds, int nb, const void* trans, int states,
                                  unsigned long long accept, int dead, int prefix, void* out,
                                  void* stream) {
  if (n <= 0) return cudaSuccess;
  if (nb < 0 || nb >= kMaxBounds || states < 1 || states > 64 || (nb + 1) * states > kMaxTable ||
      (elem_bytes != 2 && elem_bytes != 4))
    return cudaErrorInvalidValue;
  Dfa dfa{};
  const auto* b = static_cast<const uint32_t*>(bounds);
  const auto* t = static_cast<const uint8_t*>(trans);
  for (int i = 0; i < nb; ++i) dfa.bounds[i] = b[i];
  for (int i = 0; i < (nb + 1) * states; ++i) dfa.trans[i] = t[i];
  dfa.accept = accept;
  dfa.nb = nb;
  dfa.states = states;
  dfa.dead = dead;
  dfa.prefix = prefix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const int32_t*>(lens);
  auto* o = static_cast<uint8_t*>(out);
  if (elem_bytes == 2) return launch<uint16_t>(chars, stride_pos, stride_row, width, l, n, dfa, o, s);
  return launch<int32_t>(chars, stride_pos, stride_row, width, l, n, dfa, o, s);
}

extern "C" const char* veloci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
