// Exact selection of each row's K smallest 64-bit keys, for Hopper
// (sm_90a). Shared by vector.cu (ivf_probe, maxsim), bm25.cu (topk_rows)
// and topn.cu (its final sort).
//
// A caller packs each candidate into one key whose ascending order is the
// order it wants (a descending order is taken as the complement of its
// keys) and pads rows with NO_KEY, which sorts after every real key. Keys
// need not be unique: equal keys are equal bits, so the output is the same
// whichever of them is taken.
//
// Levels, each one launch, none with atomics:
// - flat (2K <= T): each tile of T keys of a row is sorted in shared memory
//   (bitonic) and its K smallest are kept; repeated until one run of K is
//   left. A fused caller makes the first level itself: it computes a tile
//   of keys into shared memory and calls `keep_smallest`.
// - large K (2K > T, T = TMAX): tiles of T keys are sorted whole, then runs
//   are merged two at a time in device memory (merge path: a key's place in
//   the merged run is its index in its own run plus its rank in the other),
//   each merged run cut to K, until one run of K is left. Shared memory does
//   not grow with K.
// `levels` runs them and refuses a level that would not fit its buffer;
// `level_caps` sizes the two buffers the levels alternate between, by the
// same step. ops/select.py `level_sizes` mirrors it for the Python
// wrappers that allocate the buffers, and a card test holds the two
// against each other through vector.cu's `select_cap`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Everything here has internal linkage (an unnamed namespace), so each
// library that includes the header keeps its own kernels and its own
// once-a-process flag: a static local of an inline function with external
// linkage would be one symbol across every library the process loads.
namespace sel {
namespace {

typedef unsigned long long u64;

constexpr int THREADS = 1024;
constexpr int TMAX = 8192;  // keys one block sorts: 64 KB of shared memory
constexpr u64 NO_KEY = ~0ull;

// Bitonic sort of n (a power of two) keys ascending, in shared memory; the
// whole block takes part, and the keys must be visible (after a barrier).
__device__ inline void block_sort(u64* s, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const u64 a = s[i], b = s[j];
          if ((a > b) == ((i & size) == 0)) {
            s[i] = b;
            s[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Sort this block's T keys (written to shared memory, no barrier yet) and
// write the K smallest (K <= T) to out.
__device__ inline void keep_smallest(u64* keys, int T, int K,
                                     u64* __restrict__ out) {
  __syncthreads();
  block_sort(keys, T);
  for (int i = threadIdx.x; i < K; i += blockDim.x) out[i] = keys[i];
}

// One flat level: tile `tile` of row `row` of the rows' n_in keys.
__global__ void __launch_bounds__(THREADS)
    tile_kernel(const u64* __restrict__ in, long long n_in, int T, int K,
                long long ntiles, u64* __restrict__ out) {
  extern __shared__ u64 smem[];
  const long long row = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const long long j = tile * T + i;
    smem[i] = j < n_in ? in[row * n_in + j] : NO_KEY;
  }
  keep_smallest(smem, T, K, out + (row * ntiles + tile) * K);
}

// Index of the first key of the sorted run r (n keys) that is >= v
// (upper: > v).
__device__ inline long long rank_in(const u64* r, long long n, u64 v,
                                    bool upper) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (upper ? r[mid] <= v : r[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One merge level: each row's nr sorted runs of R keys become ceil(nr / 2)
// runs of R2 = min(2R, K); a last run with no partner merges with a run of
// NO_KEY. One thread a key; keys of the first run go before equal keys of
// the second.
__global__ void merge_kernel(const u64* __restrict__ in, long long rows,
                             long long nr, long long R, long long R2,
                             u64* __restrict__ out) {
  const long long np = (nr + 1) / 2;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= rows * np * 2 * R) return;
  const long long row = e / (np * 2 * R);
  const long long rest = e - row * np * 2 * R;
  const long long p = rest / (2 * R), i = rest - p * 2 * R;
  const u64* a = in + (row * nr + 2 * p) * R;
  const u64* b = 2 * p + 1 < nr ? a + R : nullptr;
  u64 v;
  long long pos;
  if (i < R) {
    v = a[i];
    pos = i + (b ? rank_in(b, R, v, false) : 0);
  } else {
    v = b ? b[i - R] : NO_KEY;
    pos = (i - R) + (b ? rank_in(a, R, v, true) : R);
  }
  if (pos < R2) out[(row * np + p) * R2 + pos] = v;
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The tile of a level that keeps K: a power of two >= 2K from `floor`, at
// most TMAX.
inline int tile_for(long long K, int floor) {
  long long t = floor;
  while (t < 2 * K && t < TMAX) t <<= 1;
  return static_cast<int>(t);
}

// One level's step: a row of n keys in sorted runs of `run` becomes
// n_out keys in runs of run_out; flat (tiles of T, each cut to keep =
// min(K, T)) or a pair merge. Called while n != K || run < K.
inline bool next_level(long long n, long long run, long long K, int T,
                       long long& n_out, long long& run_out) {
  const long long keep = K < T ? K : T;
  const bool flat = 2 * K <= T || run < keep;
  if (flat) {
    n_out = ceil_div(n, T) * keep;
    run_out = keep;
  } else {
    run_out = 2 * run < K ? 2 * run : K;
    n_out = ceil_div(n / run, 2) * run_out;
  }
  return flat;
}

// The keys the two buffers of `levels` must hold for `rows` rows of n
// keys: the first holds the input and every even level, the second every
// odd level (at least one key a row). ops/select.py `scratch` follows
// the same loop; vector.cu's `select_cap` returns these for its tests.
inline void level_caps(long long rows, long long n, long long run,
                       long long K, int floor, long long& cap_a,
                       long long& cap_b) {
  const int T = tile_for(K, floor);
  long long most[2] = {n, 1};
  int cur = 0;
  while (n != K || run < K) {
    next_level(n, run, K, T, n, run);
    cur = 1 - cur;
    most[cur] = n > most[cur] ? n : most[cur];
  }
  cap_a = rows * most[0];
  cap_b = rows * most[1];
}

// Opt the kernels into the shared memory they use; once a process.
inline void allow_smem() {
  static bool done = false;
  if (done) return;
  cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TMAX * static_cast<int>(sizeof(u64)));
  done = true;
}

// Take each of `rows` rows of n keys in `a` (row stride n), held as sorted
// runs of `run` keys (1: unsorted), down to its K smallest, ascending. The
// levels alternate between a (cap_a keys) and b (cap_b keys). Returns the
// buffer holding the (rows, K) result, or nullptr when a level would not
// fit its buffer (nothing past that level is launched).
inline u64* levels(u64* a, long long cap_a, u64* b, long long cap_b,
                   long long rows, long long n, long long run, long long K,
                   int floor, cudaStream_t s) {
  allow_smem();
  u64* buf[2] = {a, b};
  const long long cap[2] = {cap_a, cap_b};
  int cur = 0;
  const int T = tile_for(K, floor);
  const long long keep = K < T ? K : T;
  while (n != K || run < K) {
    long long n_out, run_out;
    const bool flat = next_level(n, run, K, T, n_out, run_out);
    if (rows * n_out > cap[1 - cur]) return nullptr;
    if (flat) {
      const long long nt = ceil_div(n, T);
      const int threads = T < THREADS ? T : THREADS;
      tile_kernel<<<static_cast<unsigned>(rows * nt), threads,
                    T * sizeof(u64), s>>>(buf[cur], n, T,
                                          static_cast<int>(keep), nt,
                                          buf[1 - cur]);
    } else {
      const long long total = rows * ceil_div(n / run, 2) * 2 * run;
      merge_kernel<<<static_cast<unsigned>(ceil_div(total, 256)), 256, 0,
                     s>>>(buf[cur], rows, n / run, run, run_out,
                          buf[1 - cur]);
    }
    n = n_out;
    run = run_out;
    cur = 1 - cur;
  }
  return buf[cur];
}

}  // namespace
}  // namespace sel
