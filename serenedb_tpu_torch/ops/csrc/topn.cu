// Top-N kernels for Hopper (sm_90a), with a plain C interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; each entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrappers, the descriptor layout and
// the plain PyTorch versions live in ops/topn_kernels.py.
//
// Both entries select by a unique 64-bit key: the high word is the
// order-preserving u32 image of the row's (transformed) sort value, the
// low word ~index. Descending key order is then (value desc, index asc),
// which is `lax.top_k`'s order: the lowest index first on ties. The
// selection is a radix select over the keys, 8 bits a pass from the top:
// each pass histograms the keys that match the prefix chosen so far, and
// a one-thread kernel picks the digit that holds the k-th largest key, so
// no pass waits on the host. After eight passes the prefix is that key
// itself; one pass collects the k keys at or above it (keys are unique,
// so exactly k), and one block sorts them with select.cuh's bitonic sort
// in shared memory (k <= 8192: 64 KB).
//
// 1. topn_scan
//    Replaces serenedb_tpu/exec/device_topn.py `_topn_indices` (the
//    `prog` at :202, K6) and the filtered program of
//    exec/device_pipeline.py `_run_fused_topn` (:2637, K7): per row the
//    frame-of-reference decode of the key and predicate columns, the
//    predicate programs (expr.cuh, shared with agg_scan) ANDed with the
//    row mask, the key transform of device_topn.py:170-181 (desc v, asc
//    ~v for ints, -v for f32; masked rows take the sentinel, int32 min or
//    -inf), then the selection. -0.0 is made +0.0 before the image, so
//    the two tie as the host path's sort ties them. Also counts the rows
//    that survive the mask.
// 2. chain_topn
//    Replaces the stage-2 program of exec/device_pipeline.py
//    `try_device_chained_topn` (:2810, K7): the sort value of each group
//    slot — a resident count column, or the slot's group-key digit
//    (slot / stride) % size — transformed to v or ~v, absent slots (row
//    count 0) set to int32 min; the selection of k_pad slots; then each
//    stage-1 output's k_pad picked rows gathered into a small buffer, so
//    the host reads only those.
// Bound: bytes. topn_scan reads each input tile once and writes one
// 8-byte key per row; the eight histogram passes and the collect pass
// re-read the keys (the time is roughly ten passes over 8 bytes a row).

#include "expr.cuh"
#include "select.cuh"

namespace {

using namespace expr;

// topn_scan's header words (ops/topn_kernels.py)
constexpr int H_ROWS = 10, H_KEYSLOT = 11, H_FLAGS = 12, H_KEYS_OUT = 13,
              H_HIST = 14, H_NSURV = 15;
constexpr int F_DESC = 1, F_FLOAT = 2;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BINS = 256;
constexpr int SORT_THREADS = 1024;
constexpr int MAX_BLOCKS = 132 * 16;
constexpr int MAX_SORT = 8192;

typedef unsigned long long u64;

__device__ __forceinline__ u64 make_key(uint32_t hi, long long index) {
  return (static_cast<u64>(hi) << 32) |
         static_cast<u64>(~static_cast<uint32_t>(index));
}

// Add one to the bin of each active lane's key, one shared-memory atomic
// per distinct bin of the warp. Every lane of the warp calls it.
__device__ __forceinline__ void warp_hist(unsigned* s_hist, bool active,
                                          int bin) {
  const unsigned peers = __match_any_sync(FULL, active ? bin : -1);
  const int lane = threadIdx.x & 31;
  if (active && lane == __ffs(peers) - 1)
    atomicAdd(&s_hist[bin], static_cast<unsigned>(__popc(peers)));
}

__device__ __forceinline__ void flush_hist(const unsigned* s_hist,
                                           unsigned* hist) {
  __syncthreads();
  for (int b = threadIdx.x; b < BINS; b += blockDim.x)
    if (s_hist[b]) atomicAdd(&hist[b], s_hist[b]);
}

__global__ void __launch_bounds__(THREADS)
    topn_keys_kernel(const long long* __restrict__ gdesc) {
  __shared__ long long d[DESC_WORDS];
  __shared__ unsigned s_hist[BINS];
  __shared__ unsigned long long s_surv;
  for (int i = threadIdx.x; i < DESC_WORDS; i += THREADS) d[i] = gdesc[i];
  for (int b = threadIdx.x; b < BINS; b += THREADS) s_hist[b] = 0;
  if (threadIdx.x == 0) s_surv = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = d[H_ROWS];
  const int slot = static_cast<int>(d[H_KEYSLOT]);
  const int flags = static_cast<int>(d[H_FLAGS]);
  const bool desc = flags & F_DESC, is_float = flags & F_FLOAT;
  u64* keys = ptr<u64>(d[H_KEYS_OUT]);
  // the sentinel's image: int32 min, or -inf
  const uint32_t sent = is_float ? image(0xFF800000u) : 0u;
  unsigned surv = 0;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = (static_cast<long long>(blockIdx.x) * WARPS + warp) *
                        32;
       base < n; base += step) {
    const long long row = base + lane;
    const bool in = row < n;
    const bool m = row_mask(d, row, in);
    uint32_t hi = sent;
    if (m) {
      bool ok;
      const uint32_t v = load_col(d, slot, row, ok);
      if (is_float) {
        uint32_t kv = desc ? v : (v ^ 0x80000000u);  // -v flips the sign
        if (kv == 0x80000000u) kv = 0u;              // -0.0 ties +0.0
        hi = image(kv);
      } else {
        const int32_t iv = static_cast<int32_t>(v);
        hi = static_cast<uint32_t>(desc ? iv : ~iv) ^ 0x80000000u;
      }
      ++surv;
    }
    if (in) keys[row] = make_key(hi, row);
    warp_hist(s_hist, in, static_cast<int>(hi >> 24));
  }
  for (int o = 16; o > 0; o >>= 1) surv += __shfl_down_sync(FULL, surv, o);
  if (lane == 0 && surv) atomicAdd(&s_surv, static_cast<u64>(surv));
  flush_hist(s_hist, ptr<unsigned>(d[H_HIST]));
  if (threadIdx.x == 0 && s_surv)
    atomicAdd(ptr<u64>(d[H_NSURV]), s_surv);
}

__global__ void __launch_bounds__(THREADS)
    chain_keys_kernel(const long long* __restrict__ rowcount,
                      const long long* __restrict__ src, long long G,
                      long long stride, long long size, int desc,
                      u64* __restrict__ keys, unsigned* __restrict__ hist,
                      u64* __restrict__ npres) {
  __shared__ unsigned s_hist[BINS];
  __shared__ unsigned long long s_pres;
  for (int b = threadIdx.x; b < BINS; b += THREADS) s_hist[b] = 0;
  if (threadIdx.x == 0) s_pres = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned pres = 0;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = (static_cast<long long>(blockIdx.x) * WARPS + warp) *
                        32;
       base < G; base += step) {
    const long long s = base + lane;
    const bool in = s < G;
    uint32_t hi = 0u;  // image of int32 min: an absent slot
    if (in && rowcount[s] > 0) {
      const int32_t v = src != nullptr
                            ? static_cast<int32_t>(src[s])
                            : static_cast<int32_t>((s / stride) % size);
      hi = static_cast<uint32_t>(desc ? v : ~v) ^ 0x80000000u;
      ++pres;
    }
    if (in) keys[s] = make_key(hi, s);
    warp_hist(s_hist, in, static_cast<int>(hi >> 24));
  }
  for (int o = 16; o > 0; o >>= 1) pres += __shfl_down_sync(FULL, pres, o);
  if (lane == 0 && pres) atomicAdd(&s_pres, static_cast<u64>(pres));
  flush_hist(s_hist, hist);
  if (threadIdx.x == 0 && s_pres) atomicAdd(npres, s_pres);
}

// state: [prefix, k still to take, collected count]
__global__ void select_init_kernel(u64* state, long long k) {
  state[0] = 0;
  state[1] = static_cast<u64>(k);
  state[2] = 0;
}

// Histogram of the keys whose bits above `shift + 8` equal the prefix's.
__global__ void __launch_bounds__(THREADS)
    select_hist_kernel(const u64* __restrict__ keys, long long n,
                       const u64* __restrict__ state, int shift,
                       unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[BINS];
  for (int b = threadIdx.x; b < BINS; b += THREADS) s_hist[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const u64 prefix = state[0];
  const int above = shift + 8;  // <= 56
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = (static_cast<long long>(blockIdx.x) * WARPS + warp) *
                        32;
       base < n; base += step) {
    const long long i = base + lane;
    const bool in = i < n;
    const u64 key = in ? keys[i] : 0ull;
    const bool match = in && ((key ^ prefix) >> above) == 0;
    warp_hist(s_hist, match, static_cast<int>((key >> shift) & 0xFF));
  }
  flush_hist(s_hist, hist);
}

// Pick the digit at `shift` that holds the k-th largest key; clear the
// histogram for the next pass.
__global__ void select_digit_kernel(unsigned* hist, u64* state, int shift) {
  const u64 k_rem = state[1];
  u64 cum = 0;
  for (int b = BINS - 1; b >= 0; --b) {
    const u64 c = hist[b];
    if (cum + c >= k_rem) {
      state[0] |= static_cast<u64>(b) << shift;
      state[1] = k_rem - cum;
      break;
    }
    cum += c;
  }
  for (int b = 0; b < BINS; ++b) hist[b] = 0;
}

// The keys at or above the k-th largest (state[0]), in no order.
__global__ void __launch_bounds__(THREADS)
    select_collect_kernel(const u64* __restrict__ keys, long long n,
                          u64* __restrict__ state, u64* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const u64 t = state[0];
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = (static_cast<long long>(blockIdx.x) * WARPS + warp) *
                        32;
       base < n; base += step) {
    const long long i = base + lane;
    const bool take = i < n && keys[i] >= t;
    const unsigned bal = __ballot_sync(FULL, take);
    if (!bal) continue;
    u64 at = 0;
    if (lane == __ffs(bal) - 1) at = atomicAdd(&state[2], static_cast<u64>(__popc(bal)));
    at = __shfl_sync(FULL, at, __ffs(bal) - 1);
    if (take) out[at + __popc(bal & ((1u << lane) - 1u))] = keys[i];
  }
}

// Sort the k collected keys descending (select.cuh's bitonic sort of their
// complements, in shared memory) and write each one's index (the low word
// of the complement).
__global__ void __launch_bounds__(SORT_THREADS)
    select_sort_kernel(const u64* __restrict__ cand, long long k, int npow2,
                       long long* __restrict__ out_idx) {
  extern __shared__ u64 s_keys[];
  for (int i = threadIdx.x; i < npow2; i += SORT_THREADS)
    s_keys[i] = i < k ? ~cand[i] : sel::NO_KEY;
  __syncthreads();
  sel::block_sort(s_keys, npow2);
  for (int i = threadIdx.x; i < k; i += SORT_THREADS)
    out_idx[i] = static_cast<long long>(
        static_cast<uint32_t>(s_keys[i] & 0xFFFFFFFFull));
}

__global__ void gather_rows_kernel(const uint32_t* __restrict__ src,
                                   long long row_words,
                                   const long long* __restrict__ idx,
                                   long long k, uint32_t* __restrict__ dst) {
  const long long total = k * row_words;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long j = e / row_words, w = e - j * row_words;
    dst[e] = src[idx[j] * row_words + w];
  }
}

unsigned blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

// Passes 2-8 of the radix select (the key kernel made pass 1's
// histogram), the collect and the sort.
int finish_select(u64* keys, long long n, long long k, u64* state,
                  unsigned* hist, u64* sel, long long* out_idx,
                  cudaStream_t s) {
  select_digit_kernel<<<1, 1, 0, s>>>(hist, state, 56);
  for (int shift = 48; shift >= 0; shift -= 8) {
    select_hist_kernel<<<blocks_for(n), THREADS, 0, s>>>(keys, n, state,
                                                          shift, hist);
    select_digit_kernel<<<1, 1, 0, s>>>(hist, state, shift);
  }
  select_collect_kernel<<<blocks_for(n), THREADS, 0, s>>>(keys, n, state,
                                                           sel);
  int npow2 = 1;
  while (npow2 < k) npow2 <<= 1;
  const int smem = npow2 * static_cast<int>(sizeof(u64));
  cudaFuncSetAttribute(select_sort_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       MAX_SORT * static_cast<int>(sizeof(u64)));
  select_sort_kernel<<<1, SORT_THREADS, smem, s>>>(sel, k, npow2, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// topn_scan: the descriptor (DESC_WORDS int64 words, already on the
// device) names the columns, predicates, key slot, flags and the keys /
// histogram / survivor-count buffers; `n` rows, k <= min(n, 8192).
// Writes the k selected row indices, best first, to out_idx.
int topn_scan(const void* desc, long long n, long long k, void* keys,
              void* state, void* hist, void* sel, void* out_idx,
              void* stream) {
  if (k < 1 || k > MAX_SORT || k > n) return static_cast<int>(
      cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  select_init_kernel<<<1, 1, 0, s>>>(static_cast<u64*>(state), k);
  topn_keys_kernel<<<blocks_for(n), THREADS, 0, s>>>(
      static_cast<const long long*>(desc));
  return finish_select(static_cast<u64*>(keys), n, k,
                       static_cast<u64*>(state), static_cast<unsigned*>(hist),
                       static_cast<u64*>(sel),
                       static_cast<long long*>(out_idx), s);
}

// chain_topn: select k of the G group slots (sort value from `src`, an
// int64 count column, or from the slot's key digit when src is null),
// then gather the picked rows of n_out stage-1 outputs: output j is
// src_ptrs[j] with row_words[j] 4-byte words a slot, written to
// dst_ptrs[j] (k rows). The three arrays live on the host.
int chain_topn(const void* rowcount, const void* src, long long G,
               long long stride, long long size, int desc, long long k,
               void* keys, void* state, void* hist, void* npres, void* sel,
               void* out_idx, int n_out, const long long* src_ptrs,
               const long long* row_words, const long long* dst_ptrs,
               void* stream) {
  if (k < 1 || k > MAX_SORT || k > G) return static_cast<int>(
      cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  select_init_kernel<<<1, 1, 0, s>>>(static_cast<u64*>(state), k);
  chain_keys_kernel<<<blocks_for(G), THREADS, 0, s>>>(
      static_cast<const long long*>(rowcount),
      static_cast<const long long*>(src), G, stride, size, desc,
      static_cast<u64*>(keys), static_cast<unsigned*>(hist),
      static_cast<u64*>(npres));
  int err = finish_select(static_cast<u64*>(keys), G, k,
                          static_cast<u64*>(state),
                          static_cast<unsigned*>(hist),
                          static_cast<u64*>(sel),
                          static_cast<long long*>(out_idx), s);
  if (err != 0) return err;
  for (int j = 0; j < n_out; ++j) {
    const long long total = k * row_words[j];
    long long blocks = (total + 255) / 256;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    if (blocks < 1) blocks = 1;
    gather_rows_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(src_ptrs[j])),
        row_words[j], static_cast<const long long*>(out_idx), k,
        reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(dst_ptrs[j])));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
