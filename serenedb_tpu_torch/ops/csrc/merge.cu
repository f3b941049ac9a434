// Cross-shard top-k merge for Hopper (sm_90a), with a plain C interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; the entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrapper and the plain PyTorch
// version live in ops/merge_kernels.py.
//
// merge_topk replaces serenedb_tpu/search/searcher.py `_merge_program`:
// for each (shard, query) an exact top-k of the shard's candidates by
// (score desc, doc asc) with -0.0 tied to +0.0 and the raw score bits as
// a passenger, an all_gather of the per-shard top-k, then a final top-k
// per query. Global doc ids are unique within a query, so the per-shard
// top-k followed by the final one picks the same entries in the same
// order as one exact top-k over the union of the shards' candidates;
// this kernel does that one selection for the whole query batch.
//
// Input: scores (S, Q, L) f32 and docs (S, Q, L) int32, pads at
// (-inf, 0x7FFFFFFF). Each lane becomes one 64-bit key: the high word is
// the complemented order-preserving image of (score + 0.0), the low word
// the doc. Ascending keys are (score desc, doc asc); a pad sorts after
// every real candidate, a real -inf included, since real docs are below
// 0x7FFFFFFF. Equal keys (pads) keep their lanes' order: a lane is the
// last tie-break, as the plain version's stable sorts have it.
//
// Bound: bytes — each lane's score and doc read once (8 bytes) and each
// output written once (8 bytes).
//
// Design (in place of a key array in device memory, select.cuh's levels,
// a docs pass and a binary search a lane for the raw scores: four or more
// launches). While a query's S * L lanes fit one block
// (MERGE_ONE_MAX pairs, 96 KB of shared memory), one launch does it all:
// a block a query reads its lanes coalesced (shard by shard, L each),
// forms each key with the lane as its passenger, sorts (key, lane) pairs
// (a bitonic network in registers by shuffles up to 32 lanes, in shared
// memory past that) and writes the kk outputs: the doc from the key, the
// raw score bits through the lane (a -0.0 stays -0.0; every slot is
// written, pads as (-inf, PAD_DOC)). Past MERGE_ONE_MAX the key array and
// the levels stay.

#include "select.cuh"

#define MERGE_SORT_FLOOR 32  // smallest tile of the selection levels
#define PAD_DOC 0x7FFFFFFF

__device__ inline unsigned long long merge_key(float s, int d) {
  unsigned u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;                     // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // order-preserving
  return ((unsigned long long)(~u) << 32) | (unsigned)d;
}

// keys (Q, S * L): query q's row holds shard s's lanes at s * L + l.
__global__ void merge_keys_kernel(const float* __restrict__ scores,
                                  const int* __restrict__ docs, long long S,
                                  long long Q, long long L,
                                  unsigned long long* __restrict__ keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * Q * L) return;
  const long long s = i / (Q * L), r = i - s * Q * L;
  const long long q = r / L, l = r - q * L;
  keys[q * S * L + s * L + l] = merge_key(scores[i], docs[i]);
}

// Each selected key's doc, and its canonical score (the raw score of all
// but the first of equal keys: equal keys are pads, all -inf).
__global__ void merge_docs_kernel(const unsigned long long* __restrict__ sel,
                                  long long n, float* __restrict__ out_vals,
                                  int* __restrict__ out_docs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = sel[i];
  const unsigned u = ~(unsigned)(key >> 32);
  out_vals[i] = __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
  out_docs[i] = (int)(unsigned)(key & 0xFFFFFFFFull);
}

// Each lane finds its key among its query's kk selected keys (ascending)
// and, when it was selected, writes its raw score into the first slot of
// that key.
__global__ void merge_scores_kernel(const float* __restrict__ scores,
                                    const int* __restrict__ docs, long long S,
                                    long long Q, long long L,
                                    const unsigned long long* __restrict__ sel,
                                    int kk, float* __restrict__ out_vals) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * Q * L) return;
  const long long q = (i % (Q * L)) / L;
  const float s = scores[i];
  const unsigned long long key = merge_key(s, docs[i]);
  const unsigned long long* row = sel + q * kk;
  if (key > row[kk - 1]) return;  // past the last selected key
  int lo = 0, hi = kk - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (row[lo] == key) out_vals[q * kk + lo] = s;
}

#define MERGE_ONE_MAX 8192  // lanes a query one block sorts

// (key, lane) pairs in the order of the merge: key asc, then lane asc.
__device__ __forceinline__ bool pair_less(unsigned long long ka, int la,
                                          unsigned long long kb, int lb) {
  return ka < kb || (ka == kb && la < lb);
}

// Query q's lane i (shard i / L, slot i % L) in the (S, Q, L) input.
__device__ __forceinline__ long long lane_src(int i, int q, int Q, int L) {
  return ((long long)(i / L) * Q + q) * L + i % L;
}

// One query, S * L <= 32: a warp, one lane a thread, sorted by shuffles.
__global__ void __launch_bounds__(32)
    merge_warp_kernel(const float* __restrict__ scores,
                      const int* __restrict__ docs, int Q, int L, int n,
                      int kk, float* __restrict__ vals,
                      int* __restrict__ out_docs) {
  const int q = blockIdx.x, t = threadIdx.x;
  unsigned long long key = ~0ull;
  int lane = t;
  if (t < n) {
    const long long src = lane_src(t, q, Q, L);
    key = merge_key(scores[src], docs[src]);
  }
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long ok = __shfl_xor_sync(0xFFFFFFFFu, key, j);
      const int ol = __shfl_xor_sync(0xFFFFFFFFu, lane, j);
      const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
      if (pair_less(ok, ol, key, lane) == keep_min) {
        key = ok;
        lane = ol;
      }
    }
  if (t < kk) {
    vals[(long long)q * kk + t] = scores[lane_src(lane, q, Q, L)];
    out_docs[(long long)q * kk + t] = (int)(unsigned)(key & 0xFFFFFFFFull);
  }
}

// One query, 32 < S * L <= MERGE_ONE_MAX: a block, the pairs sorted in
// shared memory (P = the next power of two of n, pads past n).
__global__ void __launch_bounds__(1024)
    merge_block_kernel(const float* __restrict__ scores,
                       const int* __restrict__ docs, int Q, int L, int n,
                       int P, int kk, float* __restrict__ vals,
                       int* __restrict__ out_docs) {
  extern __shared__ unsigned long long mk[];
  int* ml = reinterpret_cast<int*>(mk + P);
  const int q = blockIdx.x;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    unsigned long long key = ~0ull;
    if (i < n) {
      const long long src = lane_src(i, q, Q, L);
      key = merge_key(scores[src], docs[src]);
    }
    mk[i] = key;
    ml[i] = i;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = mk[i], b = mk[j];
          const int la = ml[i], lb = ml[j];
          if (pair_less(b, lb, a, la) == ((i & size) == 0)) {
            mk[i] = b;
            mk[j] = a;
            ml[i] = lb;
            ml[j] = la;
          }
        }
      }
      __syncthreads();
    }
  for (int i = threadIdx.x; i < kk; i += blockDim.x) {
    vals[(long long)q * kk + i] = scores[lane_src(ml[i], q, Q, L)];
    out_docs[(long long)q * kk + i] = (int)(unsigned)(mk[i] & 0xFFFFFFFFull);
  }
}

static inline unsigned grid_for(long long threads, int block) {
  return (unsigned)((threads + block - 1) / block);
}

extern "C" {

// scores (S, Q, L) f32, docs (S, Q, L) int32; outputs vals (Q, kk) f32
// and out_docs (Q, kk) int32, each row by (score desc, doc asc). 0 < kk
// <= S * L. Up to MERGE_ONE_MAX lanes a query one launch, no scratch (keys
// and buf_b unused); past it the selection buffers keys (cap_a keys, >= Q
// * S * L) and buf_b (cap_b keys) sized by ops/select.py.
int merge_topk(const void* scores, const void* docs, long long S, long long Q,
               long long L, int kk, void* keys, long long cap_a, void* buf_b,
               long long cap_b, void* vals, void* out_docs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = S * L;
  if (S <= 0 || Q <= 0 || L <= 0 || kk <= 0 || kk > n || Q > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (n <= 32) {
    merge_warp_kernel<<<(unsigned)Q, 32, 0, st>>>(
        (const float*)scores, (const int*)docs, (int)Q, (int)L, (int)n, kk,
        (float*)vals, (int*)out_docs);
    return (int)cudaGetLastError();
  }
  if (n <= MERGE_ONE_MAX) {
    static bool attr = false;
    if (!attr) {
      cudaFuncSetAttribute(merge_block_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MERGE_ONE_MAX * 12);
      attr = true;
    }
    int P = 64;
    while (P < n) P <<= 1;
    const int threads = P < 1024 ? P : 1024;
    merge_block_kernel<<<(unsigned)Q, threads, (size_t)P * 12, st>>>(
        (const float*)scores, (const int*)docs, (int)Q, (int)L, (int)n, P,
        kk, (float*)vals, (int*)out_docs);
    return (int)cudaGetLastError();
  }
  if (Q * n > cap_a) return (int)cudaErrorInvalidValue;
  merge_keys_kernel<<<grid_for(Q * n, 256), 256, 0, st>>>(
      (const float*)scores, (const int*)docs, S, Q, L,
      (unsigned long long*)keys);
  const unsigned long long* sorted = sel::levels(
      (unsigned long long*)keys, cap_a, (unsigned long long*)buf_b, cap_b, Q,
      n, 1, kk, MERGE_SORT_FLOOR, st);
  if (!sorted) return (int)cudaErrorInvalidValue;
  merge_docs_kernel<<<grid_for(Q * kk, 256), 256, 0, st>>>(
      sorted, Q * kk, (float*)vals, (int*)out_docs);
  merge_scores_kernel<<<grid_for(Q * n, 256), 256, 0, st>>>(
      (const float*)scores, (const int*)docs, S, Q, L, sorted, kk,
      (float*)vals);
  return (int)cudaGetLastError();
}

}  // extern "C"
