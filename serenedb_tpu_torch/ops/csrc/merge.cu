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
// 0x7FFFFFFF. The levels of select.cuh keep each query's kk smallest keys
// (kk <= S * L). The doc and the canonical score come back from the key;
// then the raw score comes back from the lane that holds the selected
// key: each lane looks its key up in its query's kk sorted keys and, when
// it is there, writes its own score bits into the key's first slot (so a
// -0.0 stays -0.0). Only pads share a key, and their lanes all write the
// same -inf: a store of one value, no atomics.
//
// Bound: bytes — each lane's score and doc read once (8 bytes) and each
// output written once (8 bytes); the selection re-reads the keys.

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

static inline unsigned grid_for(long long threads, int block) {
  return (unsigned)((threads + block - 1) / block);
}

extern "C" {

// scores (S, Q, L) f32, docs (S, Q, L) int32; the selection buffers keys
// (cap_a keys, >= Q * S * L) and buf_b (cap_b keys) sized by
// ops/select.py; outputs vals (Q, kk) f32 and out_docs (Q, kk) int32,
// each row by (score desc, doc asc). 0 < kk <= S * L.
int merge_topk(const void* scores, const void* docs, long long S, long long Q,
               long long L, int kk, void* keys, long long cap_a, void* buf_b,
               long long cap_b, void* vals, void* out_docs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = S * L;
  if (S <= 0 || Q <= 0 || L <= 0 || kk <= 0 || kk > n || Q * n > cap_a)
    return (int)cudaErrorInvalidValue;
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
