// Posting-pool scoring for Hopper (sm_90a), with a plain C interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; the entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrapper and the plain PyTorch
// version live in ops/pool_kernels.py.
//
// pool_score replaces serenedb_tpu/search/posting_pool.py `_pool_program`
// (full mode: gather -> contrib -> accumulate -> top-k) and
// `_pool_partial_program` (partial mode: the raw accumulator). For each
// query q of a batch, its kept postings sit in the paged region
// (docs_pg, tfs_pg: pages x 1024 int32) at the slots `si[q, e]`, in the
// slice order of the host ragged path (searcher `_ragged_resolve`), slice
// t covering entries soff[q, t] .. soff[q, t+1]; `lane[q, e]` is the
// candidate lane the entry adds into (the forward scatter index of
// `_ragged_candidates`), `w[q, e]` its term weight.
//
// Accumulation: one launch per slice index t over every query's entries
// of slice t, each thread adding contrib(tf, norms[doc]) into
// acc[q, lane]. A term touches a doc once, so within a launch no two
// threads write one lane; launches run in stream order, so every lane
// sums its terms in slice order from +0.0 — the host path's
// `acc[ix] += c` sequence, bit for bit, with no float atomics. The
// reference gathers through an inverse map (qp x tp x cp int32, 268 MB at
// 64 two-term queries on a 1M-doc corpus); the forward map needs one int
// per kept posting.
//
// Full mode then builds one 64-bit key a lane — the complemented order-
// preserving image of the score high, the doc low; dead lanes (lane >=
// nc[q]) score -inf with the doc 0x7FFFFFFF — and selects each row's kk
// smallest keys with the levels of select.cuh, which is (score desc, doc
// asc): the candidates are sorted, so doc order is lane order and this is
// lax.top_k's tie order.
//
// Bound: bytes — per kept posting its slot, weight and lane (12 bytes),
// the (doc, tf) pair it gathers (8) and its doc's norm (4), plus one
// read-modify-write of its lane; the selection reads each lane's score
// once. The design spends launches (one a slice) for determinism.

#include "contrib.cuh"
#include "select.cuh"

#define POOL_THREADS 256
#define POOL_SORT_FLOOR 32  // smallest tile of the selection levels
#define PAD_DOC 0x7FFFFFFF

__global__ void pool_slice_kernel(const int* __restrict__ docs_pg,
                                  const int* __restrict__ tfs_pg,
                                  const int* __restrict__ norms,
                                  const int* __restrict__ si,
                                  const float* __restrict__ w,
                                  const int* __restrict__ lane,
                                  const int* __restrict__ soff, int tp, int t,
                                  long long ep, long long cp, int scorer,
                                  float k1, float b, float avg,
                                  float* __restrict__ acc) {
  const long long q = blockIdx.y;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int* so = soff + q * (tp + 1);
  const long long s0 = so[t], n = so[t + 1] - s0;
  if (j >= n) return;
  const long long e = q * ep + s0 + j;
  const long long slot = si[e];
  const int d = docs_pg[slot];
  const float c = contrib(scorer, (float)tfs_pg[slot], (float)norms[d], w[e],
                          k1, b, avg);
  acc[q * cp + lane[e]] += c;
}

// Ascending keys for (score desc, doc asc); dead lanes after every live one.
__global__ void pool_keys_kernel(const float* __restrict__ acc,
                                 const int* __restrict__ cand,
                                 const int* __restrict__ nc, long long qp,
                                 long long cp,
                                 unsigned long long* __restrict__ keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= qp * cp) return;
  const long long q = i / cp, l = i - q * cp;
  const bool live = l < nc[q];
  const float s = live ? acc[i] : __int_as_float(0xff800000);  // -inf
  const unsigned d = live ? (unsigned)cand[i] : (unsigned)PAD_DOC;
  unsigned u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;                     // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // order-preserving
  keys[i] = ((unsigned long long)(~u) << 32) | d;
}

__global__ void pool_write_kernel(const unsigned long long* __restrict__ sorted,
                                  long long n, float* __restrict__ vals,
                                  int* __restrict__ docs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = sorted[i];
  const unsigned u = ~(unsigned)(key >> 32);
  vals[i] = __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
  docs[i] = (int)(unsigned)(key & 0xFFFFFFFFull);
}

static inline unsigned grid_for(long long threads, int block) {
  return (unsigned)((threads + block - 1) / block);
}

extern "C" {

// acc (qp, cp) f32 zeroed by the caller; slice_max (tp,) int64 in HOST
// memory: the longest slice t of any query (the grid of launch t). With
// kk > 0 (full mode) also: cand (qp, cp) int32, nc (qp,) int32, the
// selection buffers keys (cap_a keys, >= qp * cp) and buf_b (cap_b keys)
// sized by ops/select.py, and the outputs vals (qp, kk) f32 and docs
// (qp, kk) int32. With kk == 0 (partial mode) acc is the output.
int pool_score(const void* docs_pg, const void* tfs_pg, const void* norms,
               const void* si, const void* w, const void* lane,
               const void* soff, const long long* slice_max, long long qp,
               long long ep, int tp, long long cp, int scorer, float k1,
               float b, float avg, void* acc, const void* cand,
               const void* nc, int kk, void* keys, long long cap_a,
               void* buf_b, long long cap_b, void* vals, void* docs,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (qp <= 0 || qp > 65535) return (int)cudaErrorInvalidValue;
  for (int t = 0; t < tp; ++t) {
    if (slice_max[t] <= 0) continue;
    dim3 grid(grid_for(slice_max[t], POOL_THREADS), (unsigned)qp);
    pool_slice_kernel<<<grid, POOL_THREADS, 0, s>>>(
        (const int*)docs_pg, (const int*)tfs_pg, (const int*)norms,
        (const int*)si, (const float*)w, (const int*)lane, (const int*)soff,
        tp, t, ep, cp, scorer, k1, b, avg, (float*)acc);
  }
  if (kk <= 0) return (int)cudaGetLastError();
  if (kk > cp || qp * cp > cap_a) return (int)cudaErrorInvalidValue;
  pool_keys_kernel<<<grid_for(qp * cp, 256), 256, 0, s>>>(
      (const float*)acc, (const int*)cand, (const int*)nc, qp, cp,
      (unsigned long long*)keys);
  const unsigned long long* sorted = sel::levels(
      (unsigned long long*)keys, cap_a, (unsigned long long*)buf_b, cap_b,
      qp, cp, 1, kk, POOL_SORT_FLOOR, s);
  if (!sorted) return (int)cudaErrorInvalidValue;
  pool_write_kernel<<<grid_for(qp * kk, 256), 256, 0, s>>>(
      sorted, qp * kk, (float*)vals, (int*)docs);
  return (int)cudaGetLastError();
}

}  // extern "C"
