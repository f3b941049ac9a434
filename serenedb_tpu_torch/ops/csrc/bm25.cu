// BM25 scoring kernels for Hopper (sm_90a), with a plain C interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; each entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrappers and the plain PyTorch
// version of each kernel live in ops/bm25_kernels.py.
//
// 1. bm25_accumulate_rows / bm25_accumulate_tail
//    Replace serenedb_tpu/ops/bm25.py `_accumulate_scores` (with
//    `_decode_rows` and the `contrib_of` formula, which is also
//    `contrib_expr`), the body of `score_topk_packed`. One warp decodes one
//    128-posting row in registers: 4 uint16 gaps per lane, a per-lane
//    prefix sum, then a warp inclusive scan, plus the row's base doc; tf 0
//    marks padding. Each valid posting adds w * sat(tf, dl) into its
//    query's row of the (B, ndocs_pad) f32 score plane (and 1 into the i32
//    hit plane when a conjunction needs it).
//    Bound: bytes — the rows read (7 bytes a posting packed, 8 raw) and
//    one read-modify-write of a plane cell per posting, scattered. The
//    design takes no float atomics: the host tags every row with its
//    term's rank in its query and the wrapper launches one layer per
//    (plane, rank). Terms of a query are distinct and one term's postings
//    hit distinct docs, so within a launch no two threads touch one cell,
//    and the adds land in the reference's order (packed, raw, tails; terms
//    in query order) on every run. The cost is ~3 launches per query term.
//
// 2. build_dense_rows / build_dense_tail
//    Replace `_build_dense`. The wrapper zero-fills S (ndocs_pad, V_pad);
//    each posting writes sat(tf, dl) into its own cell S[doc, tid]. Every
//    cell gets at most one posting, so this is a scatter-set with no race.
//    Bound: bytes — the zero fill of S dominates (S is written once).
//
// 3. topk_rows
//    Replaces the `lax.top_k` of `_score_topk` and `dense_topk`, with the
//    conjunction mask (`hits >= require`) fused into the read. Each
//    element gets one unique 64-bit key: the order-preserving u32 of its
//    f32 score (-0.0 canonicalised to +0.0) in the high half and ~index in
//    the low half, so key order is (score desc, index asc) — lax.top_k's
//    tie order — and there are no ties. A per-row radix select over 8-bit
//    digits (up to 8 passes, each a shared-memory histogram with integer
//    atomics; a pass that pins the k-th key exits the rest early) finds the
//    k-th key, a collect pass gathers the k keys at or above it, and
//    the levels of select.cuh sort them (complemented, so ascending is
//    the order wanted), for any k: a search scan that ranks every match
//    asks for k up to the plane's width.
//    Bound: bytes — each pass reads the plane (and the hit plane) once.
//
// 4. contrib_flat
//    Replaces `contrib_flat` (`contrib_expr` over flat arrays), the one
//    elementwise dispatch of the host ragged path (searcher
//    `_ragged_resolve`): c[i] = w[i] * sat(tfs[i], dls[i]), one thread a
//    posting, through the same `contrib()` (contrib.cuh) as the plane
//    kernels, so its bits equal theirs. Padding (tf 0, w 0) gives 0.
//    Bound: bytes — 12 bytes read and 4 written a posting.
//
// 5. match_bitmap
//    Replaces `match_bitmap`, the disjunctive match bitmap of an unscored
//    filter: every live doc of the selected packed rows (decoded as in 1:
//    base + prefix sum of the gaps, tf 0 marks padding), of the selected
//    raw rows (doc >= 0) and of the tails (doc >= 0) sets its byte of a
//    zero-filled bool[ndocs_pad]; docs past the bitmap are dropped, as
//    the reference's scatter drops them. One warp a packed row, one
//    thread a raw or tail posting. Every writer stores the same 1, so
//    the stores need no atomics.
//    Bound: bytes — the rows read (3 bytes a packed posting, 4 a raw or
//    tail doc) and the bitmap written once.

#include "contrib.cuh"
#include "select.cuh"

#define ROW 128  // postings in one block row

// Dense saturation (`_build_dense`): sat = (k1+1) tf / max(tf + alpha, 1e-9)
// with alpha = k1 (1 - b + b dl / avg); sqrt(tf) for tfidf.
__device__ __forceinline__ float saturation(int scorer, float tf, float dl,
                                            float k1, float b, float avg) {
  if (scorer == SC_TFIDF) return sqrtf(tf);
  float alpha = k1 * (1.0f - b + b * dl / avg);
  return (k1 + 1.0f) * tf / fmaxf(tf + alpha, 1e-9f);
}

// Decode lanes 4*lane .. 4*lane+3 of block row r into docs/tfs: packed rows
// from base + inclusive prefix sum of uint16 gaps (slot 0 holds 0), raw
// rows as stored. A posting is valid when doc >= 0 and tf > 0.
template <bool PACKED>
__device__ __forceinline__ void load_row(const int* __restrict__ base,
                                         const uint16_t* __restrict__ gaps,
                                         const uint8_t* __restrict__ tfs8,
                                         const int* __restrict__ raw_docs,
                                         const int* __restrict__ raw_tfs,
                                         long long r, int lane, int docs[4],
                                         int tfs[4]) {
  if (PACKED) {
    uint2 gv = *reinterpret_cast<const uint2*>(gaps + r * ROW + 4 * lane);
    int s0 = (int)(gv.x & 0xFFFFu);
    int s1 = s0 + (int)(gv.x >> 16);
    int s2 = s1 + (int)(gv.y & 0xFFFFu);
    int s3 = s2 + (int)(gv.y >> 16);
    int incl = s3;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int start = base[r] + (incl - s3);
    docs[0] = start + s0;
    docs[1] = start + s1;
    docs[2] = start + s2;
    docs[3] = start + s3;
    uint32_t tv = *reinterpret_cast<const uint32_t*>(tfs8 + r * ROW + 4 * lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) tfs[i] = (int)((tv >> (8 * i)) & 0xFFu);
  } else {
    int4 dv = *reinterpret_cast<const int4*>(raw_docs + r * ROW + 4 * lane);
    int4 tv = *reinterpret_cast<const int4*>(raw_tfs + r * ROW + 4 * lane);
    docs[0] = dv.x; docs[1] = dv.y; docs[2] = dv.z; docs[3] = dv.w;
    tfs[0] = tv.x; tfs[1] = tv.y; tfs[2] = tv.z; tfs[3] = tv.w;
  }
}

// One warp per selected row; rows of other layers return at once.
template <bool PACKED>
__global__ void accumulate_rows_kernel(
    const int* __restrict__ base, const uint16_t* __restrict__ gaps,
    const uint8_t* __restrict__ tfs8, const int* __restrict__ raw_docs,
    const int* __restrict__ raw_tfs, const int* __restrict__ norms,
    const int* __restrict__ row_idx, const float* __restrict__ row_w,
    const int* __restrict__ row_qid, const int* __restrict__ row_rank,
    long long n_rows, int layer, float* __restrict__ scores,
    int* __restrict__ hits, long long ndocs_pad, int scorer, float k1,
    float b, float avg) {
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= n_rows || row_rank[warp] != layer) return;  // warp-uniform
  long long r = row_idx[warp];
  float w = row_w[warp];
  long long qoff = (long long)row_qid[warp] * ndocs_pad;
  int docs[4], tfs[4];
  load_row<PACKED>(base, gaps, tfs8, raw_docs, raw_tfs, r, lane, docs, tfs);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (docs[i] < 0 || tfs[i] <= 0) continue;
    float dl = (float)norms[docs[i]];
    float c = contrib(scorer, (float)tfs[i], dl, w, k1, b, avg);
    scores[qoff + docs[i]] += c;
    if (hits) hits[qoff + docs[i]] += 1;
  }
}

__global__ void accumulate_tail_kernel(
    const int* __restrict__ docs, const int* __restrict__ tfs,
    const float* __restrict__ w, const int* __restrict__ qid,
    const int* __restrict__ rank, long long n, int layer,
    const int* __restrict__ norms, float* __restrict__ scores,
    int* __restrict__ hits, long long ndocs_pad, int scorer, float k1,
    float b, float avg) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || rank[i] != layer) return;
  int d = docs[i], tf = tfs[i];
  if (d < 0 || tf <= 0) return;
  float c = contrib(scorer, (float)tf, (float)norms[d], w[i], k1, b, avg);
  long long cell = (long long)qid[i] * ndocs_pad + d;
  scores[cell] += c;
  if (hits) hits[cell] += 1;
}

template <bool PACKED>
__global__ void dense_rows_kernel(
    const int* __restrict__ base, const uint16_t* __restrict__ gaps,
    const uint8_t* __restrict__ tfs8, const int* __restrict__ raw_docs,
    const int* __restrict__ raw_tfs, const int* __restrict__ row_tid,
    long long n_rows, const int* __restrict__ norms, float* __restrict__ S,
    long long v_pad, int scorer, float k1, float b, float avg) {
  long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  long long tid = row_tid[r];
  int docs[4], tfs[4];
  load_row<PACKED>(base, gaps, tfs8, raw_docs, raw_tfs, r, lane, docs, tfs);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (docs[i] < 0 || tfs[i] <= 0) continue;
    S[(long long)docs[i] * v_pad + tid] =
        saturation(scorer, (float)tfs[i], (float)norms[docs[i]], k1, b, avg);
  }
}

__global__ void dense_tail_kernel(const int* __restrict__ docs,
                                  const int* __restrict__ tfs,
                                  const int* __restrict__ tids, long long n,
                                  const int* __restrict__ norms,
                                  float* __restrict__ S, long long v_pad,
                                  int scorer, float k1, float b, float avg) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int d = docs[i], tf = tfs[i];
  if (d < 0 || tf <= 0) return;
  S[(long long)d * v_pad + tids[i]] =
      saturation(scorer, (float)tf, (float)norms[d], k1, b, avg);
}

// ------------------------------------------------------------------ top-k

#define TOPK_THREADS 256
#define TOPK_CHUNK 8192   // plane elements per block in the scan passes
#define TOPK_SORT_FLOOR 32  // smallest tile of the sort levels
#define ST_PREFIX 0       // per-row state, 8 int64 slots
#define ST_REMAINING 1
#define ST_NBITS 2
#define ST_DONE 3
#define ST_SLOTS 8

// hits_kind: 0 none, 1 int32 hit counts, 2 float32 hit counts.
__device__ __forceinline__ unsigned long long load_key(
    const float* __restrict__ scores, const void* __restrict__ hits,
    int hits_kind, int need, long long off, long long j) {
  float s = scores[off + j];
  if (hits_kind && need > 0) {
    bool ok = hits_kind == 1
                  ? reinterpret_cast<const int*>(hits)[off + j] >= need
                  : reinterpret_cast<const float*>(hits)[off + j] >= (float)need;
    if (!ok) s = 0.0f;
  }
  unsigned u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;                     // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // order-preserving
  return ((unsigned long long)u << 32) | (unsigned long long)(~(unsigned)j);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// Histogram of the 8-bit digit at `shift` over the keys whose higher bits
// equal the row's prefix found so far.
__global__ void topk_hist_kernel(const float* __restrict__ scores,
                                 const void* __restrict__ hits, int hits_kind,
                                 const int* __restrict__ require,
                                 long long ncols,
                                 const long long* __restrict__ state,
                                 unsigned* __restrict__ hist, int shift) {
  long long row = blockIdx.y;
  const long long* st = state + row * ST_SLOTS;
  if (st[ST_DONE]) return;
  __shared__ unsigned h[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) h[i] = 0;
  __syncthreads();
  unsigned long long prefix = (unsigned long long)st[ST_PREFIX];
  int hi = shift + 8;
  int need = hits_kind ? require[row] : 0;
  long long off = row * ncols;
  long long begin = (long long)blockIdx.x * TOPK_CHUNK;
  long long end = min(ncols, begin + TOPK_CHUNK);
  int lane = threadIdx.x & 31;
  // warp-uniform trip count, so every lane reaches __match_any_sync
  for (long long j0 = begin + (threadIdx.x & ~31); j0 < end;
       j0 += blockDim.x) {
    long long j = j0 + lane;
    unsigned digit = 256;  // no match
    if (j < end) {
      unsigned long long key = load_key(scores, hits, hits_kind, need, off, j);
      if (hi >= 64 || (key >> hi) == (prefix >> hi))
        digit = (unsigned)(key >> shift) & 0xFFu;
    }
    // one shared atomic per distinct digit in the warp: a plane full of
    // equal scores would otherwise serialise 32 atomics on one bin
    unsigned peers = __match_any_sync(0xffffffffu, digit);
    if (digit < 256 && lane == __ffs(peers) - 1)
      atomicAdd(&h[digit], (unsigned)__popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    if (h[i]) atomicAdd(&hist[row * 256 + i], h[i]);
}

// Per row: pick the digit holding the k-th key, extend the prefix, and
// clear the histogram for the next pass.
__global__ void topk_select_kernel(long long rows, long long* __restrict__ state,
                                   unsigned* __restrict__ hist, int shift) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  long long* st = state + row * ST_SLOTS;
  if (st[ST_DONE]) return;
  unsigned* h = hist + row * 256;
  long long rem = st[ST_REMAINING];
  int d = 255;
  for (; d > 0; --d) {
    if ((long long)h[d] >= rem) break;
    rem -= h[d];
  }
  unsigned long long prefix = (unsigned long long)st[ST_PREFIX];
  prefix |= (unsigned long long)d << shift;
  st[ST_PREFIX] = (long long)prefix;
  st[ST_NBITS] = 64 - shift;
  if ((long long)h[d] == rem) st[ST_DONE] = 1;  // every key of the bin is in
  st[ST_REMAINING] = rem;
  for (int i = 0; i < 256; ++i) h[i] = 0;
}

// Gather the keys whose known high bits are >= the selected prefix: exactly
// k keys per row, in no particular order, complemented (so the ascending
// levels of select.cuh sort them descending).
__global__ void topk_collect_kernel(const float* __restrict__ scores,
                                    const void* __restrict__ hits,
                                    int hits_kind,
                                    const int* __restrict__ require,
                                    long long ncols,
                                    const long long* __restrict__ state,
                                    unsigned long long* __restrict__ cand,
                                    unsigned* __restrict__ counts, int k) {
  long long row = blockIdx.y;
  const long long* st = state + row * ST_SLOTS;
  int sh = 64 - (int)st[ST_NBITS];
  unsigned long long thr = (unsigned long long)st[ST_PREFIX] >> sh;
  int need = hits_kind ? require[row] : 0;
  long long off = row * ncols;
  long long begin = (long long)blockIdx.x * TOPK_CHUNK;
  long long end = min(ncols, begin + TOPK_CHUNK);
  for (long long j = begin + threadIdx.x; j < end; j += blockDim.x) {
    unsigned long long key = load_key(scores, hits, hits_kind, need, off, j);
    if ((key >> sh) >= thr) {
      unsigned pos = atomicAdd(&counts[row], 1u);
      if (pos < (unsigned)k) cand[row * k + pos] = ~key;
    }
  }
}

// Write the sorted (complemented) keys as (value, index).
__global__ void topk_write_kernel(const unsigned long long* __restrict__ cand,
                                  long long n, float* __restrict__ vals,
                                  int* __restrict__ idx) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  unsigned long long key = ~cand[t];
  vals[t] = key_value(key);
  idx[t] = (int)(~(unsigned)(key & 0xFFFFFFFFull));
}

__global__ void contrib_flat_kernel(const int* __restrict__ tfs,
                                    const int* __restrict__ dls,
                                    const float* __restrict__ w, long long n,
                                    int scorer, float k1, float b, float avg,
                                    float* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = contrib(scorer, (float)tfs[i], (float)dls[i], w[i], k1, b, avg);
}

static inline unsigned grid_for(long long threads, int block) {
  return (unsigned)((threads + block - 1) / block);
}

// One warp a selected packed row: every valid posting sets its doc.
__global__ void match_rows_kernel(const int* __restrict__ base,
                                  const uint16_t* __restrict__ gaps,
                                  const uint8_t* __restrict__ tfs8,
                                  const int* __restrict__ row_idx,
                                  long long n_rows, long long ndocs_pad,
                                  uint8_t* __restrict__ out) {
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= n_rows) return;  // warp-uniform
  int docs[4], tfs[4];
  load_row<true>(base, gaps, tfs8, nullptr, nullptr, row_idx[warp], lane,
                 docs, tfs);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (tfs[i] > 0 && docs[i] >= 0 && docs[i] < ndocs_pad) out[docs[i]] = 1;
}

// One thread a doc: row i / ROW of the raw plane at row_idx (or, with
// row_idx null, the flat tail docs).
__global__ void match_docs_kernel(const int* __restrict__ docs,
                                  const int* __restrict__ row_idx,
                                  long long n, long long ndocs_pad,
                                  uint8_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int d = row_idx ? docs[(long long)row_idx[i / ROW] * ROW + i % ROW]
                  : docs[i];
  if (d >= 0 && d < ndocs_pad) out[d] = 1;
}

extern "C" {

// The match bitmap out (ndocs_pad bytes, zeroed by the caller) of the
// packed rows row_idx, the raw rows raw_idx and the tail docs.
int match_bitmap(const void* base, const void* gaps, const void* tfs8,
                 const void* row_idx, long long n_rows, const void* raw_docs,
                 const void* raw_idx, long long n_raw, const void* tail_docs,
                 long long n_tail, long long ndocs_pad, void* out,
                 void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows > 0)
    match_rows_kernel<<<grid_for(n_rows * 32, threads), threads, 0, s>>>(
        (const int*)base, (const uint16_t*)gaps, (const uint8_t*)tfs8,
        (const int*)row_idx, n_rows, ndocs_pad, (uint8_t*)out);
  if (n_raw > 0)
    match_docs_kernel<<<grid_for(n_raw * ROW, threads), threads, 0, s>>>(
        (const int*)raw_docs, (const int*)raw_idx, n_raw * ROW, ndocs_pad,
        (uint8_t*)out);
  if (n_tail > 0)
    match_docs_kernel<<<grid_for(n_tail, threads), threads, 0, s>>>(
        (const int*)tail_docs, nullptr, n_tail, ndocs_pad, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// Launch one (plane, layer) of the accumulate: packed != 0 decodes the
// packed plane, else reads the raw plane. hits may be null.
int bm25_accumulate_rows(int packed, const void* base, const void* gaps,
                         const void* tfs8, const void* raw_docs,
                         const void* raw_tfs, const void* norms,
                         const void* row_idx, const void* row_w,
                         const void* row_qid, const void* row_rank,
                         long long n_rows, int layer, void* scores, void* hits,
                         long long ndocs_pad, int scorer, float k1, float b,
                         float avg, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  unsigned grid = grid_for(n_rows * 32, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (packed)
    accumulate_rows_kernel<true><<<grid, threads, 0, s>>>(
        (const int*)base, (const uint16_t*)gaps, (const uint8_t*)tfs8,
        nullptr, nullptr, (const int*)norms, (const int*)row_idx,
        (const float*)row_w, (const int*)row_qid, (const int*)row_rank,
        n_rows, layer, (float*)scores, (int*)hits, ndocs_pad, scorer, k1, b,
        avg);
  else
    accumulate_rows_kernel<false><<<grid, threads, 0, s>>>(
        nullptr, nullptr, nullptr, (const int*)raw_docs,
        (const int*)raw_tfs, (const int*)norms, (const int*)row_idx,
        (const float*)row_w, (const int*)row_qid, (const int*)row_rank,
        n_rows, layer, (float*)scores, (int*)hits, ndocs_pad, scorer, k1, b,
        avg);
  return (int)cudaGetLastError();
}

int bm25_accumulate_tail(const void* docs, const void* tfs, const void* w,
                         const void* qid, const void* rank, long long n,
                         int layer, const void* norms, void* scores,
                         void* hits, long long ndocs_pad, int scorer,
                         float k1, float b, float avg, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  accumulate_tail_kernel<<<grid_for(n, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)docs, (const int*)tfs, (const float*)w, (const int*)qid,
      (const int*)rank, n, layer, (const int*)norms, (float*)scores,
      (int*)hits, ndocs_pad, scorer, k1, b, avg);
  return (int)cudaGetLastError();
}

int build_dense_rows(int packed, const void* base, const void* gaps,
                     const void* tfs8, const void* raw_docs,
                     const void* raw_tfs, const void* row_tid,
                     long long n_rows, const void* norms, void* S,
                     long long v_pad, int scorer, float k1, float b,
                     float avg, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  unsigned grid = grid_for(n_rows * 32, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (packed)
    dense_rows_kernel<true><<<grid, threads, 0, s>>>(
        (const int*)base, (const uint16_t*)gaps, (const uint8_t*)tfs8,
        nullptr, nullptr, (const int*)row_tid, n_rows, (const int*)norms,
        (float*)S, v_pad, scorer, k1, b, avg);
  else
    dense_rows_kernel<false><<<grid, threads, 0, s>>>(
        nullptr, nullptr, nullptr, (const int*)raw_docs, (const int*)raw_tfs,
        (const int*)row_tid, n_rows, (const int*)norms, (float*)S, v_pad,
        scorer, k1, b, avg);
  return (int)cudaGetLastError();
}

int build_dense_tail(const void* docs, const void* tfs, const void* tids,
                     long long n, const void* norms, void* S, long long v_pad,
                     int scorer, float k1, float b, float avg, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  dense_tail_kernel<<<grid_for(n, threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (const int*)docs, (const int*)tfs, (const int*)tids, n,
      (const int*)norms, (float*)S, v_pad, scorer, k1, b, avg);
  return (int)cudaGetLastError();
}

// Top-k of every row of a (rows, ncols) f32 plane by (score desc, index
// asc). Scratch from the wrapper: state (rows, 8) int64 with
// state[:, 1] = k and the rest 0; hist (rows, 256) u32 zeroed; cand
// (cap_a >= rows * k keys) and buf_b (cap_b keys), the levels' buffers
// (ops/select.py); counts (rows,) u32 zeroed.
int topk_rows(const void* scores, long long rows, long long ncols,
              const void* hits, int hits_kind, const void* require, int k,
              void* state, void* hist, void* cand, long long cap_a,
              void* buf_b, long long cap_b, void* counts, void* vals,
              void* idx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k < 1 || rows * k > cap_a) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((ncols + TOPK_CHUNK - 1) / TOPK_CHUNK), (unsigned)rows);
  for (int shift = 56; shift >= 0; shift -= 8) {
    topk_hist_kernel<<<grid, TOPK_THREADS, 0, s>>>(
        (const float*)scores, hits, hits_kind, (const int*)require, ncols,
        (const long long*)state, (unsigned*)hist, shift);
    topk_select_kernel<<<grid_for(rows, 128), 128, 0, s>>>(
        rows, (long long*)state, (unsigned*)hist, shift);
  }
  topk_collect_kernel<<<grid, TOPK_THREADS, 0, s>>>(
      (const float*)scores, hits, hits_kind, (const int*)require, ncols,
      (const long long*)state, (unsigned long long*)cand, (unsigned*)counts,
      k);
  const unsigned long long* sorted = sel::levels(
      (unsigned long long*)cand, cap_a, (unsigned long long*)buf_b, cap_b,
      rows, k, 1, k, TOPK_SORT_FLOOR, s);
  if (!sorted) return (int)cudaErrorInvalidValue;
  topk_write_kernel<<<grid_for(rows * k, 256), 256, 0, s>>>(
      sorted, rows * k, (float*)vals, (int*)idx);
  return (int)cudaGetLastError();
}

// Per-posting contributions of n flat postings (int32 tfs and dls, f32 w)
// into out (n f32).
int contrib_flat(const void* tfs, const void* dls, const void* w, long long n,
                 int scorer, float k1, float b, float avg, void* out,
                 void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  contrib_flat_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const int*)tfs, (const int*)dls, (const float*)w, n, scorer, k1, b,
      avg, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
