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
//    tie order — and there are no ties. Every word of scratch is in one
//    buffer (`topk_bytes`) that the call sets; arguments go by value. Two
//    regimes, picked by the wrapper from k (TOPK_ONE_MAX, from card
//    timings):
//    - one read (k <= TOPK_ONE_MAX): two launches. Pass 0 reads the plane
//      once (a lane takes four consecutive columns, one vector load of the
//      scores and one of the hits, from the row's first 16-byte boundary;
//      the row's first warp takes the columns outside the quads) and each
//      warp keeps every key at or above its own 64-bit threshold in its
//      part of a candidate slab, raising the threshold when the part
//      fills (a radix select over the part's keys, never above the warp's
//      k-th largest) and once more at the end. Then TAKE, one block a row:
//      a radix select of 11 bits a round over the row's candidates (in
//      device memory until the bin holding the k-th key fits shared
//      memory), the k keys at or above it sorted and written. Ties need
//      no fallback: the index makes every key unique.
//      The per-warp steps it shares with topn.cu's topn_scan (ranks,
//      appends, the bin pick, the keep) are in warp_cand.cuh.
//    - radix (larger k, up to the row): an init launch sets the per-row
//      state, then a per-row radix select over 8-bit digits (up to 8
//      passes over the plane, each a shared-memory histogram with integer
//      atomics; a pass that pins the k-th key exits the rest early), a
//      collect pass gathers the k keys at or above it, and the levels of
//      select.cuh sort them (complemented, so ascending is the order
//      wanted): a search scan that ranks every match asks for k up to the
//      plane's width.
//    Bound: bytes — the plane (and the hit plane of the rows with require
//    > 0) read once in the one-read regime, up to nine times in the radix.
//
// 4. contrib_flat
//    Replaces `contrib_flat` (`contrib_expr` over flat arrays), the one
//    elementwise dispatch of the host ragged path (searcher
//    `_ragged_resolve`): c[i] = w[i] * sat(tfs[i], dl), through the same
//    `contrib()` (contrib.cuh) as the plane kernels, so its bits equal
//    theirs. dl is dls[i], or, where the caller passes `norms`, the
//    resident norm of the doc dls[i] (the route then uploads doc ids and
//    no host gather of the norms runs). Four postings a thread, each
//    array read with one 16-byte load where it is aligned (the route's
//    three runs of one packed upload are). Padding (tf 0, w 0)
//    gives 0.
//    Bound: bytes — 12 bytes read and 4 written a posting, and with
//    `norms` the 4-byte norm of each posting's doc.
//
// 5. match_bitmap
//    Replaces `match_bitmap`, the disjunctive match bitmap of an unscored
//    filter: every live doc of the selected packed rows (decoded as in 1:
//    base + prefix sum of the gaps, tf 0 marks padding), of the selected
//    raw rows (doc >= 0) and of the tails (doc >= 0) sets its byte of a
//    zeroed bool[ndocs_pad]; docs past the bitmap are dropped, as the
//    reference's scatter drops them. Every writer stores the same 1, so
//    the stores need no atomics.
//    Bound: bytes — the rows read (3 bytes a packed posting, 4 a raw or
//    tail doc) and the bitmap written once: 8 MB, ~2.4 µs, for the packed
//    corpus's 8,000,512 docs. The first design was a zero-fill launch and
//    up to three kernels (a warp a packed row, a thread a raw or tail
//    doc), so every size was launch-bound. Now one launch a call: a grid
//    of at most MB_BLOCKS_SM blocks an SM zeroes the bitmap with 16-byte
//    stores, syncs the grid (a cooperative launch), then its warps take
//    the tasks with the grid's stride: the packed rows (a warp a row,
//    load_row), then the raw rows (a 16-byte load a lane), then the tails
//    128 docs a warp (16-byte loads where aligned). A call was 0.0134 ms
//    (0.0111 on the card) at 8,000,512 docs; with a cudaMemsetAsync in
//    the C entry before the same kernel without its fill instead, 0.0176
//    (0.0030 memset + 0.0075 kernel; scripts/mesh_variants.py, NVIDIA
//    H100 80GB HBM3 at 700 W).

#include <cooperative_groups.h>
#include <stdint.h>

#include "contrib.cuh"
#include "select.cuh"
#include "warp_cand.cuh"

namespace cg = cooperative_groups;

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

namespace {

using cand::append;
using cand::warp_keep;
using cand::warp_pick;
using cand::warp_rank;

typedef unsigned long long u64;
constexpr uint32_t TK_FULL = 0xFFFFFFFFu;

// the one-read regime
constexpr int TK_THREADS = 256, TK_WARPS = TK_THREADS / 32;
// pass 0's blocks an SM (128 registers a thread: no spill at four quads
// in flight) and one wave of its warps
constexpr int TK_BLOCKS_SM = 2;
constexpr long long TK_TARGET_WARPS = 132LL * TK_WARPS * TK_BLOCKS_SM;
constexpr int TK_U = 4;             // quads a lane has in flight
constexpr int TK_TAKE_THREADS = 256;
constexpr int TK_DIGIT = 11, TK_BINS = 1 << TK_DIGIT;
constexpr int TK_LIVE = 2048;       // keys TAKE holds in shared memory
constexpr int TK_ONE_LIMIT = 8192;  // the most k the one-read regime takes
constexpr int TK_HIST8 = 256;       // a warp's histogram when it raises
// the radix regime
constexpr int TOPK_THREADS = 256;
constexpr long long TOPK_CHUNK = 8192;  // plane elements a block scans
constexpr int TOPK_SORT_FLOOR = 32;     // smallest tile of the sort levels
constexpr int ST_PREFIX = 0, ST_REMAINING = 1, ST_NBITS = 2, ST_DONE = 3,
              ST_SLOTS = 8;

// One call: the plane, its mask, the outputs, and the regime's scratch,
// all views of the wrapper's one buffer (`topk_bytes`); by value.
struct TopkArgs {
  const float* scores;
  const void* hits;   // hits_kind 1: int32, 2: float32; 0: none
  const int* require;
  float* vals;
  int* idx;
  long long rows, ncols;
  int hits_kind, k, vec;
  // one-read: warp g of the grid is part g % wpr of row g / wpr; its
  // candidates (at most `part`) at cand + g * part, their count count[g]
  long long wpr, qw, part;
  u64* cand;
  unsigned* count;
  // radix
  long long nchunk, cap_a, cap_b;
  long long* state;
  unsigned* hist;
  unsigned* rcount;
  u64* rcand;
  u64* buf_b;
};

// The order-preserving image of a masked score: -0.0 ties +0.0; a
// positive NaN sorts above +inf, a negative one below -inf.
__device__ __forceinline__ uint32_t score_image(float s) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool hit_ok(int kind, int need, uint32_t hv) {
  return kind == 1 ? static_cast<int>(hv) >= need
                   : __uint_as_float(hv) >= static_cast<float>(need);
}

// The key of column j: the masked score's image above ~j, so descending
// key order is (score desc, index asc) and no two keys are equal.
__device__ __forceinline__ u64 tk_key(float s, bool ok, long long j) {
  return (static_cast<u64>(score_image(ok ? s : 0.0f)) << 32) |
         static_cast<u64>(~static_cast<uint32_t>(j));
}

__device__ __forceinline__ u64 warp_min64(u64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 w = __shfl_xor_sync(TK_FULL, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__device__ __forceinline__ u64 warp_max64(u64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 w = __shfl_xor_sync(TK_FULL, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// a and b agree on the bits at and above `top` (top 64: always)
__device__ __forceinline__ bool same_above(u64 a, u64 b, int top) {
  return top >= 64 || ((a ^ b) >> top) == 0ull;
}

// A threshold for a warp's cnt >= k candidates that at least k of them
// reach and at most `target` (or, where the bits run out, exactly k): a
// radix select over the bits they do not all share, eight at a time from
// the highest, stopping as soon as the keys at or above the threshold
// are few enough. A warp histogram of 256 bins in shared memory.
__device__ __noinline__ u64 warp_refine(const u64* sub, unsigned cnt,
                                        unsigned k, unsigned target,
                                        unsigned* hist) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  u64 lo = ~0ull, hi = 0ull;
  for (unsigned i = lane; i < cnt; i += 32) {
    const u64 e = sub[i];
    lo = e < lo ? e : lo;
    hi = e > hi ? e : hi;
  }
  lo = warp_min64(lo);
  hi = warp_max64(hi);
  if (lo == hi) return lo;
  int top = 64 - __clzll(lo ^ hi);  // bits [0, top) vary
  u64 thr = top >= 64 ? 0ull : (lo >> top) << top;
  unsigned above = 0, rem = k;
  for (;;) {
    const int sh = top > 8 ? top - 8 : 0;
    const unsigned mask = (1u << (top - sh)) - 1u;
    for (int i = lane; i < TK_HIST8; i += 32) hist[i] = 0u;
    __syncwarp();
    for (unsigned i = lane; i < cnt; i += 32) {
      const u64 e = sub[i];
      if (same_above(e, thr, top))
        atomicAdd(&hist[static_cast<unsigned>(e >> sh) & mask], 1u);
    }
    __syncwarp();
    unsigned gt;
    const unsigned bin = warp_pick<8>(hist, rem, gt);
    const unsigned inb = hist[bin];
    __syncwarp();
    thr |= static_cast<u64>(bin) << sh;
    above += gt;
    rem -= gt;
    if (above + inb <= target || sh == 0) return thr;
    top = sh;
  }
}

// A warp's pass-0 state, in shared memory.
struct KeepState {
  unsigned cnt, pad;
  u64 thr;
};

// Append the warp's flagged keys of this step (bit j of a lane's `flags`:
// key j) to its part, first raising the threshold where they would not
// fit. Out of line and rare.
__device__ __noinline__ void keep_tile(KeepState* st, u64* sub, unsigned part,
                                       unsigned k, unsigned target,
                                       unsigned* hist, u64 k0, u64 k1, u64 k2,
                                       u64 k3, unsigned flags) {
  const u64 key[4] = {k0, k1, k2, k3};
  bool keep[4];
  unsigned rank[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) keep[j] = (flags >> j) & 1u;
  unsigned total = warp_rank(keep, rank);
  unsigned cnt = st->cnt;
  if (cnt + total > part) {
    // cnt > part - 128 >= k + 128: a threshold that k of them reach
    u64 thr = warp_refine(sub, cnt, k, target, hist);
    thr = thr > st->thr ? thr : st->thr;
    cnt = warp_keep(sub, cnt, thr);
#pragma unroll
    for (int j = 0; j < 4; ++j) keep[j] = keep[j] && key[j] >= thr;
    total = warp_rank(keep, rank);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) st->thr = thr;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (keep[j]) sub[cnt + rank[j]] = key[j];
  __syncwarp();
  if ((threadIdx.x & 31) == 0) st->cnt = cnt + total;
  __syncwarp();
}

// Quad q of a row (columns col .. col+3): one vector load of the scores
// and one of the hits where the row is aligned for them (`vec`), else
// four scalar loads each. Out of range: nothing.
__device__ __forceinline__ void load_quad(const TopkArgs& a, const float* s,
                                          const uint32_t* h, long long col,
                                          bool in, float (&v)[4],
                                          uint32_t (&hv)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = 0.0f;
    hv[j] = 0u;
  }
  if (!in) return;
  if (a.vec) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(s + col));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
    if (h) {
      const uint4 y = __ldcs(reinterpret_cast<const uint4*>(h + col));
      hv[0] = y.x;
      hv[1] = y.y;
      hv[2] = y.z;
      hv[3] = y.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = __ldcs(s + col + j);
      if (h) hv[j] = __ldcs(h + col + j);
    }
  }
}

// Pass 0, the one read of the plane. Warp g takes quads [p·qw, (p+1)·qw)
// of row g / wpr (p = g % wpr), a quad being four columns from the row's
// first 16-byte boundary (the row's first warp also takes the up to
// three columns before it and after the last quad), and keeps in its part
// every key at or above its threshold. When the part is full the
// threshold rises (warp_refine, never above the warp's k-th largest key,
// so never above the row's) and the part keeps the keys at or above it;
// at the end the part is refined once more. Keys are unique, so a part
// never fills with ties. No barrier, no atomic but the refine's.
__global__ void __launch_bounds__(TK_THREADS, TK_BLOCKS_SM)
    topk_pass0_kernel(const __grid_constant__ TopkArgs a) {
  __shared__ KeepState s_keep[TK_WARPS];
  __shared__ unsigned s_hist[TK_WARPS][TK_HIST8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = static_cast<long long>(blockIdx.x) * TK_WARPS + warp;
  if (g >= a.rows * a.wpr) return;  // warp-uniform
  const long long row = g / a.wpr, p = g - row * a.wpr;
  const float* srow = a.scores + row * a.ncols;
  const int need = a.hits_kind ? a.require[row] : 0;
  const uint32_t* hrow =
      a.hits_kind && need > 0
          ? static_cast<const uint32_t*>(a.hits) + row * a.ncols
          : nullptr;
  long long head = 0;
  if (a.vec) {
    head = (4 - static_cast<long long>(
                    (reinterpret_cast<uintptr_t>(srow) >> 2) & 3)) & 3;
    if (head > a.ncols) head = a.ncols;
  }
  const long long nq = (a.ncols - head) >> 2;
  const long long qa = p * a.qw;
  const long long qb = qa + a.qw < nq ? qa + a.qw : nq;
  const unsigned part = static_cast<unsigned>(a.part);
  const unsigned k = static_cast<unsigned>(a.k);
  const unsigned target = k + 16;
  u64* sub = a.cand + g * a.part;
  KeepState* st = s_keep + warp;
  unsigned* hist = s_hist[warp];
  if (lane == 0) {
    st->cnt = 0u;
    st->thr = 0ull;
  }
  __syncwarp();
  for (long long q0 = qa; q0 < qb; q0 += 32 * TK_U) {
    float v[TK_U][4];
    uint32_t hv[TK_U][4];
#pragma unroll
    for (int u = 0; u < TK_U; ++u) {
      const long long q = q0 + 32 * u + lane;
      load_quad(a, srow, hrow, head + 4 * q, q < qb, v[u], hv[u]);
    }
#pragma unroll
    for (int u = 0; u < TK_U; ++u) {
      const long long q = q0 + 32 * u + lane;
      const long long col = head + 4 * q;
      u64 key[4];
      unsigned flags = 0;
      const u64 thr = st->thr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        key[j] = tk_key(v[u][j], !hrow || hit_ok(a.hits_kind, need, hv[u][j]),
                        col + j);
        flags |= static_cast<unsigned>(q < qb && key[j] >= thr) << j;
      }
      if (__any_sync(TK_FULL, flags != 0u))
        keep_tile(st, sub, part, k, target, hist, key[0], key[1], key[2],
                  key[3], flags);
    }
  }
  if (p == 0) {
    // the columns before the first quad (lanes 0-2) and after the last
    // (lanes 4-6), one a lane
    const long long tail = a.ncols - head - 4 * nq;
    long long col = -1;
    if (lane < head) col = lane;
    if (lane >= 4 && lane - 4 < tail) col = head + 4 * nq + (lane - 4);
    u64 key = 0ull;
    bool f = false;
    if (col >= 0) {
      const float v = srow[col];
      const bool ok =
          !hrow || hit_ok(a.hits_kind, need, hrow[col]);
      key = tk_key(v, ok, col);
      f = key >= st->thr;
    }
    if (__any_sync(TK_FULL, f))
      keep_tile(st, sub, part, k, target, hist, key, 0ull, 0ull, 0ull,
                f ? 1u : 0u);
  }
  unsigned cnt = st->cnt;
  if (cnt > target) {
    u64 thr = warp_refine(sub, cnt, k, target, hist);
    thr = thr > st->thr ? thr : st->thr;
    cnt = warp_keep(sub, cnt, thr);
  }
  if (lane == 0) a.count[g] = cnt;
}

// Add one to each lane's bin (NONE: nothing), one shared atomic per
// distinct bin of the warp. Every lane of the warp calls it.
constexpr unsigned NONE = 0xFFFFFFFFu;
__device__ __forceinline__ void warp_bin(unsigned* h, unsigned bin) {
  const unsigned peers = __match_any_sync(TK_FULL, bin);
  if (bin != NONE && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&h[bin], static_cast<unsigned>(__popc(peers)));
}

// TAKE: one block a row. Its candidates are the parts' keys (a flat index
// over the parts: a prefix of their counts in shared memory and a binary
// search a key). A radix select, 11 bits a round from the top, finds the
// k-th largest key: rounds over the candidates in device memory until the
// bin that holds it has at most TK_LIVE keys, then one pass moves that
// bin's keys to shared memory (and the keys above it to the output list),
// and the rounds go on there. The keys at or above the k-th are exactly
// k; they are sorted (select.cuh's bitonic sort) and written. Dynamic
// shared memory: the output list (npow2(k) keys), the live keys
// (TK_LIVE), the prefix (wpr + 1 words).
__global__ void __launch_bounds__(TK_TAKE_THREADS)
    topk_take_kernel(const __grid_constant__ TopkArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ unsigned s_hist[TK_BINS];
  __shared__ unsigned s_scan[TK_TAKE_THREADS];
  __shared__ unsigned s_n[2], s_pick[2];
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31;
  const long long row = blockIdx.x;
  const int k = a.k;
  int npow2 = 1;
  while (npow2 < k) npow2 <<= 1;
  u64* s_out = reinterpret_cast<u64*>(dyn);
  u64* s_live = s_out + npow2;
  unsigned* s_off = reinterpret_cast<unsigned*>(s_live + TK_LIVE);
  const int wpr = static_cast<int>(a.wpr);
  const unsigned* cnts = a.count + row * a.wpr;
  const u64* base = a.cand + row * a.wpr * a.part;

  // the parts' exclusive prefix: thread t sums parts [t·per, (t+1)·per)
  {
    const int per = (wpr + nth - 1) / nth;
    const int lo = tid * per < wpr ? tid * per : wpr;
    const int hi = lo + per < wpr ? lo + per : wpr;
    unsigned sum = 0;
    for (int i = lo; i < hi; ++i) sum += cnts[i];
    s_scan[tid] = sum;
    if (tid == 0) s_n[0] = s_n[1] = 0u;
    __syncthreads();
    for (int o = 1; o < nth; o <<= 1) {
      const unsigned x = tid >= o ? s_scan[tid - o] : 0u;
      __syncthreads();
      s_scan[tid] += x;
      __syncthreads();
    }
    unsigned run = s_scan[tid] - sum;
    for (int i = lo; i < hi; ++i) {
      s_off[i] = run;
      run += cnts[i];
    }
    if (tid == nth - 1) s_off[wpr] = s_scan[tid];
    __syncthreads();
  }
  const unsigned M = s_off[wpr];
  // candidate f: part p (the last with s_off[p] <= f), slot f - s_off[p]
  const auto cand_at = [&](unsigned f) {
    int lo = 0, hi = wpr;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_off[mid] <= f)
        lo = mid;
      else
        hi = mid;
    }
    return base[lo * a.part + (f - s_off[lo])];
  };
  constexpr int UT = 4;  // keys a thread has in flight
  const unsigned step = static_cast<unsigned>(nth) * UT;
  const unsigned wbase = static_cast<unsigned>(tid & ~31) * UT;

  u64 P = 0ull;
  int top = 64;
  unsigned rem = static_cast<unsigned>(k);
  bool live = false;  // the rounds run over s_live
  for (;;) {
    const int sh = top > TK_DIGIT ? top - TK_DIGIT : 0;
    const unsigned mask = (1u << (top - sh)) - 1u;
    for (int i = tid; i < TK_BINS; i += nth) s_hist[i] = 0u;
    __syncthreads();
    if (live) {
      const unsigned nl = s_n[1];
      for (unsigned i0 = wbase; i0 < nl; i0 += step) {
        for (int u = 0; u < UT; ++u) {
          const unsigned i = i0 + 32 * u + lane;
          unsigned bin = NONE;
          if (i < nl) {
            const u64 x = s_live[i];
            if (same_above(x, P, top))
              bin = static_cast<unsigned>(x >> sh) & mask;
          }
          warp_bin(s_hist, bin);
        }
      }
    } else {
      for (unsigned f0 = wbase; f0 < M; f0 += step) {
        u64 x[UT];
#pragma unroll
        for (int u = 0; u < UT; ++u) {
          const unsigned f = f0 + 32 * u + lane;
          x[u] = f < M ? cand_at(f) : 0ull;
        }
#pragma unroll
        for (int u = 0; u < UT; ++u) {
          const unsigned f = f0 + 32 * u + lane;
          warp_bin(s_hist, f < M && same_above(x[u], P, top)
                               ? static_cast<unsigned>(x[u] >> sh) & mask
                               : NONE);
        }
      }
    }
    __syncthreads();
    if (tid < 32) {
      unsigned gt;
      const unsigned b = warp_pick<TK_BINS / 32>(s_hist, rem, gt);
      if (tid == 0) {
        s_pick[0] = b;
        s_pick[1] = gt;
      }
    }
    __syncthreads();
    const unsigned bin = s_pick[0];
    const unsigned inb = s_hist[bin];
    P |= static_cast<u64>(bin) << sh;
    rem -= s_pick[1];
    top = sh;
    __syncthreads();
    if (inb == rem || top == 0) break;  // the keys >= P are k
    if (!live && inb <= TK_LIVE) {
      // the keys above P's bin are in; the bin's keys go on in shared
      // memory
      const u64 Pt = P >> top;
      for (unsigned f0 = wbase; f0 < M; f0 += step) {
        u64 x[UT];
#pragma unroll
        for (int u = 0; u < UT; ++u) {
          const unsigned f = f0 + 32 * u + lane;
          x[u] = f < M ? cand_at(f) : 0ull;
        }
#pragma unroll
        for (int u = 0; u < UT; ++u) {
          const bool in = f0 + 32 * u + lane < M;
          append(in && (x[u] >> top) > Pt, x[u], s_n, s_out);
          append(in && (x[u] >> top) == Pt, x[u], s_n + 1, s_live);
        }
      }
      live = true;
      __syncthreads();
    }
  }
  // every key >= P (its bits below top are 0) is in
  if (live) {
    const unsigned nl = s_n[1];
    for (unsigned i0 = wbase; i0 < nl; i0 += step)
      for (int u = 0; u < UT; ++u) {
        const unsigned i = i0 + 32 * u + lane;
        const u64 x = i < nl ? s_live[i] : 0ull;
        append(i < nl && x >= P, x, s_n, s_out);
      }
  } else {
    for (unsigned f0 = wbase; f0 < M; f0 += step) {
      u64 x[UT];
#pragma unroll
      for (int u = 0; u < UT; ++u) {
        const unsigned f = f0 + 32 * u + lane;
        x[u] = f < M ? cand_at(f) : 0ull;
      }
#pragma unroll
      for (int u = 0; u < UT; ++u)
        append(f0 + 32 * u + lane < M && x[u] >= P, x[u], s_n, s_out);
    }
  }
  __syncthreads();
  const int n_out = static_cast<int>(s_n[0]);  // k
  for (int i = tid; i < npow2; i += nth)
    s_out[i] = i < n_out ? ~s_out[i] : sel::NO_KEY;
  __syncthreads();
  sel::block_sort(s_out, npow2);
  for (int i = tid; i < k; i += nth) {
    const u64 key = ~s_out[i];
    const uint32_t u = static_cast<uint32_t>(key >> 32);
    a.vals[row * k + i] =
        __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
    a.idx[row * k + i] = static_cast<int>(~static_cast<uint32_t>(key));
  }
}

// ---------------------------------------------------------- radix regime

// The key of column j of `row`, as tk_key.
__device__ __forceinline__ u64 load_key(const TopkArgs& a, long long row,
                                        int need, long long j) {
  const long long off = row * a.ncols + j;
  bool ok = true;
  if (a.hits_kind && need > 0)
    ok = hit_ok(a.hits_kind, need,
                static_cast<const uint32_t*>(a.hits)[off]);
  return tk_key(a.scores[off], ok, j);
}

__global__ void topk_rinit_kernel(const __grid_constant__ TopkArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < a.rows * ST_SLOTS)
    a.state[i] = i % ST_SLOTS == ST_REMAINING ? a.k : 0;
  if (i < a.rows * 256) a.hist[i] = 0u;
  if (i < a.rows) a.rcount[i] = 0u;
}

// Histogram of the 8-bit digit at `shift` over the keys whose higher bits
// equal the row's prefix found so far; block b is chunk b % nchunk of row
// b / nchunk.
__global__ void topk_hist_kernel(const __grid_constant__ TopkArgs a,
                                 int shift) {
  const long long row = blockIdx.x / a.nchunk;
  const long long* st = a.state + row * ST_SLOTS;
  if (st[ST_DONE]) return;
  __shared__ unsigned h[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const u64 prefix = static_cast<u64>(st[ST_PREFIX]);
  const int hi = shift + 8;
  const int need = a.hits_kind ? a.require[row] : 0;
  const long long begin = (blockIdx.x - row * a.nchunk) * TOPK_CHUNK;
  const long long end =
      begin + TOPK_CHUNK < a.ncols ? begin + TOPK_CHUNK : a.ncols;
  const int lane = threadIdx.x & 31;
  // warp-uniform trip count, so every lane reaches __match_any_sync
  for (long long j0 = begin + (threadIdx.x & ~31); j0 < end;
       j0 += blockDim.x) {
    const long long j = j0 + lane;
    unsigned digit = 256;  // no match
    if (j < end) {
      const u64 key = load_key(a, row, need, j);
      if (hi >= 64 || (key >> hi) == (prefix >> hi))
        digit = static_cast<unsigned>(key >> shift) & 0xFFu;
    }
    const unsigned peers = __match_any_sync(TK_FULL, digit);
    if (digit < 256 && lane == __ffs(peers) - 1)
      atomicAdd(&h[digit], static_cast<unsigned>(__popc(peers)));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    if (h[i]) atomicAdd(&a.hist[row * 256 + i], h[i]);
}

// Per row: pick the digit holding the k-th key, extend the prefix, and
// clear the histogram for the next pass.
__global__ void topk_select_kernel(const __grid_constant__ TopkArgs a,
                                   int shift) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (row >= a.rows) return;
  long long* st = a.state + row * ST_SLOTS;
  if (st[ST_DONE]) return;
  unsigned* h = a.hist + row * 256;
  long long rem = st[ST_REMAINING];
  int d = 255;
  for (; d > 0; --d) {
    if (static_cast<long long>(h[d]) >= rem) break;
    rem -= h[d];
  }
  u64 prefix = static_cast<u64>(st[ST_PREFIX]);
  prefix |= static_cast<u64>(d) << shift;
  st[ST_PREFIX] = static_cast<long long>(prefix);
  st[ST_NBITS] = 64 - shift;
  if (static_cast<long long>(h[d]) == rem) st[ST_DONE] = 1;
  st[ST_REMAINING] = rem;
  for (int i = 0; i < 256; ++i) h[i] = 0;
}

// Gather the keys whose known high bits are >= the selected prefix: exactly
// k keys a row, in no order, complemented (so the ascending levels of
// select.cuh sort them descending).
__global__ void topk_collect_kernel(const __grid_constant__ TopkArgs a) {
  const long long row = blockIdx.x / a.nchunk;
  const long long* st = a.state + row * ST_SLOTS;
  const int sh = 64 - static_cast<int>(st[ST_NBITS]);
  const u64 thr = static_cast<u64>(st[ST_PREFIX]) >> sh;
  const int need = a.hits_kind ? a.require[row] : 0;
  const long long begin = (blockIdx.x - row * a.nchunk) * TOPK_CHUNK;
  const long long end =
      begin + TOPK_CHUNK < a.ncols ? begin + TOPK_CHUNK : a.ncols;
  for (long long j = begin + threadIdx.x; j < end; j += blockDim.x) {
    const u64 key = load_key(a, row, need, j);
    if ((key >> sh) >= thr) {
      const unsigned pos = atomicAdd(&a.rcount[row], 1u);
      if (pos < static_cast<unsigned>(a.k)) a.rcand[row * a.k + pos] = ~key;
    }
  }
}

// Write the sorted (complemented) keys as (value, index).
__global__ void topk_write_kernel(const u64* __restrict__ cand, long long n,
                                  float* __restrict__ vals,
                                  int* __restrict__ idx) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const u64 key = ~cand[t];
  const uint32_t u = static_cast<uint32_t>(key >> 32);
  vals[t] = __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
  idx[t] = static_cast<int>(~static_cast<uint32_t>(key));
}

// ------------------------------------------------------------ the plan

long long round16(long long b) { return (b + 15) / 16 * 16; }

// The layout of one call's buffer: vals, idx, then the regime's scratch;
// sets the sizes and offsets in `a` (pointers relative to buf) and
// returns the bytes.
long long topk_plan(long long rows, long long ncols, int k, int one,
                    TopkArgs& a, char* buf) {
  a.rows = rows;
  a.ncols = ncols;
  a.k = k;
  long long off = 0;
  a.vals = reinterpret_cast<float*>(buf + off);
  off += rows * k * 4;
  a.idx = reinterpret_cast<int*>(buf + off);
  off = round16(off + rows * k * 4);
  if (one) {
    const long long nq = ncols / 4;
    long long wpr = sel::ceil_div(TK_TARGET_WARPS, rows);
    const long long most = nq / 32 > 1 ? nq / 32 : 1;  // 32 quads a warp
    a.wpr = wpr < most ? wpr : most;
    a.qw = sel::ceil_div(nq > 0 ? nq : 1, a.wpr);
    const long long m = 4 * a.qw + 8;  // the most keys a warp sees
    const long long want = 2LL * k + 256 > 256 ? 2LL * k + 256 : 256;
    a.part = want < m ? want : m;
    a.cand = reinterpret_cast<u64*>(buf + off);
    off += rows * a.wpr * a.part * 8;
    a.count = reinterpret_cast<unsigned*>(buf + off);
    off = round16(off + rows * a.wpr * 4);
  } else {
    a.nchunk = sel::ceil_div(ncols, TOPK_CHUNK);
    sel::level_caps(rows, k, 1, k, TOPK_SORT_FLOOR, a.cap_a, a.cap_b);
    a.state = reinterpret_cast<long long*>(buf + off);
    off += rows * ST_SLOTS * 8;
    a.rcand = reinterpret_cast<u64*>(buf + off);
    off += a.cap_a * 8;
    a.buf_b = reinterpret_cast<u64*>(buf + off);
    off += a.cap_b * 8;
    a.hist = reinterpret_cast<unsigned*>(buf + off);
    off += rows * 256 * 4;
    a.rcount = reinterpret_cast<unsigned*>(buf + off);
    off = round16(off + rows * 4);
  }
  return off;
}

size_t take_smem(const TopkArgs& a) {
  int npow2 = 1;
  while (npow2 < a.k) npow2 <<= 1;
  return static_cast<size_t>(npow2 + TK_LIVE) * 8 + (a.wpr + 1) * 4;
}

void topk_allow_smem() {
  static bool done = false;
  if (done) return;
  cudaFuncSetAttribute(topk_take_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (TK_ONE_LIMIT + TK_LIVE) * 8 +
                           (static_cast<int>(TK_TARGET_WARPS) + 1) * 4);
  done = true;
}

}  // namespace

// Four postings a thread. vec: bit j set when array j (tfs, dls, w, out)
// is 16-byte aligned.
__global__ void contrib_flat_kernel(const int* __restrict__ tfs,
                                    const int* __restrict__ dls,
                                    const float* __restrict__ w,
                                    const int* __restrict__ norms,
                                    long long n, int vec, int scorer,
                                    float k1, float b, float avg,
                                    float* __restrict__ out) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const bool whole = i + 4 <= n;
  int tf[4] = {0, 0, 0, 0}, dl[4] = {0, 0, 0, 0};
  float wt[4] = {0.f, 0.f, 0.f, 0.f};
  if (whole && (vec & 1)) {
    const int4 x = *reinterpret_cast<const int4*>(tfs + i);
    tf[0] = x.x, tf[1] = x.y, tf[2] = x.z, tf[3] = x.w;
  } else {
    for (int j = 0; j < 4 && i + j < n; ++j) tf[j] = tfs[i + j];
  }
  if (whole && (vec & 2)) {
    const int4 x = *reinterpret_cast<const int4*>(dls + i);
    dl[0] = x.x, dl[1] = x.y, dl[2] = x.z, dl[3] = x.w;
  } else {
    for (int j = 0; j < 4 && i + j < n; ++j) dl[j] = dls[i + j];
  }
  if (whole && (vec & 4)) {
    const float4 x = *reinterpret_cast<const float4*>(w + i);
    wt[0] = x.x, wt[1] = x.y, wt[2] = x.z, wt[3] = x.w;
  } else {
    for (int j = 0; j < 4 && i + j < n; ++j) wt[j] = w[i + j];
  }
  if (norms) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < n) dl[j] = norms[dl[j]];
  }
  float c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    c[j] = contrib(scorer, (float)tf[j], (float)dl[j], wt[j], k1, b, avg);
  if (whole && (vec & 8)) {
    *reinterpret_cast<float4*>(out + i) = make_float4(c[0], c[1], c[2], c[3]);
  } else {
    for (int j = 0; j < 4 && i + j < n; ++j) out[i + j] = c[j];
  }
}

static inline unsigned grid_for(long long threads, int block) {
  return (unsigned)((threads + block - 1) / block);
}

// ------------------------------------------------------------ match_bitmap

constexpr int MB_THREADS = 256;
constexpr int MB_WARPS = MB_THREADS / 32;
constexpr int MB_BLOCKS_SM = 4;     // the grid's cap, blocks an SM

struct MatchArgs {
  const int* base;
  const uint16_t* gaps;
  const uint8_t* tfs8;
  const int* row_idx;
  const int* raw_docs;
  const int* raw_idx;
  const int* tail;
  uint8_t* out;
  int n_rows, n_raw, n_tail, tail_vec, ndocs_pad;
};

// Warp task w: a packed row (w < n_rows), a raw row, then 128 tail docs;
// each lane takes 4 postings, every live doc in the bitmap sets its byte.
__global__ void __launch_bounds__(MB_THREADS)
    match_bitmap_kernel(const __grid_constant__ MatchArgs a) {
  const int lane = threadIdx.x & 31;
  {
    uint4* o = reinterpret_cast<uint4*>(a.out);
    const int nv = a.ndocs_pad >> 4;
    for (int i = blockIdx.x * MB_THREADS + threadIdx.x; i < nv;
         i += gridDim.x * MB_THREADS)
      o[i] = make_uint4(0, 0, 0, 0);
    if (blockIdx.x == 0 && threadIdx.x < (a.ndocs_pad & 15))
      a.out[(nv << 4) + threadIdx.x] = 0;
    cg::this_grid().sync();
  }
  const int tasks = a.n_rows + a.n_raw + ((a.n_tail + ROW - 1) / ROW);
  for (int w = blockIdx.x * MB_WARPS + (threadIdx.x >> 5); w < tasks;
       w += gridDim.x * MB_WARPS) {   // warp-uniform
    int d[4];
    if (w < a.n_rows) {
      int tfs[4];
      load_row<true>(a.base, a.gaps, a.tfs8, nullptr, nullptr, a.row_idx[w],
                     lane, d, tfs);
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = tfs[i] > 0 ? d[i] : -1;
    } else if (w < a.n_rows + a.n_raw) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          a.raw_docs + (long long)a.raw_idx[w - a.n_rows] * ROW + 4 * lane));
      d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
    } else {
      const int i0 = (w - a.n_rows - a.n_raw) * ROW + 4 * lane;
      if (a.tail_vec && i0 + 3 < a.n_tail) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(a.tail + i0));
        d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          d[i] = i0 + i < a.n_tail ? a.tail[i0 + i] : -1;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d[i] >= 0 && d[i] < a.ndocs_pad) a.out[d[i]] = 1;
  }
}

static int mb_grid_cap() {
  static int caps[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& cap = caps[dev & 15];
  if (!cap) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  match_bitmap_kernel,
                                                  MB_THREADS, 0);
    cap = (sms > 0 ? sms : 1) *
          (per_sm < MB_BLOCKS_SM ? (per_sm > 0 ? per_sm : 1) : MB_BLOCKS_SM);
  }
  return cap;
}

extern "C" {

// The match bitmap out (ndocs_pad bytes) of the packed rows row_idx, the
// raw rows raw_idx and the tail docs: one cooperative launch.
int match_bitmap(const void* base, const void* gaps, const void* tfs8,
                 const void* row_idx, long long n_rows, const void* raw_docs,
                 const void* raw_idx, long long n_raw, const void* tail_docs,
                 long long n_tail, long long ndocs_pad, void* out,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long tasks = n_rows + n_raw + (n_tail + ROW - 1) / ROW;
  if (n_rows < 0 || n_raw < 0 || n_tail < 0 || ndocs_pad < 0 ||
      tasks > 0x7FFFFFFFll || n_tail > 0x7FFFFFFFll ||
      ndocs_pad > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  MatchArgs a;
  a.base = (const int*)base;
  a.gaps = (const uint16_t*)gaps;
  a.tfs8 = (const uint8_t*)tfs8;
  a.row_idx = (const int*)row_idx;
  a.raw_docs = (const int*)raw_docs;
  a.raw_idx = (const int*)raw_idx;
  a.tail = (const int*)tail_docs;
  a.out = (uint8_t*)out;
  a.n_rows = (int)n_rows;
  a.n_raw = (int)n_raw;
  a.n_tail = (int)n_tail;
  a.tail_vec = ((uintptr_t)tail_docs & 15) == 0;
  a.ndocs_pad = (int)ndocs_pad;
  const long long cap = mb_grid_cap();
  const long long zero = ((ndocs_pad >> 4) + MB_THREADS - 1) / MB_THREADS;
  long long grid = (tasks + MB_WARPS - 1) / MB_WARPS;
  grid = grid > zero ? grid : zero;
  grid = grid < 1 ? 1 : (grid < cap ? grid : cap);
  void* args[] = {&a};
  cudaLaunchCooperativeKernel((const void*)match_bitmap_kernel,
                              dim3((unsigned)grid), dim3(MB_THREADS), args, 0,
                              s);
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

// Bytes of topk_rows' one buffer for a (rows, ncols) plane at k, in the
// one-read regime (one != 0) or the radix regime: the outputs, then the
// scratch; every word of it that the call reads, the call sets.
long long topk_bytes(long long rows, long long ncols, int k, int one) {
  TopkArgs a{};
  char base[16];  // the offsets alone are wanted
  return topk_plan(rows, ncols, k, one, a, base);
}

// Top-k of every row of a (rows, ncols) f32 plane by (score desc, index
// asc), the scores zeroed where hits < require[row] (require > 0; hits
// int32 for hits_kind 1, f32 for 2, none for 0). buf (topk_bytes) is
// unset; vals (rows, k) f32 and idx (rows, k) i32 are its first bytes.
// The one-read regime (one != 0, k <= 8,192): two launches, pass 0 and
// TAKE. The radix regime (any k up to ncols): an init launch, up to
// eight histogram/select pairs over the plane, a collect pass, the
// levels of select.cuh and a write.
int topk_rows(const void* scores, long long rows, long long ncols,
              const void* hits, int hits_kind, const void* require, int k,
              int one, void* buf, void* stream) {
  if (k < 1 || k > ncols || rows < 1 || (one && k > TK_ONE_LIMIT))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TopkArgs a{};
  topk_plan(rows, ncols, k, one, a, static_cast<char*>(buf));
  a.scores = static_cast<const float*>(scores);
  a.hits = hits_kind ? hits : nullptr;
  a.require = static_cast<const int*>(require);
  a.hits_kind = hits_kind;
  a.vec = !hits_kind || (reinterpret_cast<uintptr_t>(scores) -
                         reinterpret_cast<uintptr_t>(hits)) % 16 == 0;
  if (one) {
    if (a.wpr > TK_TARGET_WARPS) return (int)cudaErrorInvalidValue;
    topk_allow_smem();
    topk_pass0_kernel<<<grid_for(rows * a.wpr, TK_WARPS), TK_THREADS, 0,
                        s>>>(a);
    topk_take_kernel<<<(unsigned)rows, TK_TAKE_THREADS, take_smem(a), s>>>(
        a);
    return (int)cudaGetLastError();
  }
  const long long init = rows * 256 > rows * ST_SLOTS ? rows * 256
                                                      : rows * ST_SLOTS;
  topk_rinit_kernel<<<grid_for(init, 256), 256, 0, s>>>(a);
  const unsigned grid = (unsigned)(rows * a.nchunk);
  for (int shift = 56; shift >= 0; shift -= 8) {
    topk_hist_kernel<<<grid, TOPK_THREADS, 0, s>>>(a, shift);
    topk_select_kernel<<<grid_for(rows, 128), 128, 0, s>>>(a, shift);
  }
  topk_collect_kernel<<<grid, TOPK_THREADS, 0, s>>>(a);
  const u64* sorted = sel::levels(a.rcand, a.cap_a, a.buf_b, a.cap_b, rows,
                                  k, 1, k, TOPK_SORT_FLOOR, s);
  if (!sorted) return (int)cudaErrorInvalidValue;
  topk_write_kernel<<<grid_for(rows * k, 256), 256, 0, s>>>(
      sorted, rows * k, a.vals, a.idx);
  return (int)cudaGetLastError();
}

// Per-posting contributions of n flat postings (int32 tfs and dls, f32 w)
// into out (n f32). With norms (int32, the resident doc lengths) non-null,
// dls holds doc ids and each posting's dl is norms[dls[i]].
int contrib_flat(const void* tfs, const void* dls, const void* w,
                 const void* norms, long long n, int scorer, float k1,
                 float b, float avg, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int vec = (((size_t)tfs & 15) == 0) |
                  (((size_t)dls & 15) == 0) << 1 |
                  (((size_t)w & 15) == 0) << 2 |
                  (((size_t)out & 15) == 0) << 3;
  contrib_flat_kernel<<<grid_for((n + 3) / 4, 256), 256, 0,
                        (cudaStream_t)stream>>>(
      (const int*)tfs, (const int*)dls, (const float*)w, (const int*)norms, n,
      vec, scorer, k1, b, avg, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
