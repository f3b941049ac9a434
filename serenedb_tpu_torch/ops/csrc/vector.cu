// Vector kernels for Hopper (sm_90a), with a plain C interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; each entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrappers, the scratch sizing and the
// plain PyTorch version of each kernel live in ops/vector_kernels.py.
//
// Every distance is the reference's `dist_tail_expr`
// (serenedb_tpu/ops/vector.py:75): a left-to-right f32 chain over the
// padded width dp, each product and sum rounded on its own (__fmul_rn /
// __fadd_rn are never contracted into an fma; the build adds -fmad=false
// besides), sqrt and division IEEE-rounded, then `+ 0.0`. So a distance has
// the bits of `ops.vector.host_dist` and of the plain version, and trailing
// zero-padded dimensions add exactly 0.
//
// Selection is exact and takes no atomics. Each candidate gets one 64-bit
// key: the ascending order-preserving image of its f32 (-0.0 made +0.0,
// every NaN one canonical NaN above +inf) in the high word and its row in
// the low word, so key order is (value asc, row asc): the reference's
// two-key `lax.sort` order. The levels of select.cuh keep each query's
// kkp smallest, for any kkp. Dead lanes carry (+inf, 2^31-1) as the
// reference's carry does; the reference starts its carry with K such
// entries, so a NaN distance never reaches the output: keys above the dead
// key are written out as the dead key.
//
// 1. ivf_probe
//    Replaces serenedb_tpu/ops/vector.py `probe_program` (:204), and with
//    one all-rows list the brute oracle (search/vector_store.py:454).
//    Stage 1: each query's lists are keyed (list_image of the centroid
//    distance, the list id; lists at or past l_real read +inf) and the
//    nprobe nearest kept in `lax.top_k(-d)` order (NaN first, then
//    distance asc, list asc). Stage 2 scores the rows the probed lists
//    hold, and keeps the kkp smallest (distance, row) keys.
//    Bound: bytes — the probed lists' rows (dp floats each, read once a
//    query), ~8 MB a query at `sift`'s nprobe 16; the centroids are 0.5 MB
//    a query. Design (in place of a thread a probe-grid lane, the grid
//    nprobe x the largest list, rows read a float at a time, and 5-6
//    launches):
//    - Both stages (`ivf_lists_kernel`, `ivf_rows_kernel`) run one block
//      code, `probe_stage`: 128 threads, a thread one row of a 128-row
//      tile. A block takes a query's tiles j, j + blocks, ... (stage 2 at
//      about 2,048 blocks a call), and while one tile is scored the next
//      one's rows are located and its first slab is on its way. A tile's
//      rows come into shared memory a 32-dim slab at a time, whole rows
//      by cp.async (16 bytes a lane, one float where dp % 4 != 0),
//      double-buffered, so any dp streams in d order; each thread runs
//      its row's chain from shared memory, four dims a float4. 32-dim
//      slabs keep a block to ~40 KB of shared memory, five blocks an SM
//      (scripts/probe_variants.py: 64 and 128 dims were slower).
//    - Stage 2 walks only live rows: row g of a query is the list t with
//      pre[t] <= g < pre[t + 1] (pre the exclusive prefix of the probed
//      lists' counts), position offsets[list] + g - pre[t]; blocks past
//      a query's live rows leave at once. The probe grid's maps are not
//      read: keys are (distance image, unique row id), so the order rows
//      are scored in cannot move a bit.
//    - Selection: each tile's keys are sorted by warp (shuffles) and
//      merged (merge path in shared memory) into the block's running
//      smallest, unless none is below its last; the block writes them to
//      scratch. Stage 2's blocks read stage 1's candidates and merge them
//      themselves (the probe table in shared memory; stage 1 resets
//      stage 2's tickets, so no memset is launched). The last block of
//      each group of up to 32 blocks (a ticket) merges the group's
//      candidates, and the last group's merger (a ticket a query) the
//      group runs, and writes the outputs, keys above the dead key
//      written as it. Where a stage's candidates pass one block's merges
//      (PR_CAP keys) the select.cuh levels take them, then
//      `lists_finish_kernel` (the probe table) or `keys_finish_kernel`.
//    - Blocks go query-minor (blockIdx = chunk * qp + query): the blocks
//      on the card at once are one chunk of many queries, so the brute
//      layout's queries share each tile in L2.
//    The main path's calls are 2 launches, no copy in, one scratch buffer
//    (`probe_bytes`).
// 2. maxsim
//    Replaces `maxsim_program` (:272). Per (pair, doc token), pair p being
//    (query p / sp, query token p % sp): part = x[i0]·q[i0], then part +
//    x[d]·q[d] for d = i0+1 .. i0+tile-1, acc + part over the dim tiles in
//    order from acc = 0 (each product and sum rounded on its own); each
//    pair's max over a doc's tokens (NaN propagates; ±0 ties cannot change
//    a key); a query's score 0 + m[0] + m[1] + ... in s order; key =
//    -score + 0.0, empty and pad docs +inf. Then the selection.
//    Bound: operations — B*S*T*dp multiply-adds, two FP32 instructions
//    each (the build's -fmad=false keeps them apart; tensor cores round
//    otherwise), ~20.7 ms at the `colbert` batch. Design:
//    `maxsim_tiles_kernel` is register-tiled SIMT. A block holds 128 pairs
//    (in shared memory for its whole life at widths up to 128, else
//    brought a 64-dim slab at a time) and is persistent over chunks of 32
//    doc lanes; the chunk's tokens stream, across doc boundaries, through
//    64-token tiles of shared memory (cp.async through the slot map,
//    double-buffered); each thread keeps 8 pairs x 4 tokens = 32
//    independent chains in registers, reading x and q as float4 along d.
//    The segmented max stays in registers (a butterfly over the 16
//    threads that hold a pair group's tokens), written to a (lane, pair)
//    scratch when each doc ends; `maxsim_score_kernel` sums each
//    query's pairs in s order and keys the doc. Shared memory does not
//    grow with the doc length or the width; the scratch holds a range of
//    lanes (the wrapper's byte budget), and both kernels run range by
//    range.
// 3. kmeans_assign
//    Replaces `_assign_program` (:187) and the argmin of `_kmeans_program`
//    (:157), less the x·cᵀ product, which the wrapper takes from
//    torch.matmul (TF32 off): d = (‖x‖² − 2·xc) + ‖c‖² in the reference's
//    order (the norms as chains), argmin over centroids with the lowest
//    index on ties and the first NaN winning, as jnp.argmin. One warp a row.
//    Bound: bytes — the (N, K) product is read once.
// 4. kmeans_update
//    Replaces the centroid update of `_kmeans_program` (the one-hot product
//    `einsum(one_hot, x)` and its counts): a stable counting sort of the
//    row ids by cluster, then per-cluster sums in chunks of KM_CHUNK sorted
//    rows. The add order is fixed by the assignment and KM_CHUNK alone,
//    never by the grid: within a chunk the rows in row order from +0.0,
//    then each cluster's chunk sums in chunk order; centroid = sum / count
//    (IEEE-rounded), or the old centroid where the count is 0. Four
//    launches, no atomics on floats, no (blocks, K, D) planes, and every
//    word of scratch set by the kernels (one buffer, `kmeans_bytes`):
//    - hist: warp w counts the clusters of its KM_RANGE rows (a histogram
//      in shared memory while K <= KM_SMEM_K, else its own row of the
//      table in device memory) and writes its row of the (warps, K) table;
//    - prefix: per cluster the exclusive prefix over the warps (in place)
//      and the count; the last block (an atomic ticket) scans the counts
//      into each cluster's first sorted slot, first chunk and first slot
//      of partial sums; empty clusters copy their old centroid;
//    - scatter: each warp walks its rows again and writes each row id to
//      its slot (ranks among equal clusters by __match_any_sync), so the
//      rows of a cluster stay in row order;
//    - chunk: one warp a (cluster, chunk) (found by a binary search over
//      the chunk starts); a lane owns four dimensions (one float4 of a
//      row, eight rows' loads in flight) or, where D % 4 != 0 or x is not
//      16-byte aligned, one; a one-chunk cluster writes its centroid, a
//      longer one its chunk sum, and the last of its warps to finish (a
//      ticket per cluster) folds the chunk sums in order. A dependent add
//      chain is at most KM_CHUNK rows, whatever the skew.
//    Bound: bytes — x read once (plus four passes over the assignment).

#include "select.cuh"

namespace {

using sel::u64;

constexpr int STAGE_FLOOR = 2048;  // smallest tile of the selection levels
// maxsim: a block holds MS_PB (query, query token) pairs and streams doc
// tokens in tiles of MS_TT; each thread a register micro-tile of MS_P
// pairs x MS_T tokens (16 x 16 threads); widths past MS_ONE_SLAB stream
// dims in slabs of MS_DS; doc lanes go to blocks in chunks of MS_LC
constexpr int MS_THREADS = 256;
constexpr int MS_PB = 128, MS_TT = 64, MS_P = 8, MS_T = 4;
constexpr int MS_ONE_SLAB = 128, MS_DS = 64, MS_LC = 32;
constexpr int MS_PAD = 4;  // row padding (floats): no bank conflicts
constexpr int M_L2 = 0, M_IP = 1, M_COS = 2;
constexpr uint32_t PAD_ROW = 0x7FFFFFFFu;
constexpr u64 DEAD = (static_cast<u64>(0xFF800000u) << 32) | PAD_ROW;
constexpr u64 NO_KEY = sel::NO_KEY;  // tile padding: above every real key

// Ascending image: -0.0 ties +0.0, NaN sorts after +inf.
__device__ __forceinline__ uint32_t asc_image(float f) {
  uint32_t b = __float_as_uint(f);
  if (b == 0x80000000u) b = 0u;
  if ((b & 0x7F800000u) == 0x7F800000u && (b & 0x7FFFFFu)) b = 0x7FC00000u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The probe-list image: as asc_image, but NaN first (lax.top_k on -d puts
// NaN above everything).
__device__ __forceinline__ uint32_t list_image(float f) {
  return f != f ? 0u : asc_image(f);
}

__device__ __forceinline__ float from_image(uint32_t img) {
  const uint32_t b = (img & 0x80000000u) ? (img & 0x7FFFFFFFu) : ~img;
  return __uint_as_float(b);
}

__device__ __forceinline__ u64 make_key(uint32_t hi, uint32_t lo) {
  return (static_cast<u64>(hi) << 32) | lo;
}

// NaN-propagating max, as jnp.maximum / torch.maximum.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------- ivf_probe

// One dim of dist_tail_expr's chain: the first dim opens it (FIRST), every
// later one adds to it; (a, b, c) = acc (l2, ip) or (xx, qq, dot) (cos).
template <int M, bool FIRST>
__device__ __forceinline__ void chain_dim(float x, float q, float& a,
                                          float& b, float& c) {
  if (M == M_L2) {
    const float dv = __fsub_rn(x, q);
    a = FIRST ? __fmul_rn(dv, dv) : __fadd_rn(a, __fmul_rn(dv, dv));
  } else if (M == M_IP) {
    a = FIRST ? __fmul_rn(x, q) : __fadd_rn(a, __fmul_rn(x, q));
  } else {
    a = FIRST ? __fmul_rn(x, x) : __fadd_rn(a, __fmul_rn(x, x));
    b = FIRST ? __fmul_rn(q, q) : __fadd_rn(b, __fmul_rn(q, q));
    c = FIRST ? __fmul_rn(x, q) : __fadd_rn(c, __fmul_rn(x, q));
  }
}

// The chain's end, then + 0.0.
template <int M>
__device__ __forceinline__ float chain_end(float a, float b, float c) {
  if (M == M_L2) return __fadd_rn(a, 0.0f);
  if (M == M_IP) return __fadd_rn(-a, 0.0f);
  const float den = nan_max(__fmul_rn(__fsqrt_rn(a), __fsqrt_rn(b)), 1e-9f);
  return __fadd_rn(__fsub_rn(1.0f, __fdiv_rn(c, den)), 0.0f);
}

// w dims of one row's chain from shared memory, the row x and the query
// slab q; `first`: this slab holds dim 0.
template <int M, bool VEC>
__device__ __forceinline__ void chain_slab(const float* x, const float* q,
                                           int w, bool first, float& a,
                                           float& b, float& c) {
  int d = 0;
  if (VEC) {
    if (first) {
      const float4 xv = *reinterpret_cast<const float4*>(x);
      const float4 qv = *reinterpret_cast<const float4*>(q);
      chain_dim<M, true>(xv.x, qv.x, a, b, c);
      chain_dim<M, false>(xv.y, qv.y, a, b, c);
      chain_dim<M, false>(xv.z, qv.z, a, b, c);
      chain_dim<M, false>(xv.w, qv.w, a, b, c);
      d = 4;
    }
#pragma unroll 4
    for (; d < w; d += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(x + d);
      const float4 qv = *reinterpret_cast<const float4*>(q + d);
      chain_dim<M, false>(xv.x, qv.x, a, b, c);
      chain_dim<M, false>(xv.y, qv.y, a, b, c);
      chain_dim<M, false>(xv.z, qv.z, a, b, c);
      chain_dim<M, false>(xv.w, qv.w, a, b, c);
    }
  } else {
    if (first) {
      chain_dim<M, true>(x[0], q[0], a, b, c);
      d = 1;
    }
#pragma unroll 4
    for (; d < w; ++d) chain_dim<M, false>(x[d], q[d], a, b, c);
  }
}

// The probe's blocks: PR_T threads, one row of a tile of PR_T rows each;
// a tile comes into shared memory a slab of PR_DS dims at a time
// (double-buffered cp.async).
constexpr int PR_T = 128;
constexpr int PR_DS = 32;
constexpr int PR_KEEP_MAX = 256;  // keys a block keeps over 2+ tiles
constexpr int PR_CAP = 4096;      // candidates one block merges
constexpr int PR_GROUP = 32;      // stage 2: blocks a group merges at most
constexpr int PR_TARGET = 2048;   // stage 2: blocks a call, about
// the most dynamic shared memory a stage block takes: two stage buffers at
// the widest slab and the tile merge's two buffers, then a probe table of
// PR_CAP lists
constexpr int PR_SMEM_MAX = 2 * (PR_T * (PR_DS + 4) + PR_DS) * 4 +
                            2 * 2 * PR_KEEP_MAX * 8 + PR_CAP * 4 +
                            (PR_CAP + 1) * 8;

// One stage's blocks a query: block j of `blocks` takes the query's tiles
// of PR_T rows j, j + blocks, ... (at most `tpb`), keeping its `keep`
// smallest keys. Fused stage 1: each stage 2 block merges every stage 1
// block's keys (at most PR_CAP). Fused stage 2: the last block of each
// group of `group` blocks merges the group's keys to K, and the last
// group's merger merges the `groups` group runs (each merge at most
// PR_CAP keys). Else (one tile a block) select.cuh's levels take them.
struct StagePlan {
  int fused, tpb, keep, group;
  long long blocks, groups;
};

// The most keys `merge_runs` holds in one of its two buffers, for nruns
// runs of `run` keys cut to K.
long long merge_span(long long nruns, long long run, long long K) {
  long long most = nruns * run;
  while (nruns > 1) {
    nruns = (nruns + 1) / 2;
    run = 2 * run < K ? 2 * run : K;
    most = nruns * run > most ? nruns * run : most;
  }
  return most;
}

// A block's running best over one tile: its kpad keys and the tile's
// PR_T, in runs of 32, cut to keep.
long long tile_span(long long keep) {
  return merge_span((keep + 31) / 32 + PR_T / 32, 32, keep);
}

// Stage 1 (`qp` 0): the fewest blocks a query whose keys one block
// merges. Stage 2: blocks enough for PR_TARGET a call (no more than the
// tiles), halved while the merges do not fit.
StagePlan stage_plan(long long n, long long K, long long qp) {
  const long long b = sel::ceil_div(n < 1 ? 1 : n, PR_T);
  long long nb = qp ? sel::ceil_div(PR_TARGET, qp) : b;
  nb = nb < b ? nb : b;
  for (;; nb = sel::ceil_div(nb, 2)) {
    const long long tpb = sel::ceil_div(b, nb);
    const long long keep = K < PR_T * tpb ? K : PR_T * tpb;
    if (tpb > 1 && keep > PR_KEEP_MAX) break;
    long long g = nb, ng = 1;
    if (qp) {
      g = PR_GROUP;
      while (g > 1 && merge_span(g, keep, K) > PR_CAP) g >>= 1;
      g = g < nb ? g : nb;
      ng = sel::ceil_div(nb, g);
    }
    if (merge_span(g, keep, K) <= PR_CAP && merge_span(ng, K, K) <= PR_CAP)
      return {1, static_cast<int>(tpb), static_cast<int>(keep),
              static_cast<int>(g), nb, ng};
    if (nb == 1) break;
  }
  return {0, 1, static_cast<int>(K < PR_T ? K : PR_T), 1, b, 1};
}

inline long long align16(long long b) { return (b + 15) / 16 * 16; }

// The call's one scratch buffer: stage 1's candidates (and its levels'
// first buffer), stage 2's, the levels' second buffer, the probe table
// (list ids and the exclusive prefix of their counts; only when stage 1
// takes the levels), stage 2's group runs and its tickets.
// ops/vector_kernels.py `probe_plan` mirrors it.
struct ProbeLayout {
  StagePlan s1, s2;
  long long cap_a1, cap_a2, cap_b, grp;
  long long off_c2, off_b, off_ids, off_pre, off_grp, off_ticket, bytes;
};

ProbeLayout probe_layout(long long qp, long long lp, long long nprobe,
                         long long nlanes, long long kkp) {
  ProbeLayout L{};
  L.s1 = stage_plan(lp, nprobe, 0);
  L.s2 = stage_plan(nlanes, kkp, qp);
  long long cb1 = 0, cb2 = 0;
  const long long n1 = L.s1.blocks * L.s1.keep, n2 = L.s2.blocks * L.s2.keep;
  if (L.s1.fused)
    L.cap_a1 = qp * n1;
  else
    sel::level_caps(qp, n1, L.s1.keep, nprobe, STAGE_FLOOR, L.cap_a1, cb1);
  if (L.s2.fused)
    L.cap_a2 = qp * n2;
  else
    sel::level_caps(qp, n2, L.s2.keep, kkp, STAGE_FLOOR, L.cap_a2, cb2);
  L.cap_b = cb1 > cb2 ? cb1 : cb2;
  const long long table = L.s1.fused ? 0 : qp * nprobe;
  L.off_c2 = align16(L.cap_a1 * 8);
  L.off_b = align16(L.off_c2 + L.cap_a2 * 8);
  L.off_ids = align16(L.off_b + L.cap_b * 8);
  L.off_pre = align16(L.off_ids + table * 4);
  L.grp = L.s2.fused && L.s2.groups > 1 ? qp * L.s2.groups * kkp : 0;
  L.off_grp = align16(L.off_pre + (table ? table + qp : 0) * 8);
  L.off_ticket = align16(L.off_grp + L.grp * 8);
  // stage 2's tickets: a query's groups', then its own
  L.bytes = align16(L.off_ticket + qp * (L.s2.groups + 1) * 4);
  return L;
}

struct PrArgs {
  const float* rows;  // stage 1: the centroids; stage 2: the region
  const int* slotmap;
  const int* offsets;
  const int* counts;
  const int* rowids;
  const float* queries;
  const u64* cand1;   // stage 1's candidates (fused stage 1)
  const int* ids;     // the probe table (stage 1 through the levels)
  const long long* pre;
  u64* cand;          // this stage's candidates
  u64* grp;           // stage 2's group runs (qp, groups, kkp)
  unsigned* ticket;   // (qp, groups + 1) stage 2's tickets
  float* out_dist;
  int* out_rows;
  long long blocks;   // this stage's blocks a query
  int qp, dp, lp, l_real, nprobe, kkp, metric;
  int keep, fused;       // this stage
  int group, groups;     // stage 2's (stage 1 resets its tickets)
  int b1, keep1, fused1;
  // keys of one merge buffer: the block's tile merge, stage 1's candidates
  // (fused stage 1), a group's and the groups' merges (fused stage 2)
  int span_tile, span1, span_g, span2;
  int sel_off;        // bytes of dynamic shared memory before the tile merge's
  int table_off;      // ... and before the table
};

// Index of the first key of the sorted run r (n keys) that is >= v
// (upper: > v).
__device__ __forceinline__ int rank_of(const u64* r, int n, u64 v,
                                       bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (upper ? r[mid] <= v : r[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Pairwise merges of `nruns` sorted runs of `run` keys, back to back at a,
// until one is left, each merged run cut to min(2 run, K); the block
// ping-pongs between a and b (each as large as the input). Keys of the
// first run of a pair go before equal keys of the second (merge path, as
// sel::merge_kernel). The input must be visible (after a barrier). Returns
// the buffer holding the run; `len` its keys.
__device__ u64* merge_runs(u64* a, u64* b, int nruns, int run, int K,
                           int& len) {
  while (nruns > 1) {
    const int np = (nruns + 1) >> 1;
    const int run2 = 2 * run < K ? 2 * run : K;
    for (int e = threadIdx.x; e < np * 2 * run; e += blockDim.x) {
      const int p = e / (2 * run), i = e - p * 2 * run;
      const u64* ra = a + 2 * p * run;
      const bool hb = 2 * p + 1 < nruns;
      u64 v;
      int pos;
      if (i < run) {
        v = ra[i];
        pos = i + (hb ? rank_of(ra + run, run, v, false) : 0);
      } else {
        v = hb ? ra[i] : NO_KEY;
        pos = (i - run) + (hb ? rank_of(ra, run, v, true) : run);
      }
      if (pos < run2) b[p * run2 + pos] = v;
    }
    __syncthreads();
    u64* t = a;
    a = b;
    b = t;
    nruns = np;
    run = run2;
  }
  len = run;
  return a;
}

// Ascending bitonic sort of one key a lane across the warp.
__device__ __forceinline__ u64 warp_sort(u64 key) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const u64 o = __shfl_xor_sync(0xFFFFFFFFu, key, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      key = keep_min ? (o < key ? o : key) : (o > key ? o : key);
    }
  return key;
}

// Exclusive prefix of counts[ids[t]] over t < n into pre[0..n] (pre[n]
// the total); the whole block takes part. ids and pre in shared or
// device memory.
__device__ void probe_prefix(const int* ids, const int* __restrict__ counts,
                             int n, long long* pre) {
  __shared__ long long s_warp[PR_T / 32];
  __shared__ long long s_carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n; t0 += PR_T) {
    const int t = t0 + threadIdx.x;
    const long long v = t < n ? counts[ids[t]] : 0;
    long long incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    long long base = s_carry;
    for (int w = 0; w < warp; ++w) base += s_warp[w];
    if (t < n) pre[t] = base + incl - v;
    __syncthreads();
    if (threadIdx.x == PR_T - 1) s_carry = base + incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) pre[n] = s_carry;
}

// A stage of ivf_probe. Block (chunk, query) = blockIdx.x as chunk * qp +
// query, so the blocks on the card at once are one chunk of many queries
// (the brute layout's queries share their rows in L2). A block takes the
// query's tiles of PR_T rows chunk, chunk + blocks, ...; while one tile
// is scored the next one's rows are located and its first slab is on its
// way.
// Stage 1 keys lists (a tile's rows are lists): list_image(distance) for
// lists below l_real (+inf past it), the list id as the low word.
// Stage 2 first takes the probe table (merging stage 1's candidates in
// shared memory, or reading the levels' table), then keys the query's live
// rows, the concatenation of its probed lists in probe order (row g: the
// list t with pre[t] <= g < pre[t + 1], position offsets[list] + g -
// pre[t]): asc_image(distance), the row id. Blocks past a query's live
// tiles leave at once.
// Each tile's keys are sorted by warp and merged into the block's running
// `keep` smallest. Then the block writes them to its candidates; fused
// stage 2 then merges by groups (the epilogue below) and writes the kkp
// outputs (keys past the dead key as it).
template <int STAGE, bool VEC>
__device__ __forceinline__ void probe_stage(const PrArgs& a) {
  extern __shared__ __align__(16) unsigned char pr_smem[];
  __shared__ long long s_slot[2][PR_T];
  __shared__ u64 s_best[PR_KEEP_MAX];
  __shared__ bool s_last;
  float* fsm = reinterpret_cast<float*>(pr_smem);
  u64* ksm = reinterpret_cast<u64*>(pr_smem);
  const int tid = threadIdx.x;
  const int q = static_cast<int>(blockIdx.x % a.qp);
  const long long chunk = blockIdx.x / a.qp;
  const int dp = a.dp;
  const float* qrow = a.queries + static_cast<long long>(q) * dp;

  // stage 1 resets stage 2's tickets for this call
  if (STAGE == 1)
    for (long long t = chunk * PR_T + tid; t <= a.groups;
         t += a.blocks * PR_T)
      a.ticket[static_cast<long long>(q) * (a.groups + 1) + t] = 0u;

  // the probe table and the live total
  const int* ids = nullptr;
  const long long* pre = nullptr;
  long long total = a.lp;
  if (STAGE == 2) {
    if (a.fused1) {
      const int n1 = a.b1 * a.keep1;
      const u64* src = a.cand1 + static_cast<long long>(q) * n1;
      for (int i = tid; i < n1; i += PR_T) ksm[i] = src[i];
      __syncthreads();
      int len;
      const u64* run = merge_runs(ksm, ksm + a.span1, a.b1, a.keep1,
                                  a.nprobe, len);
      int* s_ids = reinterpret_cast<int*>(pr_smem + a.table_off);
      long long* s_pre = reinterpret_cast<long long*>(
          pr_smem + a.table_off + (a.nprobe * 4 + 7) / 8 * 8);
      for (int t = tid; t < a.nprobe; t += PR_T)
        s_ids[t] = static_cast<int>(run[t] & 0xFFFFFFFFull);
      __syncthreads();
      probe_prefix(s_ids, a.counts, a.nprobe, s_pre);
      __syncthreads();
      ids = s_ids;
      pre = s_pre;
    } else {
      ids = a.ids + static_cast<long long>(q) * a.nprobe;
      pre = a.pre + static_cast<long long>(q) * (a.nprobe + 1);
    }
    total = pre[a.nprobe];
  }
  // the block's tiles of PR_T rows: chunk, chunk + blocks, ... below the
  // live ones (total <= blocks * tpb * PR_T: the lanes bound a query's
  // live rows)
  const long long ntiles = (total + PR_T - 1) / PR_T;
  long long nwork = ntiles < a.blocks ? ntiles : a.blocks;
  nwork = nwork > 0 ? nwork : 1;
  if (chunk >= nwork) {
    if (!a.fused) {
      u64* dst = a.cand + (static_cast<long long>(q) * a.blocks + chunk) *
                              a.keep;
      for (int i = tid; i < a.keep; i += PR_T) dst[i] = NO_KEY;
    }
    return;
  }

  const int keep = a.keep;
  const int kpad = (keep + 31) / 32 * 32;
  for (int i = tid; i < kpad; i += PR_T) s_best[i] = NO_KEY;
  u64* tsel = reinterpret_cast<u64*>(pr_smem + a.sel_off);

  const int ds = dp < PR_DS ? dp : PR_DS;
  const int ns = (dp + ds - 1) / ds;
  const int rs = ds + (VEC ? 4 : 1);
  const int stage_floats = PR_T * rs + PR_DS;
  const int lane = tid & 31, warp = tid >> 5;

  // where row g lies (slot -1: nothing to read) and its id
  auto locate = [&](long long g, long long& slot, uint32_t& low) {
    slot = -1;
    low = 0;
    if (g >= total) return;
    if (STAGE == 1) {
      low = static_cast<uint32_t>(g);
      if (g < a.l_real) slot = g;
      return;
    }
    int lo = 0, hi = a.nprobe;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (pre[mid] <= g)
        lo = mid;
      else
        hi = mid;
    }
    const long long pos = a.offsets[ids[lo]] + (g - pre[lo]);
    slot = a.slotmap[pos];
    low = static_cast<uint32_t>(a.rowids[pos]);
  };
  // slab sl of the tile whose slots are s_slot[kb], into stage buffer sb
  auto issue = [&](int kb, int sl, int sb) {
    const int d0 = sl * ds, w = min(ds, dp - d0);
    float* x = fsm + sb * stage_floats;
    float* qs = x + PR_T * rs;
    const int per = VEC ? w / 4 : w;
    for (int e = tid; e < PR_T * per; e += PR_T) {
      const int r = e / per, c = e - r * per;
      const long long sr = s_slot[kb][r];
      if (sr < 0) continue;
      const float* src = a.rows + sr * dp + d0 + (VEC ? 4 * c : c);
      if (VEC)
        cp_async16(x + r * rs + 4 * c, src);
      else
        cp_async4(x + r * rs + c, src);
    }
    for (int c = tid; c < per; c += PR_T) {
      if (VEC)
        cp_async16(qs + 4 * c, qrow + d0 + 4 * c);
      else
        cp_async4(qs + c, qrow + d0 + c);
    }
    cp_commit();
  };

  long long t = chunk;
  int kb = 0, st = 0;  // the tile's slot buffer; the step's stage buffer
  long long slot;
  uint32_t low;
  locate(t * PR_T + tid, slot, low);
  bool rd = slot >= 0;
  s_slot[0][tid] = slot;
  __syncthreads();
  issue(0, 0, 0);
  for (;;) {
    const long long g = t * PR_T + tid;
    const long long tn = t + a.blocks;
    const bool more = tn < ntiles;
    bool rd_next = false;
    uint32_t low_next = 0;
    float ca = 0.0f, cb = 0.0f, cc = 0.0f;
    for (int sl = 0; sl < ns; ++sl, ++st) {
      if (sl == 0 && more) {  // the next tile's rows, while this one lands
        long long sn;
        locate(tn * PR_T + tid, sn, low_next);
        rd_next = sn >= 0;
        s_slot[kb ^ 1][tid] = sn;
      }
      cp_wait_all();
      __syncthreads();  // step st landed; step st - 1's readers are done
      if (sl + 1 < ns)
        issue(kb, sl + 1, (st + 1) & 1);
      else if (more)
        issue(kb ^ 1, 0, (st + 1) & 1);
      const int w = min(ds, dp - sl * ds);
      const float* x = fsm + (st & 1) * stage_floats;
      const float* qs = x + PR_T * rs;
      x += tid * rs;
      switch (a.metric) {
        case M_L2:
          chain_slab<M_L2, VEC>(x, qs, w, sl == 0, ca, cb, cc);
          break;
        case M_IP:
          chain_slab<M_IP, VEC>(x, qs, w, sl == 0, ca, cb, cc);
          break;
        default:
          chain_slab<M_COS, VEC>(x, qs, w, sl == 0, ca, cb, cc);
      }
    }
    float d;
    switch (a.metric) {
      case M_L2: d = chain_end<M_L2>(ca, cb, cc); break;
      case M_IP: d = chain_end<M_IP>(ca, cb, cc); break;
      default: d = chain_end<M_COS>(ca, cb, cc);
    }
    u64 key = NO_KEY;
    if (g < total) {
      if (STAGE == 1)
        key = make_key(
            list_image(rd ? d : __uint_as_float(0x7F800000u)), low);
      else
        key = make_key(asc_image(d), low);
    }
    // the tile's keys, sorted by warp, merged into the running best: runs
    // of 32 (the best's kpad keys, then the 4 warps') in the tile merge's
    // buffers (the next tile's first slab may be landing in the stage
    // buffers). A tile with no key below the best's last (row ids are
    // unique, so no key ties it) changes nothing and skips the merge.
    if (__syncthreads_or(key < s_best[keep - 1])) {
      key = warp_sort(key);
      tsel[kpad + warp * 32 + lane] = key;
      for (int i = tid; i < kpad; i += PR_T) tsel[i] = s_best[i];
      __syncthreads();
      int len;
      const u64* best = merge_runs(tsel, tsel + a.span_tile,
                                   kpad / 32 + PR_T / 32, 32, keep, len);
      for (int i = tid; i < keep; i += PR_T) s_best[i] = best[i];
      __syncthreads();
    }
    if (!more) break;
    t = tn;
    kb ^= 1;
    low = low_next;
    rd = rd_next;
  }

  u64* dst = a.cand + (static_cast<long long>(q) * a.blocks + chunk) * keep;
  for (int i = tid; i < keep; i += PR_T) dst[i] = s_best[i];
  if (STAGE == 1 || !a.fused) return;

  // fused stage 2: the last block of each group merges the group's keys,
  // and the last group's merger the group runs
  const int G = a.group;
  const long long gi = chunk / G;
  const long long nwg = (nwork + G - 1) / G;  // groups with work
  const int in_g = static_cast<int>(nwork - gi * G < G ? nwork - gi * G : G);
  unsigned* tk = a.ticket + static_cast<long long>(q) * (a.groups + 1);
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(tk + gi, 1u) == static_cast<unsigned>(in_g - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const u64* src = a.cand + (static_cast<long long>(q) * a.blocks + gi * G) *
                                keep;
  for (int i = tid; i < in_g * keep; i += PR_T) ksm[i] = __ldcg(src + i);
  __syncthreads();
  int len;
  const u64* run = merge_runs(ksm, ksm + a.span_g, in_g, keep, a.kkp, len);
  if (nwg > 1) {
    u64* gdst = a.grp + (static_cast<long long>(q) * a.groups + gi) * a.kkp;
    for (int i = tid; i < a.kkp; i += PR_T)
      gdst[i] = i < len ? run[i] : NO_KEY;
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(tk + a.groups, 1u) ==
               static_cast<unsigned>(nwg - 1);
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const u64* gsrc = a.grp + static_cast<long long>(q) * a.groups * a.kkp;
    for (int i = tid; i < nwg * a.kkp; i += PR_T) ksm[i] = __ldcg(gsrc + i);
    __syncthreads();
    run = merge_runs(ksm, ksm + a.span2, static_cast<int>(nwg), a.kkp, a.kkp,
                     len);
  }
  for (int i = tid; i < a.kkp; i += PR_T) {
    u64 k = i < len ? run[i] : DEAD;
    if (k > DEAD) k = DEAD;  // behind the K dead entries the carry starts with
    const long long o = static_cast<long long>(q) * a.kkp + i;
    a.out_dist[o] = from_image(static_cast<uint32_t>(k >> 32));
    a.out_rows[o] = static_cast<int>(k & 0xFFFFFFFFull);
  }
}

// Stage 1: the lists.
template <bool VEC>
__global__ void __launch_bounds__(PR_T)
    ivf_lists_kernel(const __grid_constant__ PrArgs a) {
  probe_stage<1, VEC>(a);
}

// Stage 2: the rows.
template <bool VEC>
__global__ void __launch_bounds__(PR_T)
    ivf_rows_kernel(const __grid_constant__ PrArgs a) {
  probe_stage<2, VEC>(a);
}

// Stage 1 through the levels: each query's nprobe sorted list keys to the
// probe table (list ids, the exclusive prefix of their counts). One block
// a query.
__global__ void __launch_bounds__(PR_T)
    lists_finish_kernel(const u64* __restrict__ keys, int nprobe,
                        const int* __restrict__ counts, int* __restrict__ ids,
                        long long* __restrict__ pre) {
  const long long q = blockIdx.x;
  int* qi = ids + q * nprobe;
  for (int t = threadIdx.x; t < nprobe; t += PR_T)
    qi[t] = static_cast<int>(keys[q * nprobe + t] & 0xFFFFFFFFull);
  __syncthreads();
  probe_prefix(qi, counts, nprobe, pre + q * (nprobe + 1));
}

__global__ void keys_finish_kernel(const u64* __restrict__ keys, long long n,
                                   float* __restrict__ vals,
                                   int* __restrict__ rows) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  u64 k = keys[i];
  if (k > DEAD) k = DEAD;  // behind the K dead entries the carry starts with
  vals[i] = from_image(static_cast<uint32_t>(k >> 32));
  rows[i] = static_cast<int>(k & 0xFFFFFFFFull);
}

// ------------------------------------------------------------- MaxSim

struct MaxSimArgs {
  const float* region;
  const int* slotmap;
  const int* offsets;
  const int* counts;
  const float* queries;  // (npairs, dp): pair p = (query p / sp, token p % sp)
  const int* dmap;
  long long nlanes;
  int npairs, dp, tile;
  float* m;  // (nlanes, npairs) per (doc lane, pair) maxima
};

// One dim of the micro-tile: each (pair i, token j) chain takes the
// product x·q as its tile's first term (k == 0) or adds it, and the tile's
// last dim adds the chain into acc; k counts dims within the tile.
__device__ __forceinline__ void ms_dim(const float (&xv)[MS_T],
                                       const float (&qv)[MS_P],
                                       float (&part)[MS_P][MS_T],
                                       float (&acc)[MS_P][MS_T], int& k,
                                       int tile) {
  if (k == 0) {
#pragma unroll
    for (int i = 0; i < MS_P; ++i)
#pragma unroll
      for (int j = 0; j < MS_T; ++j) part[i][j] = __fmul_rn(xv[j], qv[i]);
  } else {
#pragma unroll
    for (int i = 0; i < MS_P; ++i)
#pragma unroll
      for (int j = 0; j < MS_T; ++j)
        part[i][j] = __fadd_rn(part[i][j], __fmul_rn(xv[j], qv[i]));
  }
  if (++k == tile) {
    k = 0;
#pragma unroll
    for (int i = 0; i < MS_P; ++i)
#pragma unroll
      for (int j = 0; j < MS_T; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
  }
}

// Four dims of every chain, all inside one dim tile: the first may open
// the tile (its product is the chain's first term).
template <bool OPEN>
__device__ __forceinline__ void ms_group(const float* __restrict__ x,
                                         const float* __restrict__ q, int rs,
                                         int d, float (&part)[MS_P][MS_T]) {
  float4 xv[MS_T], qv[MS_P];
#pragma unroll
  for (int j = 0; j < MS_T; ++j)
    xv[j] = *reinterpret_cast<const float4*>(x + j * 16 * rs + d);
#pragma unroll
  for (int i = 0; i < MS_P; ++i)
    qv[i] = *reinterpret_cast<const float4*>(q + i * rs + d);
#pragma unroll
  for (int i = 0; i < MS_P; ++i)
#pragma unroll
    for (int j = 0; j < MS_T; ++j) {
      float t = OPEN ? __fmul_rn(xv[j].x, qv[i].x)
                     : __fadd_rn(part[i][j], __fmul_rn(xv[j].x, qv[i].x));
      t = __fadd_rn(t, __fmul_rn(xv[j].y, qv[i].y));
      t = __fadd_rn(t, __fmul_rn(xv[j].z, qv[i].z));
      part[i][j] = __fadd_rn(t, __fmul_rn(xv[j].w, qv[i].w));
    }
}

// MaxSim: block (bx, pb) holds pairs [pb·MS_PB, +MS_PB) and walks the doc
// lanes in chunks of MS_LC (chunk bx, bx + gridDim.x, ...). A chunk's
// docs' tokens stream, in lane order, through token tiles of MS_TT
// (cp.async copies through the slot map, double-buffered by step; a step
// is one (tile, dim slab)); thread (pg, tg) computes pairs pg·8 + i and
// tokens tg + 16·j of each tile in registers, the chains in the contract's
// order (four dims a step of float4 loads where every dim tile is a
// multiple of 4 inside one slab, else one dim at a time). Then a
// segmented max in registers: per doc lane of the tile, each thread's max
// over its tokens of that lane, a butterfly over the 16 threads of the
// pair group, and m[lane][pair] written when the doc ends (a doc that
// goes on carries its max into the next tile). Shared memory does not
// grow with the doc length; the queries stay in shared memory for the
// block's life at widths up to MS_ONE_SLAB, else each step brings its
// slab of them.
template <bool VEC>
__global__ void __launch_bounds__(MS_THREADS, 1)
    maxsim_tiles_kernel(MaxSimArgs a) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ int s_pref[MS_LC + 1];
  __shared__ long long s_base[MS_LC];
  __shared__ int s_lane[2][MS_TT];  // a tile's token -> lane in the chunk

  static_assert(MS_THREADS == MS_PB / MS_P * 16,
                "16 token threads a pair group");
  constexpr int LPT = MS_THREADS / MS_TT;  // loader threads a token
  const int tid = threadIdx.x;
  const int dp = a.dp;
  const bool one = dp <= MS_ONE_SLAB;
  const int ds = one ? dp : MS_DS;        // dims a slab holds
  const int ns = one ? 1 : (dp + MS_DS - 1) / MS_DS;
  const int rs = ds + MS_PAD;             // smem row stride (floats)
  const int pb0 = blockIdx.y * MS_PB;
  float* qres = fsm;                                  // one: (MS_PB, rs)
  float* xst = fsm + (one ? MS_PB * rs : 0);          // 2 x (TT, rs)
  float* qst = xst + 2 * MS_TT * rs;                  // !one: 2 x (MS_PB, rs)

  // a slab of the block's pairs into q (rows of rs); pad pairs read 0
  auto load_q = [&](float* q, int d0, int w) {
    const int per = VEC ? w / 4 : w;
    for (int e = tid; e < MS_PB * per; e += MS_THREADS) {
      const int p = e / per, c = e - p * per;
      float* dst = q + p * rs + (VEC ? 4 * c : c);
      if (pb0 + p >= a.npairs) {
        dst[0] = 0.0f;
        if (VEC) dst[1] = dst[2] = dst[3] = 0.0f;
        continue;
      }
      const float* src = a.queries + static_cast<long long>(pb0 + p) * dp +
                         d0 + (VEC ? 4 * c : c);
      if (VEC)
        cp_async16(dst, src);
      else
        cp_async4(dst, src);
    }
  };
  if (one) {
    load_q(qres, 0, dp);
    cp_commit();
  }

  const int pg = tid >> 4, tg = tid & 15;  // compute: pairs, tokens
  // every dim tile inside one slab and a multiple of 4 dims: the chains
  // run tile by tile with no per-dim test
  const bool aligned = VEC && a.tile % 4 == 0 && ds % a.tile == 0;
  const int lt = tid / LPT, lc = tid % LPT;  // loads: token, column phase
  const long long nchunks = (a.nlanes + MS_LC - 1) / MS_LC;
  for (long long ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const long long l0 = ch * MS_LC;
    __syncthreads();  // the last chunk's readers of s_pref are done
    if (tid < 32) {
      const long long lane = l0 + tid;
      int cnt = 0;
      long long base = 0;
      if (tid < MS_LC && lane < a.nlanes) {
        const int doc = a.dmap[lane];
        cnt = a.counts[doc];
        base = a.offsets[doc];
      }
      int incl = cnt;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (tid >= o) incl += y;
      }
      if (tid < MS_LC) {
        s_pref[tid + 1] = incl;
        s_base[tid] = base;
      }
      if (tid == 0) s_pref[0] = 0;
    }
    __syncthreads();
    const int total = s_pref[MS_LC];
    if (total == 0) continue;
    const int ntiles = (total + MS_TT - 1) / MS_TT;
    const int nsteps = ntiles * ns;

    // step (tile, slab) into stage step & 1
    auto issue = [&](int step) {
      const int kt = step / ns, sl = step - kt * ns;
      const int d0 = sl * ds, w = min(ds, dp - d0);
      float* x = xst + (step & 1) * MS_TT * rs;
      const int pos = kt * MS_TT + lt;
      int lane = -1;
      if (pos < total) {
        int lo = 0, hi = MS_LC;  // the last lane whose tokens start <= pos
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (s_pref[mid] <= pos)
            lo = mid;
          else
            hi = mid;
        }
        lane = lo;
        const long long slot = a.slotmap[s_base[lo] + (pos - s_pref[lo])];
        const float* src = a.region + slot * dp + d0;
        float* dst = x + lt * rs;
        if (VEC) {
          for (int c = lc; c < w / 4; c += LPT)
            cp_async16(dst + 4 * c, src + 4 * c);
        } else {
          for (int c = lc; c < w; c += LPT) cp_async4(dst + c, src + c);
        }
      }
      if (sl == 0 && lc == 0) s_lane[kt & 1][lt] = lane;
      if (!one) load_q(qst + (step & 1) * MS_PB * rs, d0, w);
      cp_commit();
    };

    issue(0);
    float part[MS_P][MS_T], acc[MS_P][MS_T];
    int k = 0;
    float carry[MS_P];    // the max so far of a doc that began in an
    int carry_lane = -1;  // earlier tile, and its lane (-1: none)
    for (int step = 0; step < nsteps; ++step) {
      const int kt = step / ns, sl = step - kt * ns;
      cp_wait_all();
      __syncthreads();  // step's data landed; step - 1's readers are done
      if (step + 1 < nsteps) issue(step + 1);
      if (sl == 0) {
        k = 0;
#pragma unroll
        for (int i = 0; i < MS_P; ++i)
#pragma unroll
          for (int j = 0; j < MS_T; ++j) acc[i][j] = 0.0f;
      }
      const int w = min(ds, dp - sl * ds);
      const float* x = xst + (step & 1) * MS_TT * rs + tg * rs;
      const float* q = (one ? qres : qst + (step & 1) * MS_PB * rs) +
                       pg * MS_P * rs;
      if (aligned) {
        for (int i0 = 0; i0 < w; i0 += a.tile) {
          ms_group<true>(x, q, rs, i0, part);
#pragma unroll 2
          for (int d = i0 + 4; d < i0 + a.tile; d += 4)
            ms_group<false>(x, q, rs, d, part);
#pragma unroll
          for (int i = 0; i < MS_P; ++i)
#pragma unroll
            for (int j = 0; j < MS_T; ++j)
              acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
        }
      } else {
        for (int d = 0; d < w; ++d) {
          float xv[MS_T], qv[MS_P];
#pragma unroll
          for (int j = 0; j < MS_T; ++j) xv[j] = x[j * 16 * rs + d];
#pragma unroll
          for (int i = 0; i < MS_P; ++i) qv[i] = q[i * rs + d];
          ms_dim(xv, qv, part, acc, k, a.tile);
        }
      }
      if (sl != ns - 1) continue;
      // the segmented max: the 16 lanes of a half-warp hold one pair
      // group's 64 tokens, so per doc lane of the tile each takes the max
      // over its own tokens of that lane, then a butterfly over the 16
      // (NaN propagates; the order cannot change a key). A doc that runs
      // past the tile's end carries its max into the next tile.
      const int t0 = kt * MS_TT, nt = min(MS_TT, total - t0);
      const int* tl = s_lane[kt & 1];
      int mine[MS_T];
#pragma unroll
      for (int j = 0; j < MS_T; ++j) mine[j] = tl[tg + 16 * j];
      const int cl = carry_lane;
      carry_lane = -1;
      for (int l = tl[0]; l <= tl[nt - 1]; ++l) {
        float v[MS_P];
#pragma unroll
        for (int i = 0; i < MS_P; ++i) {
          v[i] = __uint_as_float(0xFF800000u);
#pragma unroll
          for (int j = 0; j < MS_T; ++j)
            if (mine[j] == l) v[i] = nan_max(acc[i][j], v[i]);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
#pragma unroll
          for (int i = 0; i < MS_P; ++i)
            v[i] = nan_max(__shfl_xor_sync(0xFFFFFFFFu, v[i], o), v[i]);
        if (l == cl) {
#pragma unroll
          for (int i = 0; i < MS_P; ++i) v[i] = nan_max(carry[i], v[i]);
        }
        if (s_pref[l + 1] > t0 + nt) {  // the doc goes on: carry it
#pragma unroll
          for (int i = 0; i < MS_P; ++i) carry[i] = v[i];
          carry_lane = l;
          continue;
        }
        const int p = pb0 + pg * MS_P + tg;  // lane tg < MS_P: pair tg
#pragma unroll
        for (int i = 0; i < MS_P; ++i)
          if (tg == i && p < a.npairs) a.m[(l0 + l) * a.npairs + p] = v[i];
      }
    }
  }
  cp_wait_all();  // a block whose chunks were all empty still waits
}

// Each (query, doc lane)'s score, 0 + m[s = 0] + m[1] + ... in s order,
// over its pairs' maxima (-inf for an empty doc); key = -score + 0.0,
// query b's keys kstride apart.
__global__ void maxsim_score_kernel(const float* __restrict__ m,
                                    const int* __restrict__ dmap,
                                    const int* __restrict__ counts,
                                    const int* __restrict__ rowids,
                                    long long nlanes, long long kstride,
                                    int bp, int sp,
                                    u64* __restrict__ keys) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= nlanes * bp) return;
  const long long lane = i % nlanes, b = i / nlanes;
  const int doc = dmap[lane];
  const bool live = counts[doc] > 0;
  const float* row = m + lane * (static_cast<long long>(bp) * sp) + b * sp;
  float score = 0.0f;
  for (int s = 0; s < sp; ++s)
    score = __fadd_rn(score, live ? row[s] : __uint_as_float(0xFF800000u));
  const float key = __fadd_rn(-score, 0.0f);
  keys[b * kstride + lane] =
      make_key(asc_image(key), static_cast<uint32_t>(rowids[doc]));
}

// Squared norm of each row as a chain.
__global__ void row_norms_kernel(const float* __restrict__ a, long long n,
                                 int d, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const float* r = a + i * d;
  float acc = __fmul_rn(r[0], r[0]);
  for (int j = 1; j < d; ++j) acc = __fadd_rn(acc, __fmul_rn(r[j], r[j]));
  out[i] = acc;
}

// (d, k) better than (e, l) as jnp.argmin sees it.
__device__ __forceinline__ bool better(float d, int k, float e, int l) {
  const bool dn = d != d, en = e != e;
  if (dn || en) return dn && (!en || k < l);
  return d < e || (d == e && k < l);
}

__global__ void kmeans_assign_kernel(const float* __restrict__ xc,
                                     const float* __restrict__ x2,
                                     const float* __restrict__ c2, long long n,
                                     int k, int* __restrict__ out) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // a whole warp leaves together
  const float* r = xc + row * k;
  const float xr = x2[row];
  float bd = 0.0f;
  int bk = -1;
  for (int j = lane; j < k; j += 32) {
    const float d = __fadd_rn(__fsub_rn(xr, __fmul_rn(2.0f, r[j])), c2[j]);
    if (bk < 0 || better(d, j, bd, bk)) {
      bd = d;
      bk = j;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_down_sync(0xFFFFFFFFu, bd, o);
    const int ok = __shfl_down_sync(0xFFFFFFFFu, bk, o);
    if (ok >= 0 && (bk < 0 || better(od, ok, bd, bk))) {
      bd = od;
      bk = ok;
    }
  }
  if (lane == 0) out[row] = bk;
}

// ---------------------------------------------------------- kmeans_update

constexpr int KM_CHUNK = 128;        // sorted rows a chunk sums
constexpr long long KM_RANGE = 2048; // rows a warp counts and scatters
constexpr long long KM_HCAP = 1LL << 22;  // words of the (warps, K) table
constexpr int KM_SMEM_K = 8192;      // clusters a shared histogram holds
constexpr int KM_WARPS = 4;          // warps a hist/scatter block
constexpr int KM_CHUNK_WARPS = 8;
constexpr uint32_t KM_FULL = 0xFFFFFFFFu;
// control words: the prefix kernel's ticket, the number of chunks
enum : int { KM_TICKET = 0, KM_NCHUNK = 1, KM_CTL = 4 };

struct KmArgs {
  const float* x;
  const int* assign;
  const float* old;
  float* out;
  unsigned* ctl;     // KM_CTL
  unsigned* table;   // (pw, K): counts, then exclusive prefixes, then cursors
  unsigned* total;   // (K,) rows of each cluster
  unsigned* start;   // (K,) its first sorted slot
  unsigned* cstart;  // (K + 1,) its first chunk
  unsigned* pstart;  // (K,) its first partial-sum slot (clusters of 2+ chunks)
  unsigned* ticket;  // (K,) chunks of it done
  unsigned* sorted;  // (n,) row ids by cluster
  float* partial;    // (npart, D)
  long long n, range, pw;
  int k, d, smem, vec;
};

struct KmPlan {
  long long range, pw, nchunk, npart, part_off, bytes;
};

KmPlan km_plan(long long n, long long k, long long d) {
  KmPlan p;
  p.range = KM_RANGE;
  while (sel::ceil_div(n, p.range) * k > KM_HCAP && p.range < n) p.range *= 2;
  p.pw = sel::ceil_div(n, p.range);
  p.nchunk = sel::ceil_div(n, KM_CHUNK) + (k < n ? k : n);
  // a cluster of 2+ chunks holds more than KM_CHUNK rows, so their chunks
  // number at most n / KM_CHUNK + n / (KM_CHUNK + 1)
  p.npart = 2 * sel::ceil_div(n, KM_CHUNK);
  const long long words = KM_CTL + p.pw * k + 5 * k + 1 + n;
  p.part_off = (words * 4 + 15) / 16 * 16;
  p.bytes = p.part_off + p.npart * d * 4;
  return p;
}

KmArgs km_carve(void* buf, const KmPlan& p, long long n, int k, int d) {
  KmArgs a{};
  unsigned* w = static_cast<unsigned*>(buf);
  a.ctl = w;
  a.table = a.ctl + KM_CTL;
  a.total = a.table + p.pw * k;
  a.start = a.total + k;
  a.cstart = a.start + k;
  a.pstart = a.cstart + k + 1;
  a.ticket = a.pstart + k;
  a.sorted = a.ticket + k;
  a.partial = reinterpret_cast<float*>(static_cast<char*>(buf) + p.part_off);
  a.n = n;
  a.range = p.range;
  a.pw = p.pw;
  a.k = k;
  a.d = d;
  return a;
}

constexpr int KM_AHEAD = 8;        // rows a lane has in flight
constexpr int KM_FOLD_AHEAD = 32;  // chunk sums a folding lane has in flight

// The clusters of rows base + 32u + lane (u < KM_AHEAD), -1 past r1: all
// loads in flight together.
__device__ __forceinline__ void load_codes(const KmArgs& a, long long base,
                                           long long r1,
                                           int (&cs)[KM_AHEAD]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < KM_AHEAD; ++u) {
    const long long i = base + 32 * u + lane;
    cs[u] = i < r1 ? __ldg(a.assign + i) : -1;
  }
}

// Warp w counts the clusters of its rows into its row of the table.
__global__ void __launch_bounds__(KM_WARPS * 32)
    km_hist_kernel(const __grid_constant__ KmArgs a) {
  extern __shared__ unsigned km_sh[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[KM_TICKET] = 0u;
  const long long w = static_cast<long long>(blockIdx.x) * KM_WARPS + warp;
  if (w >= a.pw) return;  // warp-uniform
  unsigned* row = a.table + w * a.k;
  unsigned* h = a.smem ? km_sh + warp * a.k : row;
  for (int c = lane; c < a.k; c += 32) h[c] = 0u;
  __syncwarp();
  const long long r0 = w * a.range;
  const long long r1 = r0 + a.range < a.n ? r0 + a.range : a.n;
  for (long long base = r0; base < r1; base += 32 * KM_AHEAD) {
    int cs[KM_AHEAD];
    load_codes(a, base, r1, cs);
#pragma unroll
    for (int u = 0; u < KM_AHEAD; ++u) {
      const int c = cs[u];
      const unsigned peers = __match_any_sync(KM_FULL, c);
      if (c >= 0 && lane == __ffs(peers) - 1) h[c] += __popc(peers);
      __syncwarp();
    }
  }
  if (a.smem)
    for (int c = lane; c < a.k; c += 32) row[c] = h[c];
}

// Block (32, 32): lanes along 32 clusters, row y the y-th part of the
// warps. The exclusive prefix over the warps in place and each count;
// then the last block scans the counts.
__global__ void __launch_bounds__(1024)
    km_prefix_kernel(const __grid_constant__ KmArgs a) {
  __shared__ unsigned s[32][33];
  __shared__ unsigned s_tot[32];
  __shared__ bool s_last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  const long long seg = (a.pw + 31) / 32;
  const long long w0 = ty * seg < a.pw ? ty * seg : a.pw;
  const long long w1 = w0 + seg < a.pw ? w0 + seg : a.pw;
  unsigned sum = 0;
  if (c < a.k)
    for (long long w = w0; w < w1; ++w) sum += a.table[w * a.k + c];
  s[ty][tx] = sum;
  __syncthreads();
  if (c < a.k) {
    unsigned run = 0, tot = 0;
    for (int y = 0; y < 32; ++y) {
      run += y < ty ? s[y][tx] : 0u;
      tot += s[y][tx];
    }
    for (long long w = w0; w < w1; ++w) {
      const unsigned v = a.table[w * a.k + c];
      a.table[w * a.k + c] = run;
      run += v;
    }
    if (ty == 0) {
      a.total[c] = tot;
      a.ticket[c] = 0u;
      s_tot[tx] = tot;
    }
  }
  __syncthreads();
  // empty clusters keep their centroid
  for (int i = 0; i < 32; ++i) {
    const int ci = blockIdx.x * 32 + i;
    if (ci >= a.k) break;
    if (s_tot[i]) continue;
    for (int j = ty * 32 + tx; j < a.d; j += 1024)
      a.out[static_cast<long long>(ci) * a.d + j] =
          a.old[static_cast<long long>(ci) * a.d + j];
  }
  __threadfence();
  __syncthreads();
  if (tx == 0 && ty == 0)
    s_last = atomicAdd(a.ctl + KM_TICKET, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: exclusive scans of rows, chunks and partial slots
  const int t = ty * 32 + tx;
  const int per = (a.k + 1023) / 1024;
  const int lo = t * per < a.k ? t * per : a.k;
  const int hi = lo + per < a.k ? lo + per : a.k;
  unsigned r = 0, ch = 0, pa = 0;
  for (int i = lo; i < hi; ++i) {
    const unsigned tot = __ldcg(a.total + i);
    const unsigned nch = (tot + KM_CHUNK - 1) / KM_CHUNK;
    r += tot;
    ch += nch;
    pa += nch > 1 ? nch : 0u;
  }
  __shared__ unsigned sr[1024], sc[1024], sp[1024];
  sr[t] = r;
  sc[t] = ch;
  sp[t] = pa;
  __syncthreads();
  for (int o = 1; o < 1024; o <<= 1) {
    const unsigned xr = t >= o ? sr[t - o] : 0u;
    const unsigned xc = t >= o ? sc[t - o] : 0u;
    const unsigned xp = t >= o ? sp[t - o] : 0u;
    __syncthreads();
    sr[t] += xr;
    sc[t] += xc;
    sp[t] += xp;
    __syncthreads();
  }
  unsigned rr = sr[t] - r, cc = sc[t] - ch, pp = sp[t] - pa;
  for (int i = lo; i < hi; ++i) {
    const unsigned tot = __ldcg(a.total + i);
    const unsigned nch = (tot + KM_CHUNK - 1) / KM_CHUNK;
    a.start[i] = rr;
    a.cstart[i] = cc;
    a.pstart[i] = pp;
    rr += tot;
    cc += nch;
    pp += nch > 1 ? nch : 0u;
  }
  if (t == 1023) {
    a.cstart[a.k] = sc[1023];
    a.ctl[KM_NCHUNK] = sc[1023];
  }
}

// The stable scatter: warp w walks its rows again in order and writes
// each row id to its cluster's next slot.
__global__ void __launch_bounds__(KM_WARPS * 32)
    km_scatter_kernel(const __grid_constant__ KmArgs a) {
  extern __shared__ unsigned km_sh[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * KM_WARPS + warp;
  if (w >= a.pw) return;  // warp-uniform
  unsigned* row = a.table + w * a.k;
  unsigned* cur = a.smem ? km_sh + warp * a.k : row;
  for (int c = lane; c < a.k; c += 32) cur[c] = a.start[c] + row[c];
  __syncwarp();
  const long long r0 = w * a.range;
  const long long r1 = r0 + a.range < a.n ? r0 + a.range : a.n;
  const unsigned below = (1u << lane) - 1u;
  for (long long base = r0; base < r1; base += 32 * KM_AHEAD) {
    int cs[KM_AHEAD];
    load_codes(a, base, r1, cs);
#pragma unroll
    for (int u = 0; u < KM_AHEAD; ++u) {
      const int c = cs[u];
      const unsigned peers = __match_any_sync(KM_FULL, c);
      if (c >= 0)
        a.sorted[cur[c] + __popc(peers & below)] =
            static_cast<unsigned>(base + 32 * u + lane);
      __syncwarp();
      if (c >= 0 && lane == __ffs(peers) - 1) cur[c] += __popc(peers);
      __syncwarp();
    }
  }
}

__device__ __forceinline__ float4 add4(float4 s, float4 v) {
  return make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y),
                     __fadd_rn(s.z, v.z), __fadd_rn(s.w, v.w));
}

__device__ __forceinline__ float4 div4(float4 s, float c) {
  return make_float4(__fdiv_rn(s.x, c), __fdiv_rn(s.y, c), __fdiv_rn(s.z, c),
                     __fdiv_rn(s.w, c));
}

// The sum of the chunk's rn sorted rows (ids from `ids`) over the lane's
// dims of one tile, in row order from +0.0. V: a lane's dims are one
// float4 at dim j (else one float at dim j); `on`: the lane has dims here.
template <bool V>
__device__ __forceinline__ float4 chunk_sum(const KmArgs& a,
                                            const unsigned* ids, int rn,
                                            int j, bool on) {
  const int lane = threadIdx.x & 31;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r0 = 0; r0 < rn; r0 += 32) {
    const unsigned my = r0 + lane < rn ? ids[r0 + lane] : 0u;
    const int m = rn - r0 < 32 ? rn - r0 : 32;
    for (int q = 0; q < m; q += KM_AHEAD) {
      float4 v[KM_AHEAD];
#pragma unroll
      for (int u = 0; u < KM_AHEAD; ++u) {
        const unsigned id = __shfl_sync(KM_FULL, my, (q + u) & 31);
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (on && q + u < m) {
          const float* p = a.x + static_cast<long long>(id) * a.d + j;
          // x streams through once: evict it first, so the chunk sums
          // stay in L2 for the fold
          if (V)
            v[u] = __ldcs(reinterpret_cast<const float4*>(p));
          else
            v[u].x = __ldcs(p);
        }
      }
#pragma unroll
      for (int u = 0; u < KM_AHEAD; ++u)
        if (q + u < m) acc = add4(acc, v[u]);
    }
  }
  return acc;
}

// Fold a cluster's nch chunk sums (slots ps..) over one tile of dims, in
// chunk order, and write the centroids.
template <bool V>
__device__ __forceinline__ void fold_tile(const KmArgs& a, int c, unsigned ps,
                                          unsigned nch, float cnt, int j,
                                          bool on) {
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (unsigned q = 0; q < nch; q += KM_FOLD_AHEAD) {
    float4 v[KM_FOLD_AHEAD];
#pragma unroll
    for (int u = 0; u < KM_FOLD_AHEAD; ++u) {
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (on && q + u < nch) {
        const float* p =
            a.partial + static_cast<long long>(ps + q + u) * a.d + j;
        if (V)
          v[u] = __ldcg(reinterpret_cast<const float4*>(p));
        else
          v[u].x = __ldcg(p);
      }
    }
#pragma unroll
    for (int u = 0; u < KM_FOLD_AHEAD; ++u)
      if (q + u < nch) s = add4(s, v[u]);
  }
  if (!on) return;
  float* o = a.out + static_cast<long long>(c) * a.d + j;
  if (V)
    *reinterpret_cast<float4*>(o) = div4(s, cnt);
  else
    *o = __fdiv_rn(s.x, cnt);
}

template <bool V>
__device__ __forceinline__ void chunk_warp(const KmArgs& a, int c,
                                           unsigned j0, unsigned nch,
                                           unsigned cnt) {
  const int lane = threadIdx.x & 31;
  const int tile = V ? 128 : 32;
  const int rn = static_cast<int>(
      cnt - j0 * KM_CHUNK < KM_CHUNK ? cnt - j0 * KM_CHUNK : KM_CHUNK);
  const unsigned* ids = a.sorted + a.start[c] + j0 * KM_CHUNK;
  const unsigned ps = nch > 1 ? a.pstart[c] : 0u;
  for (int t0 = 0; t0 < a.d; t0 += tile) {
    const int j = t0 + (V ? 4 : 1) * lane;
    const bool on = j < a.d;
    const float4 acc = chunk_sum<V>(a, ids, rn, j, on);
    if (!on) continue;
    if (nch == 1) {
      float* o = a.out + static_cast<long long>(c) * a.d + j;
      if (V)
        *reinterpret_cast<float4*>(o) = div4(acc, static_cast<float>(cnt));
      else
        *o = __fdiv_rn(acc.x, static_cast<float>(cnt));
    } else {
      float* p = a.partial + static_cast<long long>(ps + j0) * a.d + j;
      if (V)
        *reinterpret_cast<float4*>(p) = acc;
      else
        *p = acc.x;
    }
  }
  if (nch == 1) return;
  // the last warp of the cluster folds its chunk sums
  __threadfence();
  unsigned done = 0;
  if (lane == 0) done = atomicAdd(a.ticket + c, 1u);
  done = __shfl_sync(KM_FULL, done, 0);
  if (done != nch - 1) return;
  __threadfence();
  for (int t0 = 0; t0 < a.d; t0 += tile) {
    const int j = t0 + (V ? 4 : 1) * lane;
    fold_tile<V>(a, c, ps, nch, static_cast<float>(cnt), j, j < a.d);
  }
}

__global__ void __launch_bounds__(KM_CHUNK_WARPS * 32)
    km_chunk_kernel(const __grid_constant__ KmArgs a) {
  const long long g = static_cast<long long>(blockIdx.x) * KM_CHUNK_WARPS +
                      (threadIdx.x >> 5);
  if (g >= a.ctl[KM_NCHUNK]) return;  // warp-uniform
  // the cluster: the last c with cstart[c] <= g (empty clusters share
  // the next one's start and are skipped)
  int lo = 0, hi = a.k;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a.cstart[mid] <= g)
      lo = mid;
    else
      hi = mid;
  }
  const unsigned j0 = static_cast<unsigned>(g) - a.cstart[lo];
  const unsigned nch = a.cstart[lo + 1] - a.cstart[lo];
  if (a.vec)
    chunk_warp<true>(a, lo, j0, nch, a.total[lo]);
  else
    chunk_warp<false>(a, lo, j0, nch, a.total[lo]);
}

unsigned grid1(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

// Dynamic shared bytes of maxsim_tiles_kernel at width dp.
long long maxsim_smem(int dp) {
  const bool one = dp <= MS_ONE_SLAB;
  const long long rs = (one ? dp : MS_DS) + MS_PAD;
  const long long floats =
      (one ? MS_PB * rs : 2 * MS_PB * rs) + 2 * MS_TT * rs;
  return floats * static_cast<long long>(sizeof(float));
}

void allow_smem() {
  static bool done = false;
  if (done) return;
  const int pr = PR_SMEM_MAX;
  cudaFuncSetAttribute(ivf_lists_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, pr);
  cudaFuncSetAttribute(ivf_lists_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, pr);
  cudaFuncSetAttribute(ivf_rows_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, pr);
  cudaFuncSetAttribute(ivf_rows_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, pr);
  const int ms = static_cast<int>(maxsim_smem(MS_ONE_SLAB) >
                                           maxsim_smem(MS_ONE_SLAB + 1)
                                       ? maxsim_smem(MS_ONE_SLAB)
                                       : maxsim_smem(MS_ONE_SLAB + 1));
  cudaFuncSetAttribute(maxsim_tiles_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, ms);
  cudaFuncSetAttribute(maxsim_tiles_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, ms);
  const int km = KM_WARPS * KM_SMEM_K * static_cast<int>(sizeof(unsigned));
  cudaFuncSetAttribute(km_hist_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, km);
  cudaFuncSetAttribute(km_scatter_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, km);
  done = true;
}

}  // namespace

extern "C" {

// ivf_probe: region rows of dp floats; slotmap/rowids (npos_pad,),
// offsets/counts (lp,), cents (lp, dp), queries (qp, dp). Each query's
// nprobe nearest lists, then the kkp smallest (distance, row) keys over
// their rows; nlanes bounds a query's rows (the probe grid's lanes). buf
// (`probe_bytes`) is the call's scratch, unset; outputs (qp, kkp)
// distances and rows. Two launches while both stages are fused.
int ivf_probe(const void* region, const void* slotmap, const void* offsets,
              const void* counts, const void* rowids, const void* cents,
              const void* queries, int qp, int dp, int lp, int l_real,
              int nprobe, long long nlanes, int kkp, int metric, void* buf,
              long long bytes, void* out_dist, void* out_rows, void* stream) {
  if (qp < 1 || dp < 1 || nprobe < 1 || kkp < 1 || nprobe > l_real ||
      l_real > lp || nlanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ProbeLayout L = probe_layout(qp, lp, nprobe, nlanes, kkp);
  if (bytes < L.bytes || L.s1.blocks * qp > 0x7FFFFFFFLL ||
      L.s2.blocks * qp > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  allow_smem();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(buf);
  u64* c1 = reinterpret_cast<u64*>(base);
  u64* c2 = reinterpret_cast<u64*>(base + L.off_c2);
  u64* lb = reinterpret_cast<u64*>(base + L.off_b);
  u64* grp = reinterpret_cast<u64*>(base + L.off_grp);
  int* ids = reinterpret_cast<int*>(base + L.off_ids);
  long long* pre = reinterpret_cast<long long*>(base + L.off_pre);
  unsigned* ticket = reinterpret_cast<unsigned*>(base + L.off_ticket);
  const bool vec = dp % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(region) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cents) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const int ds = dp < PR_DS ? dp : PR_DS;
  const long long stage =
      2LL * (PR_T * (ds + (vec ? 4 : 1)) + PR_DS) * sizeof(float);

  // dynamic shared memory: stage 1 the stage buffers and its tile merge;
  // stage 2 besides its merges of stage 1's and its own candidates, then
  // the probe table
  const long long tile1 = tile_span(L.s1.keep), tile2 = tile_span(L.s2.keep);
  const long long span1 =
      L.s1.fused ? merge_span(L.s1.blocks, L.s1.keep, nprobe) : 0;
  const long long span_g =
      L.s2.fused ? merge_span(L.s2.group, L.s2.keep, kkp) : 0;
  const long long span2 =
      L.s2.fused ? merge_span(L.s2.groups, kkp, kkp) : 0;
  // [stage buffers | the tile merge's two buffers]; the merges of whole
  // candidate sets (at a block's start or end) reuse them from offset 0
  const long long sel_off = align16(stage);
  const long long sm1 = sel_off + 16 * tile1;
  long long before = sel_off + 16 * tile2;
  const long long spans[3] = {span1, span_g, span2};
  for (int i = 0; i < 3; ++i)
    before = 16 * spans[i] > before ? 16 * spans[i] : before;
  const long long table_off = align16(before);
  const long long sm2 =
      table_off +
      (L.s1.fused ? (nprobe * 4LL + 7) / 8 * 8 + (nprobe + 1LL) * 8 : 0);
  if (sm1 > PR_SMEM_MAX || sm2 > PR_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);

  PrArgs a{};
  a.offsets = static_cast<const int*>(offsets);
  a.counts = static_cast<const int*>(counts);
  a.queries = static_cast<const float*>(queries);
  a.ticket = ticket;
  a.grp = grp;
  a.group = L.s2.group;
  a.groups = static_cast<int>(L.s2.groups);
  a.qp = qp;
  a.dp = dp;
  a.lp = lp;
  a.l_real = l_real;
  a.nprobe = nprobe;
  a.kkp = kkp;
  a.metric = metric;
  // stage 1: the lists
  a.rows = static_cast<const float*>(cents);
  a.cand = c1;
  a.blocks = L.s1.blocks;
  a.keep = L.s1.keep;
  a.fused = L.s1.fused;
  a.span_tile = static_cast<int>(tile1);
  a.sel_off = static_cast<int>(sel_off);
  const unsigned g1 = static_cast<unsigned>(L.s1.blocks * qp);
  if (vec)
    ivf_lists_kernel<true><<<g1, PR_T, sm1, s>>>(a);
  else
    ivf_lists_kernel<false><<<g1, PR_T, sm1, s>>>(a);
  if (!L.s1.fused) {
    const u64* lists = sel::levels(c1, L.cap_a1, lb, L.cap_b, qp,
                                   L.s1.blocks * L.s1.keep, L.s1.keep, nprobe,
                                   STAGE_FLOOR, s);
    if (!lists) return static_cast<int>(cudaErrorInvalidValue);
    lists_finish_kernel<<<static_cast<unsigned>(qp), PR_T, 0, s>>>(
        lists, nprobe, static_cast<const int*>(counts), ids, pre);
  }
  // stage 2: the rows
  a.rows = static_cast<const float*>(region);
  a.slotmap = static_cast<const int*>(slotmap);
  a.rowids = static_cast<const int*>(rowids);
  a.cand1 = c1;
  a.ids = ids;
  a.pre = pre;
  a.cand = c2;
  a.out_dist = static_cast<float*>(out_dist);
  a.out_rows = static_cast<int*>(out_rows);
  a.b1 = static_cast<int>(L.s1.blocks);
  a.keep1 = L.s1.keep;
  a.fused1 = L.s1.fused;
  a.blocks = L.s2.blocks;
  a.keep = L.s2.keep;
  a.fused = L.s2.fused;
  a.span_tile = static_cast<int>(tile2);
  a.span1 = static_cast<int>(span1);
  a.span_g = static_cast<int>(span_g);
  a.span2 = static_cast<int>(span2);
  a.table_off = static_cast<int>(table_off);
  const unsigned g2 = static_cast<unsigned>(L.s2.blocks * qp);
  if (vec)
    ivf_rows_kernel<true><<<g2, PR_T, sm2, s>>>(a);
  else
    ivf_rows_kernel<false><<<g2, PR_T, sm2, s>>>(a);
  if (!L.s2.fused) {
    const u64* best = sel::levels(c2, L.cap_a2, lb, L.cap_b, qp,
                                  L.s2.blocks * L.s2.keep, L.s2.keep, kkp,
                                  STAGE_FLOOR, s);
    if (!best) return static_cast<int>(cudaErrorInvalidValue);
    keys_finish_kernel<<<grid1(static_cast<long long>(qp) * kkp, 256), 256,
                         0, s>>>(best, static_cast<long long>(qp) * kkp,
                                 static_cast<float*>(out_dist),
                                 static_cast<int*>(out_rows));
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of ivf_probe's one scratch buffer (ops/vector_kernels.py
// `probe_plan` computes the same).
long long probe_bytes(int qp, int lp, int nprobe, long long nlanes, int kkp) {
  return probe_layout(qp, lp, nprobe, nlanes, kkp).bytes;
}

// maxsim: queries (bp, sp, dp), dmap (nlanes,) doc ids (pad lanes name the
// zero-count doc). `m` (bp * sp * mlanes floats) is the per (lane, pair)
// maxima's scratch: the tiles and score kernels run over ranges of mlanes
// lanes, reusing it; `keys` (cap_a >= bp * nlanes keys) and buf_b (cap_b)
// are the levels' scratch; the (bp, kkp) keys (negated scores) and rows
// go to the outputs.
int maxsim(const void* region, const void* slotmap, const void* offsets,
           const void* counts, const void* rowids, const void* queries,
           const void* dmap, long long nlanes, int bp, int sp, int dp,
           int tile, int kkp, void* m, long long mlanes, void* keys,
           long long cap_a, void* buf_b, long long cap_b, void* out_keys,
           void* out_rows, void* stream) {
  if (kkp < 1 || tile < 1 || dp < 1 || dp % tile || bp < 1 || sp < 1 ||
      mlanes < 1 || static_cast<long long>(bp) * nlanes > cap_a)
    return static_cast<int>(cudaErrorInvalidValue);
  allow_smem();
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npairs = bp * sp;
  const unsigned npb = static_cast<unsigned>((npairs + MS_PB - 1) / MS_PB);
  const size_t sm = static_cast<size_t>(maxsim_smem(dp));
  const int* dm = static_cast<const int*>(dmap);
  for (long long l0 = 0; l0 < nlanes; l0 += mlanes) {
    const long long n = nlanes - l0 < mlanes ? nlanes - l0 : mlanes;
    const long long nchunks = (n + MS_LC - 1) / MS_LC;
    long long gx = sms / static_cast<long long>(npb);
    gx = gx < 1 ? 1 : (gx > nchunks ? nchunks : gx);
    MaxSimArgs ma{static_cast<const float*>(region),
                  static_cast<const int*>(slotmap),
                  static_cast<const int*>(offsets),
                  static_cast<const int*>(counts),
                  static_cast<const float*>(queries), dm + l0, n, npairs, dp,
                  tile, static_cast<float*>(m)};
    const dim3 grid(static_cast<unsigned>(gx), npb);
    if (dp % 4 == 0)
      maxsim_tiles_kernel<true><<<grid, MS_THREADS, sm, s>>>(ma);
    else
      maxsim_tiles_kernel<false><<<grid, MS_THREADS, sm, s>>>(ma);
    maxsim_score_kernel<<<grid1(n * bp, 256), 256, 0, s>>>(
        static_cast<const float*>(m), dm + l0,
        static_cast<const int*>(counts), static_cast<const int*>(rowids), n,
        nlanes, bp, sp, static_cast<u64*>(keys) + l0);
  }
  // the doc keys: each query's nlanes keys, unsorted
  const u64* best = sel::levels(static_cast<u64*>(keys), cap_a,
                                static_cast<u64*>(buf_b), cap_b, bp, nlanes,
                                1, kkp, STAGE_FLOOR, s);
  if (!best) return static_cast<int>(cudaErrorInvalidValue);
  keys_finish_kernel<<<grid1(static_cast<long long>(bp) * kkp, 256), 256, 0,
                       s>>>(best, static_cast<long long>(bp) * kkp,
                            static_cast<float*>(out_keys),
                            static_cast<int*>(out_rows));
  return static_cast<int>(cudaGetLastError());
}

// kmeans_assign: xc (n, k) = x·cᵀ; x2 (n,) and c2 (k,) are scratch.
int kmeans_assign(const void* x, const void* c, const void* xc, long long n,
                  int k, int d, void* x2, void* c2, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_norms_kernel<<<grid1(n, 256), 256, 0, s>>>(
      static_cast<const float*>(x), n, d, static_cast<float*>(x2));
  row_norms_kernel<<<grid1(k, 256), 256, 0, s>>>(
      static_cast<const float*>(c), k, d, static_cast<float*>(c2));
  kmeans_assign_kernel<<<grid1(n * 32, 256), 256, 0, s>>>(
      static_cast<const float*>(xc), static_cast<const float*>(x2),
      static_cast<const float*>(c2), n, k, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of kmeans_update's one buffer at (n, k, d): every word of it is
// set by the call.
long long kmeans_bytes(long long n, int k, int d) {
  return km_plan(n, k, d).bytes;
}

// kmeans_update: x (n, d), assign (n,) i32 in [0, k), old (k, d); buf
// (kmeans_bytes) is the call's scratch, unset; out (k, d) the new
// centroids. Four launches, no blocking call.
int kmeans_update(const void* x, const void* assign, const void* old,
                  long long n, int k, int d, void* buf, void* out,
                  void* stream) {
  if (n < 1 || k < 1 || d < 1 || n > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  allow_smem();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KmPlan p = km_plan(n, k, d);
  KmArgs a = km_carve(buf, p, n, k, d);
  a.x = static_cast<const float*>(x);
  a.assign = static_cast<const int*>(assign);
  a.old = static_cast<const float*>(old);
  a.out = static_cast<float*>(out);
  a.smem = k <= KM_SMEM_K;
  a.vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned nb = static_cast<unsigned>(sel::ceil_div(p.pw, KM_WARPS));
  const size_t sm = a.smem ? KM_WARPS * static_cast<size_t>(k) * 4 : 0;
  km_hist_kernel<<<nb, KM_WARPS * 32, sm, s>>>(a);
  km_prefix_kernel<<<static_cast<unsigned>(sel::ceil_div(k, 32)),
                     dim3(32, 32), 0, s>>>(a);
  km_scatter_kernel<<<nb, KM_WARPS * 32, sm, s>>>(a);
  km_chunk_kernel<<<static_cast<unsigned>(
                        sel::ceil_div(p.nchunk, KM_CHUNK_WARPS)),
                    KM_CHUNK_WARPS * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The keys buffer `which` (0: the first, 1: the second) of select.cuh's
// levels must hold for `rows` rows of n keys in sorted runs of `run`,
// cut to `keep` from tiles of at least `floor` (sel::level_caps): what
// ops/select.py `scratch` mirrors, for the card test that holds the two
// against each other.
long long select_cap(long long rows, long long n, long long run,
                     long long keep, int floor, int which) {
  long long cap_a, cap_b;
  sel::level_caps(rows, n, run, keep, floor, cap_a, cap_b);
  return which ? cap_b : cap_a;
}

}  // extern "C"
