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
//    Stage 1: one thread per (query, list) computes the centroid distance;
//    lists at or past l_real read +inf; the nprobe nearest are kept in
//    `lax.top_k(-d)` order (NaN first, then distance asc, list asc).
//    Stage 2: one thread per lane of the (nchunks, mc) probe grid maps
//    tmap/jmap -> probe slot -> list -> logical position -> slotmap ->
//    region row, scores the row and keys it; lanes past a list's count are
//    dead. Each stage's block keys one tile of lists or lanes in shared
//    memory and keeps its smallest (select.cuh's first level); the query
//    is read from device memory (every thread reads the same word, one
//    broadcast). Bound: bytes — the gathered rows (dp floats each, read
//    once a query) dominate.
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

constexpr int STAGE_FLOOR = 2048;  // smallest tile a stage block keys
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

// dist_tail_expr over dp dims, then + 0.0.
__device__ float dist_chain(const float* __restrict__ x,
                           const float* __restrict__ q, int dp, int metric) {
  if (metric == M_L2) {
    float dv = __fsub_rn(x[0], q[0]);
    float acc = __fmul_rn(dv, dv);
    for (int j = 1; j < dp; ++j) {
      dv = __fsub_rn(x[j], q[j]);
      acc = __fadd_rn(acc, __fmul_rn(dv, dv));
    }
    return __fadd_rn(acc, 0.0f);
  }
  if (metric == M_IP) {
    float acc = __fmul_rn(x[0], q[0]);
    for (int j = 1; j < dp; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j], q[j]));
    return __fadd_rn(-acc, 0.0f);
  }
  float xx = __fmul_rn(x[0], x[0]);
  float qq = __fmul_rn(q[0], q[0]);
  float dot = __fmul_rn(x[0], q[0]);
  for (int j = 1; j < dp; ++j) {
    xx = __fadd_rn(xx, __fmul_rn(x[j], x[j]));
    qq = __fadd_rn(qq, __fmul_rn(q[j], q[j]));
    dot = __fadd_rn(dot, __fmul_rn(x[j], q[j]));
  }
  const float den = nan_max(__fmul_rn(__fsqrt_rn(xx), __fsqrt_rn(qq)), 1e-9f);
  return __fadd_rn(__fsub_rn(1.0f, __fdiv_rn(dot, den)), 0.0f);
}

// Stage 1 of ivf_probe: the keys of one tile of lists for one query.
__global__ void __launch_bounds__(sel::THREADS)
    probe_lists_kernel(const float* __restrict__ cents,
                       const float* __restrict__ queries, int lp, int l_real,
                       int dp, int metric, int T, int K, long long ntiles,
                       u64* __restrict__ out) {
  extern __shared__ u64 keys[];
  const long long qi = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const float* q = queries + qi * dp;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const long long l = tile * T + i;
    u64 key = NO_KEY;
    if (l < lp) {
      const float d = l < l_real
                          ? dist_chain(cents + l * dp, q, dp, metric)
                          : __uint_as_float(0x7F800000u);
      key = make_key(list_image(d), static_cast<uint32_t>(l));
    }
    keys[i] = key;
  }
  sel::keep_smallest(keys, T, K, out + (qi * ntiles + tile) * K);
}

struct ProbeArgs {
  const float* region;
  const int* slotmap;
  const int* offsets;
  const int* counts;
  const int* rowids;
  const float* queries;
  const int* probe;  // (qp, nprobe) list ids
  const int* tmap;
  const int* jmap;
  long long nlanes;
  int nprobe, dp, metric;
};

// Stage 2 of ivf_probe: the keys of one tile of probe-grid lanes for one
// query.
__global__ void __launch_bounds__(sel::THREADS)
    probe_lanes_kernel(ProbeArgs a, int T, int K, long long ntiles,
                       u64* __restrict__ out) {
  extern __shared__ u64 keys[];
  const long long qi = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const float* q = a.queries + qi * a.dp;
  const int* probe = a.probe + qi * a.nprobe;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const long long l = tile * T + i;
    u64 key = DEAD;
    if (l < a.nlanes) {
      const int cl = probe[a.tmap[l]];
      const int j = a.jmap[l];
      if (j < a.counts[cl]) {
        const long long pos = static_cast<long long>(a.offsets[cl]) + j;
        const long long slot = a.slotmap[pos];
        const float d = dist_chain(a.region + slot * a.dp, q, a.dp, a.metric);
        key = make_key(asc_image(d), static_cast<uint32_t>(a.rowids[pos]));
      }
    }
    keys[i] = key;
  }
  sel::keep_smallest(keys, T, K, out + (qi * ntiles + tile) * K);
}

__global__ void lists_finish_kernel(const u64* __restrict__ keys, long long n,
                                    int* __restrict__ probe) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < n) probe[i] = static_cast<int>(keys[i] & 0xFFFFFFFFull);
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
  const int keys = sel::TMAX * static_cast<int>(sizeof(u64));
  cudaFuncSetAttribute(probe_lists_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, keys);
  cudaFuncSetAttribute(probe_lanes_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, keys);
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
// offsets/counts (lp,), cents (lp, dp), queries (qp, dp), tmap/jmap
// (nlanes,) i32. Stage 1 keeps nprobe lists and writes them to `probe`
// (qp, nprobe); stage 2 keeps kkp keys. buf_a (cap_a keys) and buf_b
// (cap_b keys) are the wrapper's scratch for both stages' levels
// (ops/select.py). Outputs (qp, kkp) distances and rows.
int ivf_probe(const void* region, const void* slotmap, const void* offsets,
              const void* counts, const void* rowids, const void* cents,
              const void* queries, const void* tmap, const void* jmap,
              int qp, int dp, int lp, int l_real, int nprobe, long long nlanes,
              int kkp, int metric, void* probe, void* buf_a, long long cap_a,
              void* buf_b, long long cap_b, void* out_dist, void* out_rows,
              void* stream) {
  if (nprobe < 1 || kkp < 1 || nprobe > l_real || l_real > lp)
    return static_cast<int>(cudaErrorInvalidValue);
  allow_smem();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* a = static_cast<u64*>(buf_a);
  u64* b = static_cast<u64*>(buf_b);
  const int t1 = sel::tile_for(nprobe, STAGE_FLOOR);
  const int keep1 = nprobe < t1 ? nprobe : t1;
  const long long nt1 = sel::ceil_div(lp, t1);
  if (static_cast<long long>(qp) * nt1 * keep1 > cap_a)
    return static_cast<int>(cudaErrorInvalidValue);
  probe_lists_kernel<<<static_cast<unsigned>(qp * nt1), sel::THREADS,
                       t1 * sizeof(u64), s>>>(
      static_cast<const float*>(cents), static_cast<const float*>(queries), lp,
      l_real, dp, metric, t1, keep1, nt1, a);
  const u64* lists = sel::levels(a, cap_a, b, cap_b, qp, nt1 * keep1, keep1,
                                 nprobe, STAGE_FLOOR, s);
  if (!lists) return static_cast<int>(cudaErrorInvalidValue);
  lists_finish_kernel<<<grid1(static_cast<long long>(qp) * nprobe, 256), 256,
                        0, s>>>(lists, static_cast<long long>(qp) * nprobe,
                                static_cast<int*>(probe));
  ProbeArgs pa{static_cast<const float*>(region),
               static_cast<const int*>(slotmap),
               static_cast<const int*>(offsets),
               static_cast<const int*>(counts),
               static_cast<const int*>(rowids),
               static_cast<const float*>(queries),
               static_cast<const int*>(probe),
               static_cast<const int*>(tmap),
               static_cast<const int*>(jmap),
               nlanes, nprobe, dp, metric};
  const int t2 = sel::tile_for(kkp, STAGE_FLOOR);
  const int keep2 = kkp < t2 ? kkp : t2;
  const long long nt2 = sel::ceil_div(nlanes, t2);
  if (static_cast<long long>(qp) * nt2 * keep2 > cap_a)
    return static_cast<int>(cudaErrorInvalidValue);
  probe_lanes_kernel<<<static_cast<unsigned>(qp * nt2), sel::THREADS,
                       t2 * sizeof(u64), s>>>(pa, t2, keep2, nt2, a);
  const u64* best = sel::levels(a, cap_a, b, cap_b, qp, nt2 * keep2, keep2,
                                kkp, STAGE_FLOOR, s);
  if (!best) return static_cast<int>(cudaErrorInvalidValue);
  keys_finish_kernel<<<grid1(static_cast<long long>(qp) * kkp, 256), 256, 0,
                       s>>>(best, static_cast<long long>(qp) * kkp,
                            static_cast<float*>(out_dist),
                            static_cast<int*>(out_rows));
  return static_cast<int>(cudaGetLastError());
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
