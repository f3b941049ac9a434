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
//    Replaces `maxsim_program` (:272). One block per doc lane. The batch's
//    (query, query token) pairs are taken 256 at a time; for each such
//    group the doc's tokens stream through shared memory in tiles of at
//    most 32 (through the slot map), and each pair keeps a running max
//    over them (NaN propagates). A pair's dot product with a token is
//    accumulated in dim tiles of `tile` (a chain within the tile, the
//    tiles added in order). Then each query's maxima are summed over s in
//    order; key = -score + 0.0, empty and pad docs +inf. Shared memory
//    depends on the width alone, never on the doc's length. Then the
//    selection. Bound: operations — B*S*T*dp multiply-adds a doc.
// 3. kmeans_assign
//    Replaces `_assign_program` (:187) and the argmin of `_kmeans_program`
//    (:157), less the x·cᵀ product, which the wrapper takes from
//    torch.matmul (TF32 off): d = (‖x‖² − 2·xc) + ‖c‖² in the reference's
//    order (the norms as chains), argmin over centroids with the lowest
//    index on ties and the first NaN winning, as jnp.argmin. One warp a row.
//    Bound: bytes — the (N, K) product is read once.
// 4. kmeans_update
//    Replaces the centroid update of `_kmeans_program`: the one-hot product
//    becomes per-block partial sums, each block adding its R rows in row
//    order into its own (K, D) plane (a thread owns a dimension, so no cell
//    is shared), then a fold over the planes in block order; integer counts
//    by atomics; centroid = sum / max(count, 1), or the old centroid where
//    the count is 0. No (N, K) one-hot matrix is built. Bound: bytes.

#include "select.cuh"

namespace {

using sel::u64;

constexpr int STAGE_FLOOR = 2048;  // smallest tile a stage block keys
constexpr int MAXSIM_THREADS = 256;
constexpr int MAXSIM_PAIRS = 256;   // (query, query token) pairs a pass holds
constexpr int MAXSIM_TOKENS = 32;   // most doc tokens a tile holds
constexpr int M_L2 = 0, M_IP = 1, M_COS = 2;
constexpr uint32_t PAD_ROW = 0x7FFFFFFFu;
constexpr u64 DEAD = (static_cast<u64>(0xFF800000u) << 32) | PAD_ROW;
constexpr u64 NO_KEY = sel::NO_KEY;  // tile padding: above every real key
constexpr long long MAX_SMEM = 200 * 1024;

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

// MaxSim: one block per doc lane, every query of the batch. Pair p of the
// batch is (query p / sp, query token p % sp); its tokens start at
// queries + p * dp.
__global__ void __launch_bounds__(MAXSIM_THREADS)
    maxsim_docs_kernel(const float* __restrict__ region,
                       const int* __restrict__ slotmap,
                       const int* __restrict__ offsets,
                       const int* __restrict__ counts,
                       const int* __restrict__ rowids,
                       const float* __restrict__ queries,
                       const int* __restrict__ dmap, long long nlanes, int bp,
                       int sp, int dp, int tile, int TT,
                       u64* __restrict__ keys) {
  extern __shared__ float fsm[];
  const int xs = dp + 1;  // padded token stride: no bank conflicts on t
  float* x = fsm;                       // (TT, dp + 1) doc tokens
  float* sim = x + TT * xs;             // (MAXSIM_PAIRS, TT)
  float* m = sim + MAXSIM_PAIRS * TT;   // (MAXSIM_PAIRS,) running maxima
  const long long lane = blockIdx.x;
  const int doc = dmap[lane];
  const int cnt = counts[doc];
  const long long base = offsets[doc];
  const uint32_t row = static_cast<uint32_t>(rowids[doc]);
  const long long npairs = static_cast<long long>(bp) * sp;
  float score = 0.0f;  // thread 0's running sum over a query's tokens
  for (long long p0 = 0; p0 < npairs; p0 += MAXSIM_PAIRS) {
    const int np = static_cast<int>(
        npairs - p0 < MAXSIM_PAIRS ? npairs - p0 : MAXSIM_PAIRS);
    __syncthreads();  // thread 0 has read the last group's maxima
    for (int i = threadIdx.x; i < np; i += blockDim.x)
      m[i] = __uint_as_float(0xFF800000u);  // -inf: no live token
    for (int t0 = 0; t0 < cnt; t0 += TT) {
      const int nt = cnt - t0 < TT ? cnt - t0 : TT;
      __syncthreads();  // the last tile's readers are done
      for (int e = threadIdx.x; e < nt * dp; e += blockDim.x) {
        const int t = e / dp, d = e - t * dp;
        const long long slot = slotmap[base + t0 + t];
        x[t * xs + d] = region[slot * dp + d];
      }
      __syncthreads();
      for (int e = threadIdx.x; e < np * nt; e += blockDim.x) {
        const int p = e / nt, t = e - p * nt;
        const float* xt = x + t * xs;
        const float* qs = queries + (p0 + p) * dp;
        float acc = 0.0f;
        for (int i0 = 0; i0 < dp; i0 += tile) {
          float part = __fmul_rn(xt[i0], qs[i0]);
          for (int d = i0 + 1; d < i0 + tile; ++d)
            part = __fadd_rn(part, __fmul_rn(xt[d], qs[d]));
          acc = __fadd_rn(acc, part);
        }
        sim[p * TT + t] = acc;
      }
      __syncthreads();
      for (int p = threadIdx.x; p < np; p += blockDim.x) {
        float best = m[p];
        for (int t = 0; t < nt && best == best; ++t)
          best = nan_max(sim[p * TT + t], best);
        m[p] = best;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int p = 0; p < np; ++p) {
        score = __fadd_rn(score, m[p]);
        const long long g = p0 + p;
        if (g % sp == sp - 1) {
          const float key = __fadd_rn(-score, 0.0f);
          keys[(g / sp) * nlanes + lane] = make_key(asc_image(key), row);
          score = 0.0f;
        }
      }
    }
  }
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

// Block b adds rows [b*R, (b+1)*R) in row order into its own (K, D) plane.
__global__ void kmeans_partial_kernel(const float* __restrict__ x,
                                      const int* __restrict__ assign,
                                      long long n, int d, int k, long long R,
                                      float* __restrict__ part,
                                      int* __restrict__ counts) {
  const long long b = blockIdx.x;
  const long long r0 = b * R;
  const long long r1 = r0 + R < n ? r0 + R : n;
  float* plane = part + b * k * static_cast<long long>(d);
  for (long long r = r0; r < r1; ++r) {
    const int c = assign[r];
    float* cell = plane + static_cast<long long>(c) * d;
    const float* xr = x + r * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x)
      cell[j] = __fadd_rn(cell[j], xr[j]);
    if (threadIdx.x == 0) atomicAdd(&counts[c], 1);
  }
}

__global__ void kmeans_fold_kernel(const float* __restrict__ part,
                                   long long nb, int k, int d,
                                   const int* __restrict__ counts,
                                   const float* __restrict__ old,
                                   float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long kd = static_cast<long long>(k) * d;
  if (e >= kd) return;
  float s = 0.0f;
  for (long long b = 0; b < nb; ++b) s = __fadd_rn(s, part[b * kd + e]);
  const int cnt = counts[e / d];
  out[e] = cnt > 0 ? __fdiv_rn(s, static_cast<float>(cnt)) : old[e];
}

unsigned grid1(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

long long maxsim_smem(int TT, int dp) {
  return (static_cast<long long>(TT) * (dp + 1) +
          static_cast<long long>(MAXSIM_PAIRS) * TT + MAXSIM_PAIRS) *
         static_cast<long long>(sizeof(float));
}

void allow_smem() {
  static bool done = false;
  if (done) return;
  const int keys = sel::TMAX * static_cast<int>(sizeof(u64));
  cudaFuncSetAttribute(probe_lists_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, keys);
  cudaFuncSetAttribute(probe_lanes_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, keys);
  cudaFuncSetAttribute(maxsim_docs_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(MAX_SMEM));
  done = true;
}

// Doc tokens one maxsim tile holds at width dp: at most 32, as many as fit
// the shared memory; 0 when not one token fits (ops/vector_kernels.py
// mirrors it).
int maxsim_tile_tokens(int dp) {
  int tt = MAXSIM_TOKENS;
  while (tt > 0 && maxsim_smem(tt, dp) > MAX_SMEM) --tt;
  return tt;
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
// zero-count doc). `keys` (cap_a >= bp * nlanes keys) and buf_b (cap_b)
// are the levels' scratch; the (bp, kkp) keys (negated scores) and rows go
// to the outputs.
int maxsim(const void* region, const void* slotmap, const void* offsets,
           const void* counts, const void* rowids, const void* queries,
           const void* dmap, long long nlanes, int bp, int sp, int dp,
           int tile, int kkp, void* keys, long long cap_a, void* buf_b,
           long long cap_b, void* out_keys, void* out_rows, void* stream) {
  const int TT = maxsim_tile_tokens(dp);
  if (TT < 1 || kkp < 1 || tile < 1 || dp % tile ||
      static_cast<long long>(bp) * nlanes > cap_a)
    return static_cast<int>(cudaErrorInvalidValue);
  allow_smem();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  maxsim_docs_kernel<<<static_cast<unsigned>(nlanes), MAXSIM_THREADS,
                       static_cast<int>(maxsim_smem(TT, dp)), s>>>(
      static_cast<const float*>(region), static_cast<const int*>(slotmap),
      static_cast<const int*>(offsets), static_cast<const int*>(counts),
      static_cast<const int*>(rowids), static_cast<const float*>(queries),
      static_cast<const int*>(dmap), nlanes, bp, sp, dp, tile, TT,
      static_cast<u64*>(keys));
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

// kmeans_update: part (ceil(n / R), k, d) and counts (k,) zeroed by the
// wrapper; out (k, d) the new centroids.
int kmeans_update(const void* x, const void* assign, const void* old,
                  long long n, int k, int d, long long R, void* part,
                  void* counts, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = sel::ceil_div(n, R);
  int threads = 32;
  while (threads < d && threads < 256) threads <<= 1;
  kmeans_partial_kernel<<<static_cast<unsigned>(nb), threads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int*>(assign), n, d, k,
      R, static_cast<float*>(part), static_cast<int*>(counts));
  const long long kd = static_cast<long long>(k) * d;
  kmeans_fold_kernel<<<grid1(kd, 256), 256, 0, s>>>(
      static_cast<const float*>(part), nb, k, d,
      static_cast<const int*>(counts), static_cast<const float*>(old),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
