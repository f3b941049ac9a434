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
// `_ragged_candidates`), `w[q, e]` its term weight. A term touches a doc
// once, so no two entries of one slice share a lane. The reference
// gathers through an inverse map (qp x tp x cp int32, 268 MB at 64
// two-term queries on a 1M-doc corpus); the forward map needs one int per
// kept posting.
//
// Two regimes, picked by the wrapper from (cp, kk) alone
// (ops/pool_kernels.py `pool_regime` mirrors POOL_ROW_LANES and
// POOL_ROW_KK; the entry refuses a disagreement):
//
// ROW (cp <= POOL_ROW_LANES, kk <= POOL_ROW_KK): one launch, a thread-block
// cluster of c blocks a query (`row_cluster`: doubled up to 8 while a block
// would hold more than ROW_BLOCK_LANES lanes, then halved while the launch
// would not fit the card in one wave). One block a query measured 0.03 ms on an
// H100 at the main path's 64-query batch, its largest row's dependent loads in
// series on one SM; the cluster spreads each row over c SMs. Block r holds
// lanes r * L .. r * L + L of its query's accumulator in shared memory and
// zeroes them (nc[q] lanes in all; cp in partial mode). Slice t = 0 .. tp-1 in
// order: the cluster's blocks take the slice's entries in turn, four a thread
// (one 16-byte load each of slot, weight and lane where aligned), gather (doc,
// tf) at the slot and the doc's norm, and add contrib() into the lane's block —
// its own shared memory or another's, through distributed shared memory — with
// a plain `+=`: no two entries of a slice share a lane, and a cluster barrier
// after each slice stands for the stream order between launches. Each lane thus
// sums its terms in slice order from +0.0 — the host path's `acc[ix] += c`, bit
// for bit. Full mode then selects, in each block, the kk best of its live
// lanes: a radix select (8 bits a pass, six at most: 11-bit bins cost more to
// pick from than their fewer passes saved; shared-memory histograms,
// cand::warp_pick) over the 48-bit key (score image << 16 | 0xFFFF - local
// lane), stopping at the first pass whose chosen bin is taken whole; the keys
// at or above it go to the block's candidate run (cand::append) as sort keys
// (~image, global lane). The first block reads the c runs (at most 8 x 32 keys)
// through distributed shared memory and places each of the row's kk by its rank
// among them, with no sort; only the winners read `cand`. The candidates ascend
// (searcher `_ragged_candidates`), so lane order is doc order and this is
// lax.top_k's tie order; -0.0 ranks and is written as +0.0. Partial mode writes
// each block's lanes of the row of acc, zeros included: no memset, no key
// array, no host slice_max, no copy in.
//
// LARGE (a row or kk past what the ROW regime holds): one launch per
// slice index t over every query's entries of slice t into acc in device
// memory (zeroed by the caller; launches in stream order keep each lane's
// add order), then, in full mode, one 64-bit key a lane — the
// complemented order-preserving image of the score high, the doc low;
// dead lanes (lane >= nc[q]) score -inf with the doc 0x7FFFFFFF — and
// select.cuh's levels over the keys.
//
// Bound: bytes — per kept posting its slot, weight and lane (12 bytes),
// the (doc, tf) pair it gathers (8) and its doc's norm (4); each live
// lane's candidate doc; the outputs. The ROW regime moves less than that
// (its accumulator stays in the cluster's shared memory, and it reads
// only the winners' docs); the LARGE regime adds a read-modify-write of a
// lane per posting and the keys' round trips.

#include <cooperative_groups.h>

#include "contrib.cuh"
#include "select.cuh"
#include "warp_cand.cuh"

namespace cg = cooperative_groups;

#define POOL_THREADS 256
#define POOL_SORT_FLOOR 32  // smallest tile of the selection levels
#define PAD_DOC 0x7FFFFFFF

// The ROW regime (ops/pool_kernels.py mirrors POOL_ROW_KK and
// POOL_ROW_LANES).
#define ROW_THREADS 512
#define ROW_HIST 256           // bins of a select pass: 8 bits
#define ROW_MISC 64            // the block's small state, last in shared memory
#define ROW_SMEM 232448        // shared memory one block may take on sm_90
#define ROW_LANES_MAX 65536    // lanes a block holds: a local lane fits 16 bits
// most kk a row selects, from card timings (H100 80GB HBM3, 700 W; one
// query of 19,048 lanes, device time against LARGE's): kk 1,000 1.26x
// and kk 8,192 2.0x (a cluster's merge or one block's selection of that
// many keys), where kk 10 on the main path's query took 0.63x; up to 32
// the merge ranks 8 runs of 32 keys in one pass
#define POOL_ROW_KK 32
#define ROW_CLUSTER_MAX 8      // most blocks a query (a portable cluster)
#define ROW_BLOCK_LANES 2048   // a cluster grows while a block holds more
#define ROW_BLOCKS_SM 2        // ROW blocks an SM keeps resident
// most lanes a row may have in the ROW regime, from card timings (NVIDIA
// H100 80GB HBM3, 700 W; rows of two slices over every lane, k 10;
// device time against LARGE's): at 8 and 64 queries 0.42-0.65x at 19,048
// and at 56,048 lanes; alone, 1.15x at 19,048 lanes and 1.51x at 56,048
// (one slice: 0.87x and 1.13x). Rows past the largest size timed in ROW
// keep LARGE, timed up to RAGGED_ENTRY_CAP kept postings.
#define POOL_ROW_LANES 56048

typedef unsigned long long u64;

__host__ __device__ constexpr long long pow2_at_least(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Lanes each block of a query holds (a multiple of 4).
__host__ __device__ constexpr long long row_lanes(long long cp, int c) {
  return ((cp + c - 1) / c + 3) / 4 * 4;
}

// Bytes of the select region: the histogram, or the cluster's candidate
// keys (c runs of kk's power of two), whichever is larger (they never
// live at once); none in partial mode.
__host__ __device__ constexpr long long row_sel_bytes(long long kk, int c) {
  return kk <= 0 ? 0
                 : (8LL * c * pow2_at_least(kk) > 4 * ROW_HIST
                        ? 8LL * c * pow2_at_least(kk)
                        : 4 * ROW_HIST);
}

// Shared-memory bytes of a block of a ROW launch of c blocks a query.
__host__ __device__ constexpr long long row_bytes(long long cp, long long kk,
                                                  int c) {
  return 4 * row_lanes(cp, c) + row_sel_bytes(kk, c) + ROW_MISC;
}

// At the caps, one block a query holds a whole row: every cluster size
// fits, and a local lane fits 16 bits.
static_assert(row_bytes(POOL_ROW_LANES, POOL_ROW_KK, 1) <= ROW_SMEM &&
                  row_bytes(POOL_ROW_LANES, POOL_ROW_KK, ROW_CLUSTER_MAX) <=
                      ROW_SMEM,
              "a ROW block's shared memory");
static_assert(row_lanes(POOL_ROW_LANES, 1) <= ROW_LANES_MAX,
              "a ROW block's local lanes");

static bool is_row(long long cp, long long kk) {
  return cp > 0 && cp <= POOL_ROW_LANES && kk >= 0 && kk <= POOL_ROW_KK;
}

// Blocks a query takes (a cluster) in a launch of qp queries: doubled, up
// to ROW_CLUSTER_MAX, while a block would hold more than ROW_BLOCK_LANES
// lanes; then halved while the launch has more blocks than the card keeps
// resident at once (at 64 queries of 19,048 lanes on an H100, 8 blocks a
// query in two waves took twice as long as 2 in one).
static int row_cluster(long long qp, long long cp) {
  static int sms[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = sms[dev & 15];
  if (!n) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  int c = 1;
  while (c < ROW_CLUSTER_MAX && (cp + c - 1) / c > ROW_BLOCK_LANES) c <<= 1;
  while (c > 1 && qp * c > (long long)ROW_BLOCKS_SM * n) c >>= 1;
  return c;
}

// Order-preserving u32 image of a score, -0.0 as +0.0: larger is better.
__device__ __forceinline__ unsigned score_image(float s) {
  unsigned u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The score an image stands for (-0.0 comes back as +0.0).
__device__ __forceinline__ float image_score(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// The select key of a block's local lane l: its largest are (score desc,
// lane asc).
__device__ __forceinline__ u64 select_key(float s, int l) {
  return ((u64)score_image(s) << 16) | (unsigned)(0xFFFF - l);
}

// The block's small state (within ROW_MISC bytes).
struct RowState {
  u64 prefix, mask;  // the select key's bits fixed so far
  unsigned rem;      // keys still to take among those at the prefix
  unsigned done;     // the prefix's keys are taken whole
  unsigned count;    // keys appended
};

// One radix-select pass over bits [sh, sh + 8) of the select keys of the
// n lanes in acc: counts the keys that match the prefix so far, picks the
// bin of the rem-th largest (cand::warp_pick) and narrows the prefix.
__device__ __forceinline__ void select_pass(const float* acc, int n, int sh,
                                            unsigned* hist, RowState* st) {
  constexpr int BINS = ROW_HIST;
  for (int i = threadIdx.x; i < BINS; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const u64 prefix = st->prefix, mask = st->mask;
  for (int l = threadIdx.x; l < n; l += blockDim.x) {
    const u64 k = select_key(acc[l], l);
    if ((k & mask) == prefix) atomicAdd(&hist[(k >> sh) & (BINS - 1)], 1u);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned above;
    const unsigned bin = cand::warp_pick<BINS / 32>(hist, st->rem, above);
    if (threadIdx.x == 0) {
      const unsigned rem = st->rem - above;
      st->prefix = prefix | ((u64)bin << sh);
      st->mask = mask | ((u64)(BINS - 1) << sh);
      st->rem = rem;
      st->done = hist[bin] == rem;
    }
  }
  __syncthreads();
}

// The `take` best of a block's n local lanes (take <= n) as sort keys
// (~score image high, global lane lo + l low: ascending is score desc,
// lane asc) in keys[0, take), in no order.
__device__ void block_best(const float* acc, int n, int take, long long lo,
                           unsigned* hist, u64* keys, RowState* st) {
  if (threadIdx.x == 0) {
    st->prefix = 0;
    st->mask = 0;
    st->rem = (unsigned)take;
    st->done = 0;
    st->count = 0;
  }
  __syncthreads();
  for (int sh = 40; sh >= 0 && !st->done; sh -= 8)
    select_pass(acc, n, sh, hist, st);
  const u64 prefix = st->prefix, mask = st->mask;
  for (int l0 = 0; l0 < n; l0 += blockDim.x) {
    const int l = l0 + threadIdx.x;
    bool f = false;
    u64 key = 0;
    if (l < n) {
      const float s = acc[l];
      f = (select_key(s, l) & mask) >= prefix;
      key = ((u64)(~score_image(s)) << 32) | (unsigned)(lo + l);
    }
    cand::append(f, key, &st->count, keys);
  }
}

// A cluster of `c` blocks a query (block r of query q holds its lanes
// r * L .. r * L + L in shared memory); the blocks take each slice's
// entries in turn and add each into the block that holds its lane. kk >
// 0: each block's best kk go to its candidate run, the first block
// gathers the c runs through distributed shared memory and places the
// row's top kk by rank; kk == 0: each block writes its lanes of the row
// of acc_out.
template <int SCORER>
__global__ void __launch_bounds__(ROW_THREADS, ROW_BLOCKS_SM)
    pool_row_kernel(const int* __restrict__ docs_pg,
                    const int* __restrict__ tfs_pg,
                    const int* __restrict__ norms,
                    const int* __restrict__ si, const float* __restrict__ w,
                    const int* __restrict__ lane,
                    const int* __restrict__ soff, int tp, long long ep,
                    int cp, float k1, float b, float avg,
                    const int* __restrict__ cand, const int* __restrict__ nc,
                    int kk, int L, int sel_bytes,
                    float* __restrict__ acc_out, float* __restrict__ vals,
                    int* __restrict__ docs) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  float* acc = reinterpret_cast<float*>(smem);
  unsigned char* sel = smem + 4LL * L;
  RowState* st = reinterpret_cast<RowState*>(sel + sel_bytes);
  const long long q = blockIdx.x / c;
  const int n = kk > 0 ? min(nc[q], cp) : cp;
  const int lo = r * L;
  const int nl = max(0, min(L, n - lo));  // this block's live lanes
  for (int i = threadIdx.x; i < (nl + 3) / 4; i += blockDim.x)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  cluster.sync();  // every block's lanes are zero before any add lands

  // the slices in order, a cluster barrier after each; the cluster's
  // blocks take the slice's entries in turn, four at a time, and add each
  // into the block that holds its lane (its own shared memory or another
  // block's, through distributed shared memory)
  const bool vec = (((size_t)si | (size_t)w | (size_t)lane) & 15) == 0;
  const int* so = soff + q * (tp + 1);
  const long long step = 4LL * blockDim.x * c;
  for (int t = 0; t < tp && n > 0; ++t) {
    const long long e0 = q * ep + so[t], e1 = q * ep + so[t + 1];
    for (long long g = (e0 & ~3LL) + 4LL * (r * blockDim.x + threadIdx.x);
         g < e1; g += step) {
      int sl[4], ln[4];
      float wt[4];
      if (vec && g >= e0 && g + 4 <= e1) {
        const int4 x = *reinterpret_cast<const int4*>(si + g);
        const float4 y = *reinterpret_cast<const float4*>(w + g);
        const int4 z = *reinterpret_cast<const int4*>(lane + g);
        sl[0] = x.x, sl[1] = x.y, sl[2] = x.z, sl[3] = x.w;
        wt[0] = y.x, wt[1] = y.y, wt[2] = y.z, wt[3] = y.w;
        ln[0] = z.x, ln[1] = z.y, ln[2] = z.z, ln[3] = z.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = g + j >= e0 && g + j < e1;
          sl[j] = in ? si[g + j] : 0;
          wt[j] = in ? w[g + j] : 0.f;
          ln[j] = in ? lane[g + j] : -1;
        }
      }
      int d[4], tf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = (unsigned)ln[j] < (unsigned)n;
        d[j] = live ? docs_pg[sl[j]] : 0;
        tf[j] = live ? tfs_pg[sl[j]] : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((unsigned)ln[j] >= (unsigned)n) continue;
        const float v = contrib(SCORER, (float)tf[j], (float)norms[d[j]],
                                wt[j], k1, b, avg);
        const int owner = ln[j] / L;
        float* cell = owner == r ? acc : cluster.map_shared_rank(acc, owner);
        cell[ln[j] - owner * L] += v;
      }
    }
    cluster.sync();
  }

  if (kk <= 0) {  // partial mode: this block's lanes, zeros included
    float* out = acc_out + q * cp + lo;
    for (int l = threadIdx.x; l < nl; l += blockDim.x) out[l] = acc[l];
    return;
  }
  // this block's best into its candidate run (pads after them)
  const int p2 = (int)pow2_at_least(kk);
  u64* keys = reinterpret_cast<u64*>(sel);
  const int mine = min(kk, nl);
  if (mine > 0) block_best(acc, nl, mine, lo, reinterpret_cast<unsigned*>(sel),
                           keys, st);
  __syncthreads();
  for (int i = mine + threadIdx.x; i < p2; i += blockDim.x) keys[i] = ~0ull;
  cluster.sync();
  if (r == 0) {  // the cluster's runs, one after another
    for (int o = 1; o < c; ++o) {
      const u64* run = cluster.map_shared_rank(keys, o);
      for (int i = threadIdx.x; i < p2; i += blockDim.x)
        keys[o * p2 + i] = run[i];
    }
  }
  cluster.sync();  // no block leaves while its run may still be read
  if (r != 0) return;
  const int take = min(kk, n), m = c * p2;
  float* vrow = vals + q * kk;
  int* drow = docs + q * kk;
  // each key's rank among the m (the real keys are unique and every pad
  // ranks after them, at or past take): one pass, no sort
  if (threadIdx.x < m) {
    const u64 key = keys[threadIdx.x];
    int rank = 0;
    for (int j = 0; j < m; ++j) rank += keys[j] < key;
    if (rank < take) {
      vrow[rank] = image_score(~(unsigned)(key >> 32));
      drow[rank] = cand[q * cp + (unsigned)(key & 0xFFFFFFFFull)];
    }
  }
  for (int i = take + threadIdx.x; i < kk; i += blockDim.x) {
    vrow[i] = __int_as_float(0xff800000);  // -inf
    drow[i] = PAD_DOC;
  }
}

// The LARGE regime: slice t of every query into acc in device memory.
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
  keys[i] = ((unsigned long long)(~score_image(s)) << 32) | d;
}

__global__ void pool_write_kernel(const unsigned long long* __restrict__ sorted,
                                  long long n, float* __restrict__ vals,
                                  int* __restrict__ docs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = sorted[i];
  vals[i] = image_score(~(unsigned)(key >> 32));
  docs[i] = (int)(unsigned)(key & 0xFFFFFFFFull);
}

static inline unsigned grid_for(long long threads, int block) {
  return (unsigned)((threads + block - 1) / block);
}

// Launch the ROW regime: qp clusters of c blocks.
template <int SCORER>
static cudaError_t launch_row(const void* docs_pg, const void* tfs_pg,
                              const void* norms, const void* si,
                              const void* w, const void* lane,
                              const void* soff, long long qp, long long ep,
                              int tp, long long cp, float k1, float b,
                              float avg, void* acc, const void* cand,
                              const void* nc, int kk, int c, long long smem,
                              void* vals, void* docs, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        pool_row_kernel<SCORER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ROW_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(qp * c));
  cfg.blockDim = dim3(ROW_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)c;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, pool_row_kernel<SCORER>, (const int*)docs_pg,
      (const int*)tfs_pg, (const int*)norms, (const int*)si, (const float*)w,
      (const int*)lane, (const int*)soff, tp, ep, (int)cp, k1, b, avg,
      (const int*)cand, (const int*)nc, kk, (int)row_lanes(cp, c),
      (int)row_sel_bytes(kk, c), (float*)acc, (float*)vals, (int*)docs);
}

extern "C" {

// row: the regime the wrapper picked (1 ROW, 0 LARGE), which must be what (cp,
// kk) gives; cluster: in ROW, the blocks a query (1, 2, 4 or 8), or 0 for
// `row_cluster`'s choice (the wrapper's). Full mode (kk > 0) takes cand (qp,
// cp) int32 and nc (qp,) int32 and writes vals (qp, kk) f32 and docs (qp, kk)
// int32; partial mode (kk == 0) writes acc (qp, cp) f32. ROW reads nothing else
// and writes nothing else. LARGE also takes acc zeroed by the caller (in both
// modes), slice_max (tp,) int64 in HOST memory (the longest slice t of any
// query: the grid of launch t) and, in full mode, the selection buffers keys
// (cap_a keys, >= qp * cp) and buf_b (cap_b keys) sized by ops/select.py.
// scorer: bm25 or tfidf.
int pool_score(const void* docs_pg, const void* tfs_pg, const void* norms,
               const void* si, const void* w, const void* lane,
               const void* soff, const long long* slice_max, long long qp,
               long long ep, int tp, long long cp, int scorer, float k1,
               float b, float avg, void* acc, const void* cand,
               const void* nc, int kk, void* keys, long long cap_a,
               void* buf_b, long long cap_b, void* vals, void* docs,
               int row, int cluster, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (qp <= 0 || qp > 65535 || kk < 0 || kk > cp ||
      (scorer != SC_BM25 && scorer != SC_TFIDF))
    return (int)cudaErrorInvalidValue;
  if (is_row(cp, kk) != (row != 0)) return (int)cudaErrorInvalidValue;
  if (row) {
    const int c = cluster ? cluster : row_cluster(qp, cp);
    if (c < 1 || c > ROW_CLUSTER_MAX || (c & (c - 1)))
      return (int)cudaErrorInvalidValue;
    const long long smem = row_bytes(cp, kk, c);
    const cudaError_t e =
        scorer == SC_BM25
            ? launch_row<SC_BM25>(docs_pg, tfs_pg, norms, si, w, lane, soff,
                                  qp, ep, tp, cp, k1, b, avg, acc, cand, nc,
                                  kk, c, smem, vals, docs, s)
            : launch_row<SC_TFIDF>(docs_pg, tfs_pg, norms, si, w, lane, soff,
                                   qp, ep, tp, cp, k1, b, avg, acc, cand, nc,
                                   kk, c, smem, vals, docs, s);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  for (int t = 0; t < tp; ++t) {
    if (slice_max[t] <= 0) continue;
    dim3 grid(grid_for(slice_max[t], POOL_THREADS), (unsigned)qp);
    pool_slice_kernel<<<grid, POOL_THREADS, 0, s>>>(
        (const int*)docs_pg, (const int*)tfs_pg, (const int*)norms,
        (const int*)si, (const float*)w, (const int*)lane, (const int*)soff,
        tp, t, ep, cp, scorer, k1, b, avg, (float*)acc);
  }
  if (kk <= 0) return (int)cudaGetLastError();
  if (qp * cp > cap_a) return (int)cudaErrorInvalidValue;
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
