// Device-mesh kernels for Hopper (sm_90a), with a plain C interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; each entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrappers and the plain PyTorch
// versions live in ops/mesh_kernels.py.
//
// The reference (serenedb_tpu/parallel/mesh.py and its callers) runs its
// multi-device programs as shard_map bodies with psum / pmin / pmax over
// the mesh axis. The port runs each shard's body as launches on that
// shard's device and combines the partials, copied to the mesh's first
// device, with `mesh_combine`. Three kernels:
//
// mesh_combine replaces the psum / pmin / pmax of `apply_axis_combines`
// (and the psums of `sharded_agg_step`, `sharded_bm25_topk`,
// `sharded_query_step`, ops/bm25.py `_mesh_score_fn`, exec/device_agg.py
// `_mesh_wrap`): x (M, N) -> out (N,). A thread owns its output
// elements and walks the M shards in order, so an f32 sum is added in
// shard order 0..M-1 (no atomics, the same bits every run); min and max
// give NaN (0x7FC00000, torch's NaN) if any shard holds one, and an
// unsigned flag compares int32 words as u32 (agg_scan's float images).
// Bound: bytes (M * N read, N written). A fused group of same-dtype
// outputs is one stack, so one launch.
//
// mesh_agg_partials replaces the body of `sharded_agg_step` for one shard:
// vals (R, 128) int32, mask (R, 128) bool, lo, hi -> count (one int32) and
// (R, 2) int32 [sum(v >> 16), sum(v & 0xFFFF)] over the selected lanes of
// each row (exact in int32: |hi| <= 128 * 2^15, lo <= 128 * 65535; the
// count <= R * 128, which the wrapper holds under 2^31). Bound: bytes (5
// bytes a lane read, 8 a row written), so what matters is keeping enough
// loads in flight and nothing serialised. One launch, a card-sized grid
// (AGG_BLOCKS_SM blocks an SM): each warp walks its rows with a stride
// and has AGG_ROWS rows' loads in flight (a 16-byte load of 4 values and
// a 4-byte load of 4 mask bytes a lane a row) before it reduces them by
// shuffles and writes the row's two sums from registers (lanes 0 and 1).
// The count stays in a register per lane over all of a thread's rows,
// then a block's sum goes by one int atomic to a per-device counter; the
// last block to take the call's ticket writes the count out and resets
// counter and ticket to zero for the next call, so no memset is launched
// and no row takes an atomic (one a row on one word serialises at its L2
// slice). The counter and ticket are the device's: calls of this kernel
// on one device must not overlap, which holds as the port launches every
// call on the current stream.
//
// mesh_score_blocks replaces the scoring body of `sharded_bm25_topk`
// (BM25: `contrib()` of contrib.cuh, the reference's max(., 1e-9)
// guards) and `sharded_query_step` (saturation: tf / (tf + 1.2)) for one
// shard: entry e of gidx (Rb, W) int32 (e < 0 is padding) gathers
// posting g = gidx[e] (doc flat_docs[g], tf flat_tfs[g], dl norms[doc],
// weight idf[block_term[e / W]]) and adds its contribution into the
// shard's f32 plane. The reference scatter-adds in XLA's order; here each
// doc's contributions are added in gidx order from +0.0, with no float
// atomics and the same bits every run. Bound: bytes (each valid entry's
// gidx and gathers, the plane written once). The plane can be far larger
// than the entries (8,000,512 docs against ~600,000 entries on a BM25
// shard; 117.4M slots against ~29.4M entries, all in its first 8M, on a
// saturation shard), so the design touches the doc space once, by the
// plane's write, and does the rest in proportion to the entries: two
// kernels and no memset.
//  1. ms_bin_kernel, a block a slice: the entries in `slices` (<=
//     MS_SLICES_MAX) contiguous slices; the docs in `bins` bins of
//     2^shift docs: 8,192, fewer on a plane that would make fewer than
//     MS_BINS_FEW bins (its entries still spread over that many blocks),
//     more past MS_BINS_MAX bins (a slice's histogram sits in shared
//     memory). A first pass gathers each entry, writes its (doc,
//     contribution) record to the stage in entry order, counts its bin
//     and checks that the slice is in bin order with no padding, as the
//     entries of one posting list are: such a slice is bucketed already.
//     Any other slice is taken again in rounds of SB_ROUND entries, each
//     sorted stably by bin (block_sort16: two 8-bit radix passes, ranks
//     from __match_any_sync; a round already in order skips it), each
//     record to its bin's cursor plus its rank. Each bin's run within a
//     slice is in entry order; its end goes to `ends` (bins, slices). No
//     atomic but the shared-memory counts; nothing to zero outside the
//     block.
//  2. ms_tile_kernel, a block a (bin, range of at most 2^MS_ACC_SHIFT of
//     its docs), scheduled dynamically, so a bin far above the mean holds
//     one block and no other: the bin's records in gidx order are its
//     run in slice 0, then slice 1, ...; the block reads them in rounds
//     of ST_ROUND (the next round's loads in flight over this one's
//     adds). A round in doc order adds each doc's run by its first entry;
//     any other is ranked stably by the docs' low 8 bits (block_rank8)
//     and thread t adds, in order, the entries of the docs whose low bits
//     are t. The accumulators are f32 in shared memory from +0.0; then the
//     block writes its docs of the plane, zeros included, by 16-byte
//     stores. A bin with no entries writes zeros and reads nothing but
//     its `ends`.
// Scratch (`score_bytes`, one buffer): the stage, 8 bytes an entry, and
// `ends`, 4 bytes a (bin, slice): O(E + bins), never O(ndocs). A doc's
// adds are one chain however they are scheduled; a doc with n entries
// costs its thread n dependent adds. Why slices and not one counting
// sort over all entries: its ranks across blocks need zeroed global
// counters and a scan between the count and the scatter (a memset or two
// more kernels), while a slice needs neither and a bin still reads its
// entries in gidx order, slice by slice. Why a block a bin, not a warp:
// a bin of the saturation shard holds ~30,000 entries, which a block
// loads 1,024 at a time, and the ranks let all its threads add into one
// accumulator without two of them meeting on a doc.
//
// Built with -fmad=false (ops/_build.py), so a*b+c stays two rounded
// operations, as the plain version computes it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "contrib.cuh"

#define FULL 0xFFFFFFFFu

enum { MC_SUM = 0, MC_MIN = 1, MC_MAX = 2 };
enum { MT_I32 = 0, MT_I64 = 1, MT_F32 = 2 };
enum { MS_BM25 = 0, MS_SAT = 1 };

constexpr int MC_THREADS = 256;
constexpr int MC_MAX_BLOCKS = 132 * 16;

constexpr int AGG_THREADS = 256;
constexpr int AGG_WARPS = AGG_THREADS / 32;
constexpr int AGG_ROWS = 4;          // rows a warp has in flight
constexpr int AGG_BLOCKS_SM = 4;     // blocks an SM

constexpr int ITEMS = 4;             // entries a thread a sorted round
constexpr int SB_THREADS = 512;      // ms_bin_kernel
constexpr int SB_WARPS = SB_THREADS / 32;
constexpr int SB_ROUND = SB_THREADS * ITEMS;   // entries a round
constexpr int SB_IDX_BITS = 11;            // log2(SB_ROUND)
constexpr int SB_PASS = 8;                 // first-pass entries a thread
constexpr int ST_THREADS = 256;      // ms_tile_kernel
constexpr int ST_WARPS = ST_THREADS / 32;
constexpr int ST_ROUND = ST_THREADS * ITEMS;
constexpr int MS_SLICES_MAX = ST_THREADS;  // a tile block reads a run a thread
constexpr int MS_SLICE_MIN = SB_ROUND;     // entries a slice, at least
constexpr int MS_BINS_MAX = 16384;
constexpr int MS_BINS_FEW = 512;           // bins a plane splits into
constexpr int MS_BIN_SHIFT_MIN = 2;        // 4 docs a bin (16-byte stores)
constexpr int MS_ACC_SHIFT = 13;           // 8,192 docs a tile block
constexpr unsigned SORT_NONE = 0xFFFFu;    // sort key of padding: last
static_assert(SB_ROUND == 1 << SB_IDX_BITS, "a round's index fits its bits");
static_assert(MS_BINS_MAX < (int)SORT_NONE, "bins sort below padding");
static_assert((1 << MS_ACC_SHIFT) <= 32768, "a block's docs fit a short");

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

// ------------------------------------------------------------ mesh_combine

template <typename T, int OP, bool FLOAT>
__device__ __forceinline__ T combine2(T acc, T v) {
  if constexpr (OP == MC_SUM) {
    return acc + v;
  } else {
    if constexpr (FLOAT) {
      if (acc != acc || v != v) return __int_as_float(0x7FC00000);
    }
    if constexpr (OP == MC_MIN) return v < acc ? v : acc;
    return v > acc ? v : acc;
  }
}

template <typename T, int OP, bool FLOAT>
__global__ void mesh_combine_kernel(const T* __restrict__ x, long long M,
                                    long long N, T* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < N; i += (long long)gridDim.x * blockDim.x) {
    T acc = x[i];
    for (long long s = 1; s < M; ++s) acc = combine2<T, OP, FLOAT>(
        acc, x[s * N + i]);
    out[i] = acc;
  }
}

template <typename T, bool FLOAT>
static void launch_combine(const void* x, long long M, long long N, int op,
                           void* out, cudaStream_t st) {
  const long long blocks = ceil_div(N, MC_THREADS);
  const unsigned g = (unsigned)(blocks < MC_MAX_BLOCKS ? blocks
                                                       : MC_MAX_BLOCKS);
  const T* xs = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (op == MC_SUM)
    mesh_combine_kernel<T, MC_SUM, FLOAT><<<g, MC_THREADS, 0, st>>>(xs, M,
                                                                    N, o);
  else if (op == MC_MIN)
    mesh_combine_kernel<T, MC_MIN, FLOAT><<<g, MC_THREADS, 0, st>>>(xs, M,
                                                                    N, o);
  else
    mesh_combine_kernel<T, MC_MAX, FLOAT><<<g, MC_THREADS, 0, st>>>(xs, M,
                                                                    N, o);
}

extern "C" int mesh_combine(const void* x, long long M, long long N,
                            int type, int op, int uns, void* out,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || op < MC_SUM || op > MC_MAX)
    return (int)cudaErrorInvalidValue;
  switch (type) {
    case MT_I32:
      if (uns && op != MC_SUM)
        launch_combine<unsigned, false>(x, M, N, op, out, st);
      else
        launch_combine<int, false>(x, M, N, op, out, st);
      break;
    case MT_I64:
      launch_combine<long long, false>(x, M, N, op, out, st);
      break;
    case MT_F32:
      launch_combine<float, true>(x, M, N, op, out, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------ block scans

// Exclusive sum of v over the block; the block's total in *total.
template <int NT>
__device__ int block_excl_scan(int v, int* total) {
  __shared__ int warp_sums[NT / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < NT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < NT / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (w > 0 ? warp_sums[w - 1] : 0);
  *total = warp_sums[NT / 32 - 1];
  __syncthreads();
  return excl;
}

// The largest v of the threads before this one in the block (-1 for the
// first thread).
template <int NT>
__device__ int block_excl_max(int v) {
  __shared__ int warp_max[NT / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) warp_max[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < NT / 32 ? warp_max[lane] : -1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s = max(s, y);
    }
    if (lane < NT / 32) warp_max[lane] = s;
  }
  __syncthreads();
  int before = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) before = -1;
  const int out = max(before, w > 0 ? warp_max[w - 1] : -1);
  __syncthreads();
  return out;
}

// Stable ranks of the block's NT * ITEMS items by an 8-bit digit: item j
// of a thread sits at position (w * ITEMS + j) * 32 + lane (a warp holds
// 32 * ITEMS consecutive positions, 32 a step). An item's place is its
// warp's count
// of its digit before it (a leader a digit a step) plus its lanes before
// it, and cnt (256 * NT / 32 ints, warp-major) ends as the digit-major
// exclusive scan of the per-(warp, digit) counts: the place of item j is
// cnt[w * 256 + dig[j]] + rank[j], and digit d's items start at cnt[d].
// NT >= 256 (a thread a digit for the scan).
template <int NT>
__device__ void block_rank8(const int (&dig)[ITEMS], int* cnt,
                            int (&rank)[ITEMS]) {
  constexpr int W = NT / 32;
  static_assert(NT >= 256, "a thread a digit");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int* wc = cnt + w * 256;
  for (int i = threadIdx.x; i < 256 * W; i += NT) cnt[i] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned peers = __match_any_sync(FULL, dig[j]);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader) base = wc[dig[j]];
    base = __shfl_sync(FULL, base, leader);
    rank[j] = base + __popc(peers & lt);
    if (lane == leader) wc[dig[j]] = base + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  const int d = threadIdx.x;
  int sum = 0;
  if (d < 256)
    for (int x = 0; x < W; ++x) sum += cnt[x * 256 + d];
  int total;
  int run = block_excl_scan<NT>(sum, &total);
  if (d < 256)
    for (int x = 0; x < W; ++x) {
      const int c = cnt[x * 256 + d];
      cnt[x * 256 + d] = run;
      run += c;
    }
  __syncthreads();
}

// Stable sort of the block's NT * ITEMS keys in a by bits [ib, ib + 16) (two
// LSD passes of block_rank8, a -> b -> a); the low ib bits carry each
// key's index. cnt holds 256 * NT / 32 ints.
template <int NT>
__device__ void block_sort16(unsigned* a, unsigned* b, int* cnt, int ib) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const unsigned* src = pass ? b : a;
    unsigned* dst = pass ? a : b;
    unsigned key[ITEMS];
    int dig[ITEMS], rank[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      key[j] = src[(w * ITEMS + j) * 32 + lane];
      dig[j] = (int)((key[j] >> (ib + 8 * pass)) & 255u);
    }
    block_rank8<NT>(dig, cnt, rank);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      dst[cnt[w * 256 + dig[j]] + rank[j]] = key[j];
    __syncthreads();
  }
}

// keys[0..NT * ITEMS) in order of their bits above the index, or sorted
// there (stably) by block_sort16. A block-wide check first: the entries
// of a posting list come in doc order, and such a round needs no sort.
template <int NT>
__device__ void block_order(unsigned* keys, unsigned* tmp, int* cnt,
                            int ib) {
  bool in_order = true;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int p = threadIdx.x * ITEMS + j;
    if (p > 0 && keys[p - 1] > keys[p]) in_order = false;
  }
  if (!__syncthreads_and(in_order)) block_sort16<NT>(keys, tmp, cnt, ib);
}

// ------------------------------------------------------- mesh_agg_partials

// The count and the ticket of the call in flight on this device: zero
// between calls (the last block resets them).
__device__ int g_agg_count;
__device__ unsigned g_agg_ticket;

__global__ void __launch_bounds__(AGG_THREADS)
    mesh_agg_kernel(const int4* __restrict__ vals,
                    const unsigned* __restrict__ mask, long long R,
                    long long lo, long long hi, int* __restrict__ out) {
  __shared__ int s_cnt[AGG_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nw = (long long)gridDim.x * AGG_WARPS;
  int cnt = 0;
  for (long long r0 = (long long)blockIdx.x * AGG_WARPS + warp; r0 < R;
       r0 += nw * AGG_ROWS) {
    int4 v4[AGG_ROWS];
    unsigned m4[AGG_ROWS];
#pragma unroll
    for (int k = 0; k < AGG_ROWS; ++k) {
      const long long r = r0 + k * nw;
      v4[k] = make_int4(0, 0, 0, 0);
      m4[k] = 0u;
      if (r < R) {
        v4[k] = vals[r * 32 + lane];
        m4[k] = mask[r * 32 + lane];   // four bool bytes
      }
    }
#pragma unroll
    for (int k = 0; k < AGG_ROWS; ++k) {
      const long long r = r0 + k * nw;
      const int v[4] = {v4[k].x, v4[k].y, v4[k].z, v4[k].w};
      int hs = 0, ls = 0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const bool sel = ((m4[k] >> (8 * j)) & 0xFFu) != 0u &&
                         (long long)v[j] >= lo && (long long)v[j] < hi;
        if (sel) {
          ++cnt;
          hs += v[j] >> 16;
          ls += v[j] & 0xFFFF;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        hs += __shfl_xor_sync(FULL, hs, o);
        ls += __shfl_xor_sync(FULL, ls, o);
      }
      if (r < R) {
        if (lane == 0) out[1 + 2 * r] = hs;
        if (lane == 1) out[2 + 2 * r] = ls;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int blk = 0;
    for (int w = 0; w < AGG_WARPS; ++w) blk += s_cnt[w];
    if (blk) atomicAdd(&g_agg_count, blk);
    __threadfence();
    if (atomicAdd(&g_agg_ticket, 1u) == gridDim.x - 1) {
      __threadfence();
      out[0] = atomicExch(&g_agg_count, 0);
      atomicExch(&g_agg_ticket, 0u);
    }
  }
}

static int sm_count() {
  static int sms[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = sms[dev & 15];
  if (!n) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// out: [count, (hi16, lo16) x R] int32
extern "C" int mesh_agg_partials(const void* vals, const void* mask,
                                 long long R, long long lo, long long hi,
                                 void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 0 || R * 128 > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  const long long cap = (long long)AGG_BLOCKS_SM * sm_count();
  long long g = ceil_div(R, AGG_WARPS);
  g = g < 1 ? 1 : (g < cap ? g : cap);
  mesh_agg_kernel<<<(unsigned)g, AGG_THREADS, 0, st>>>(
      static_cast<const int4*>(vals), static_cast<const unsigned*>(mask), R,
      lo, hi, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- mesh_score_blocks

struct ScorePlan {
  int slices;            // ms_bin_kernel blocks
  long long slice_len;   // entries a slice (the last may be shorter)
  int shift;             // a bin is 2^shift docs
  int bins;
  int acc_shift;         // a tile block takes 2^acc_shift of a bin's docs
  int subs;              // tile blocks a bin
  long long stage_off, ends_off, bytes;
};

static long long align16(long long n) { return (n + 15) & ~15ll; }

// Mirrored by ops/mesh_kernels.py `score_plan`.
static ScorePlan score_plan(long long E, long long ndocs) {
  ScorePlan p;
  long long s = ceil_div(E, MS_SLICE_MIN);
  p.slices = (int)(s < 1 ? 1 : (s > MS_SLICES_MAX ? MS_SLICES_MAX : s));
  p.slice_len = E > 0 ? ceil_div(E, p.slices) : 1;
  // bins of 2^MS_ACC_SHIFT docs, smaller while the plane still makes
  // MS_BINS_FEW of them (a small plane's entries spread over blocks),
  // larger while there are more than MS_BINS_MAX
  p.shift = MS_ACC_SHIFT;
  while (p.shift > MS_BIN_SHIFT_MIN &&
         ceil_div(ndocs, 1ll << (p.shift - 1)) <= MS_BINS_FEW)
    --p.shift;
  while (ceil_div(ndocs, 1ll << p.shift) > MS_BINS_MAX) ++p.shift;
  p.bins = (int)ceil_div(ndocs, 1ll << p.shift);
  p.acc_shift = p.shift < MS_ACC_SHIFT ? p.shift : MS_ACC_SHIFT;
  p.subs = 1 << (p.shift - p.acc_shift);
  p.stage_off = 0;
  p.ends_off = align16(8 * E);
  p.bytes = p.ends_off + align16(4ll * p.slices * p.bins);
  return p;
}

struct ScoreArgs {
  const int* docs;        // flat_docs (P,)
  const int* tfs;         // flat_tfs (P,)
  const int* norms;       // (ndocs,) doc lengths (BM25)
  const int* gidx;        // (Rb, W) posting index, < 0 padding
  const int* block_term;  // (Rb,) term of each gidx row (BM25)
  const float* idf;       // term weights (BM25)
  long long E;            // Rb * W entries
  int W;
  long long ndocs;
  int mode;
  float k1, b, avg;
  int slices;
  long long slice_len;
  int shift, bins, acc_shift, subs;
  int2* stage;            // (E,) (doc, contribution bits), bins' runs
  int* ends;              // (bins, slices) each bin's run end in a slice
  float* plane;           // (ndocs,)
};

// The gathers of a thread's N entries e[j] (g[j] their gidx,
// -1 past the slice), each level of loads issued for all N before the
// next is used: doc, tf and the row's term; then the doc's length and the
// term's weight. d[j] < 0 for padding and for a doc outside the plane.
template <int N>
__device__ __forceinline__ void gather(const ScoreArgs& a,
                                       const long long (&e)[N],
                                       const int (&g)[N], int (&d)[N],
                                       float (&c)[N]) {
  // raw loads first and nothing that waits on them between (an int to
  // float conversion or a 64-bit division there serialises the four)
  const bool bm25 = a.mode == MS_BM25;
  int tf[N], bt[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    d[j] = g[j] >= 0 ? a.docs[g[j]] : -1;
    tf[j] = g[j] >= 0 ? a.tfs[g[j]] : 0;
    bt[j] = bm25 && g[j] >= 0
                ? a.block_term[(unsigned)e[j] / (unsigned)a.W] : -1;
  }
  int dl[N];
  float w[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (d[j] >= a.ndocs) d[j] = -1;
    dl[j] = bm25 && d[j] >= 0 ? a.norms[d[j]] : 0;
    w[j] = bt[j] >= 0 ? a.idf[bt[j]] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float t = (float)tf[j];
    c[j] = bm25 ? contrib(SC_BM25, t, (float)dl[j], w[j], a.k1, a.b, a.avg)
                : t / (t + 1.2f);
  }
}

// ms_bin_kernel's dynamic shared memory at `bins` bins.
static int bin_smem(int bins) {
  return SB_ROUND * (int)sizeof(int2) + 2 * SB_ROUND * (int)sizeof(unsigned)
         + 256 * SB_WARPS * (int)sizeof(int) + bins * (int)sizeof(int);
}

// ms_tile_kernel's dynamic shared memory at 2^acc_shift docs a block.
static int tile_smem(int acc_shift) {
  return (int)sizeof(float) * (1 << acc_shift) +
         MS_SLICES_MAX * (int)sizeof(long long) +
         ST_ROUND * (int)sizeof(float) +
         (MS_SLICES_MAX + 1) * (int)sizeof(int) +
         ST_ROUND * (int)(sizeof(short) + sizeof(unsigned short)) +
         256 * ST_WARPS * (int)sizeof(int);
}

// A block a slice: its valid entries' records, stably bucketed by bin into
// the slice's part of the stage, and each bin's end there (the note at the
// top).
__global__ void __launch_bounds__(SB_THREADS, 2)
    ms_bin_kernel(const __grid_constant__ ScoreArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* rec = reinterpret_cast<int2*>(smem);
  unsigned* keyA = reinterpret_cast<unsigned*>(rec + SB_ROUND);
  unsigned* keyB = keyA + SB_ROUND;
  int* cnt = reinterpret_cast<int*>(keyB + SB_ROUND);
  int* hist = cnt + 256 * SB_WARPS;   // counts, then each bin's cursor
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long lo = (long long)blockIdx.x * a.slice_len;
  const long long hi = min(a.E, lo + a.slice_len);
  for (int t = tid; t < a.bins; t += SB_THREADS) hist[t] = 0;
  __syncthreads();
  // the first pass: each entry's gathers and contribution, into the
  // stage in entry order, and its bin's count; it also finds whether the
  // slice is in bin order with no padding (the entries of one posting
  // list are), each entry's bin against the one before it (across warps
  // through `edge`). Such a slice's stage is already bucketed.
  __shared__ int edge[SB_PASS][SB_WARPS];
  bool ok = true;
  int carry = -1;   // the last bin of the pass's previous step
  for (long long e0 = lo; e0 < hi; e0 += SB_PASS * SB_THREADS) {
    long long e[SB_PASS];
    int g[SB_PASS], d[SB_PASS], b[SB_PASS], up[SB_PASS];
    float c[SB_PASS];
#pragma unroll
    for (int j = 0; j < SB_PASS; ++j) {
      e[j] = e0 + j * SB_THREADS + tid;
      g[j] = e[j] < hi ? a.gidx[e[j]] : -1;
    }
    gather<SB_PASS>(a, e, g, d, c);
#pragma unroll
    for (int j = 0; j < SB_PASS; ++j) {
      b[j] = -1;
      if (d[j] >= 0) {
        b[j] = d[j] >> a.shift;
        atomicAdd(hist + b[j], 1);
      } else if (e[j] < hi) {
        ok = false;
      }
      if (e[j] < hi)
        a.stage[e[j]] = make_int2(d[j], __float_as_int(c[j]));
      up[j] = __shfl_up_sync(FULL, b[j], 1);
    }
    __syncthreads();
    if (lane == 31)
      for (int j = 0; j < SB_PASS; ++j) edge[j][w] = b[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SB_PASS; ++j) {
      int prev = up[j];
      if (lane == 0)
        prev = w ? edge[j][w - 1] : (j ? edge[j - 1][SB_WARPS - 1] : carry);
      if (e[j] < hi && prev > b[j]) ok = false;
    }
    carry = edge[SB_PASS - 1][SB_WARPS - 1];
  }
  const bool in_place = __syncthreads_and(ok);
  int total;
  {
    const int per = (a.bins + SB_THREADS - 1) / SB_THREADS;
    const int beg = min(a.bins, tid * per), end = min(a.bins, beg + per);
    int sum = 0;
    for (int i = beg; i < end; ++i) sum += hist[i];
    int run = block_excl_scan<SB_THREADS>(sum, &total);
    for (int i = beg; i < end; ++i) {
      const int c = hist[i];
      hist[i] = run;
      run += c;
    }
  }
  __syncthreads();
  if (in_place) {
    // each bin's run is already where it lies among the entries: its end
    for (int t = tid; t < a.bins; t += SB_THREADS)
      a.ends[(long long)t * a.slices + blockIdx.x] =
          t + 1 < a.bins ? hist[t + 1] : total;
    return;
  }
  // each round's gidx loaded a round ahead, in flight over the round
  // before it
  int g[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long e = lo + (w * ITEMS + j) * 32 + lane;
    g[j] = e < hi ? a.gidx[e] : -1;
  }
  for (long long r = lo; r < hi; r += SB_ROUND) {
    long long e[ITEMS];
    int d[ITEMS];
    float c[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) e[j] = r + (w * ITEMS + j) * 32 + lane;
    gather<ITEMS>(a, e, g, d, c);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long en = e[j] + SB_ROUND;
      g[j] = en < hi ? a.gidx[en] : -1;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int idx = (w * ITEMS + j) * 32 + lane;
      unsigned key = (SORT_NONE << SB_IDX_BITS) | (unsigned)idx;
      if (d[j] >= 0) {
        rec[idx] = make_int2(d[j], __float_as_int(c[j]));
        key = ((unsigned)(d[j] >> a.shift) << SB_IDX_BITS) | (unsigned)idx;
      }
      keyA[idx] = key;
    }
    __syncthreads();
    block_order<SB_THREADS>(keyA, keyB, cnt, SB_IDX_BITS);
    // a thread's four consecutive sorted positions: each run's first
    // position by a max-scan over the block
    unsigned k[ITEMS];
    int first[ITEMS];
    int m = -1;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int p = tid * ITEMS + j;
      k[j] = keyA[p];
      if (p == 0 || (keyA[p - 1] >> SB_IDX_BITS) != (k[j] >> SB_IDX_BITS))
        m = p;
      first[j] = m;
    }
    const int before = block_excl_max<SB_THREADS>(m);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      first[j] = max(first[j], before);
      const unsigned bin = k[j] >> SB_IDX_BITS;
      if (bin != SORT_NONE)
        a.stage[lo + hist[bin] + (tid * ITEMS + j - first[j])] =
            rec[k[j] & (SB_ROUND - 1)];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int p = tid * ITEMS + j;
      const unsigned bin = k[j] >> SB_IDX_BITS;
      if (bin != SORT_NONE &&
          (p == SB_ROUND - 1 || (keyA[p + 1] >> SB_IDX_BITS) != bin))
        hist[bin] += p - first[j] + 1;
    }
    __syncthreads();
  }
  for (int t = tid; t < a.bins; t += SB_THREADS)
    a.ends[(long long)t * a.slices + blockIdx.x] = hist[t];
}

// Stage records r + (w * ITEMS + j) * 32 + lane (j < ITEMS) of a
// bin's sequence (its runs slice by slice: pos[s] where slice s's run
// starts in it, from[s] where that run lies in the stage); all loads
// issued before any is used, (-1, 0) past n.
__device__ __forceinline__ void load_round(const ScoreArgs& a, int r, int n,
                                           const long long* from,
                                           const int* pos,
                                           int2 (&rv)[ITEMS]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  long long at[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int p = r + (w * ITEMS + j) * 32 + lane;
    int s = 0;   // the last slice whose run starts at or before p
#pragma unroll
    for (int step = MS_SLICES_MAX / 2; step > 0; step >>= 1)
      if (s + step < a.slices && pos[s + step] <= p) s += step;
    at[j] = p < n ? from[s] + (p - pos[s]) : -1;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    rv[j] = at[j] >= 0 ? a.stage[at[j]] : make_int2(-1, 0);
}

// A block a (bin, range of its docs): the bin's entries in gidx order, a
// round at a time, added into the docs' accumulators. A round already in
// doc order (the entries of one posting list are) adds each doc's run by
// its first entry; any other round is ranked stably by the doc's low 8
// bits (block_rank8), and thread t adds, in order, the entries of the
// docs whose low bits are t. Then the block's docs of the plane, zeros
// included.
__global__ void __launch_bounds__(ST_THREADS, 4)
    ms_tile_kernel(const __grid_constant__ ScoreArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  long long* from = reinterpret_cast<long long*>(acc + (1 << a.acc_shift));
  float* sval = reinterpret_cast<float*>(from + MS_SLICES_MAX);
  int* pos = reinterpret_cast<int*>(sval + ST_ROUND);
  short* sdl = reinterpret_cast<short*>(pos + MS_SLICES_MAX + 1);
  unsigned short* order = reinterpret_cast<unsigned short*>(sdl + ST_ROUND);
  int* cnt = reinterpret_cast<int*>(order + ST_ROUND);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int t = blockIdx.x / a.subs;
  const long long d0 = ((long long)t << a.shift) +
                       ((long long)(blockIdx.x % a.subs) << a.acc_shift);
  if (d0 >= a.ndocs) return;
  const int nd = (int)min((long long)(1 << a.acc_shift), a.ndocs - d0);
  int len = 0;
  if (tid < a.slices) {
    const int* row = a.ends + (long long)t * a.slices;
    const int beg = t ? row[tid - a.slices] : 0;
    len = row[tid] - beg;
    from[tid] = (long long)tid * a.slice_len + beg;
  }
  float4* out4 = reinterpret_cast<float4*>(a.plane + d0);
  const int n4 = nd >> 2;
  if (!__syncthreads_or(len)) {   // no entries: zeros
    for (int i = tid; i < n4; i += ST_THREADS)
      out4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = 4 * n4 + tid; i < nd; i += ST_THREADS) a.plane[d0 + i] = 0.0f;
    return;
  }
  int n;
  const int at = block_excl_scan<ST_THREADS>(len, &n);
  if (tid < a.slices) pos[tid] = at;
  for (int i = tid; i < nd; i += ST_THREADS) acc[i] = 0.0f;
  __syncthreads();
  int2 rv[ITEMS];
  load_round(a, 0, n, from, pos, rv);
  for (int r = 0; r < n; r += ST_ROUND) {
    int dl[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int idx = (w * ITEMS + j) * 32 + lane;
      const long long d = rv[j].x - d0;
      const bool in = r + idx < n && d >= 0 && d < nd;
      dl[j] = in ? (int)d : -1;
      if (in) sval[idx] = __int_as_float(rv[j].y);
      sdl[idx] = (short)dl[j];
    }
    // the next round's records come in over this one's adds
    if (r + ST_ROUND < n) load_round(a, r + ST_ROUND, n, from, pos, rv);
    __syncthreads();
    bool in_order = true;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int idx = (w * ITEMS + j) * 32 + lane;
      const int prev = idx > 0 ? sdl[idx - 1] : 0;
      if ((prev < 0 ? 0x7FFF : prev) > (dl[j] < 0 ? 0x7FFF : dl[j]))
        in_order = false;
    }
    if (__syncthreads_and(in_order)) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int idx = (w * ITEMS + j) * 32 + lane;
        if (dl[j] < 0 || (idx > 0 && sdl[idx - 1] == dl[j])) continue;
        float v = acc[dl[j]];
        int q = idx;
        do {
          v += sval[q];
          ++q;
        } while (q < ST_ROUND && sdl[q] == dl[j]);
        acc[dl[j]] = v;
      }
    } else {
      int dig[ITEMS], rank[ITEMS];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        dig[j] = dl[j] < 0 ? 255 : (dl[j] & 255);
      block_rank8<ST_THREADS>(dig, cnt, rank);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        order[cnt[w * 256 + dig[j]] + rank[j]] =
            (unsigned short)((w * ITEMS + j) * 32 + lane);
      __syncthreads();
      const int end = tid < 255 ? cnt[tid + 1] : ST_ROUND;
      for (int i = cnt[tid]; i < end; ++i) {
        const int k = order[i], d = sdl[k];
        if (d >= 0) acc[d] += sval[k];
      }
    }
    __syncthreads();
  }
  const float4* acc4 = reinterpret_cast<const float4*>(acc);
  for (int i = tid; i < n4; i += ST_THREADS) out4[i] = acc4[i];
  for (int i = 4 * n4 + tid; i < nd; i += ST_THREADS) a.plane[d0 + i] = acc[i];
}

// Bytes of mesh_score_blocks' scratch at (E entries, ndocs docs).
extern "C" long long score_bytes(long long E, long long ndocs) {
  return score_plan(E, ndocs).bytes;
}

extern "C" int mesh_score_blocks(const void* docs, const void* tfs,
                                 const void* norms, const void* gidx,
                                 const void* block_term, const void* idf,
                                 long long E, int W, long long ndocs,
                                 int mode, float k1, float b, float avg,
                                 void* buf, void* plane, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ndocs < 1 || ndocs > 0x7FFFFFFFll || W < 1 || E < 0 ||
      E > 0x7FFFFFFFll || (mode != MS_BM25 && mode != MS_SAT))
    return (int)cudaErrorInvalidValue;
  static bool attr[16] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!attr[dev & 15]) {
    cudaError_t e = cudaFuncSetAttribute(
        ms_bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bin_smem(MS_BINS_MAX));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ms_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tile_smem(MS_ACC_SHIFT));
    if (e != cudaSuccess) return (int)e;
    attr[dev & 15] = true;
  }
  const ScorePlan p = score_plan(E, ndocs);
  char* base = static_cast<char*>(buf);
  ScoreArgs a;
  a.docs = static_cast<const int*>(docs);
  a.tfs = static_cast<const int*>(tfs);
  a.norms = static_cast<const int*>(norms);
  a.gidx = static_cast<const int*>(gidx);
  a.block_term = static_cast<const int*>(block_term);
  a.idf = static_cast<const float*>(idf);
  a.E = E;
  a.W = W;
  a.ndocs = ndocs;
  a.mode = mode;
  a.k1 = k1;
  a.b = b;
  a.avg = avg;
  a.slices = p.slices;
  a.slice_len = p.slice_len;
  a.shift = p.shift;
  a.bins = p.bins;
  a.acc_shift = p.acc_shift;
  a.subs = p.subs;
  a.stage = reinterpret_cast<int2*>(base + p.stage_off);
  a.ends = reinterpret_cast<int*>(base + p.ends_off);
  a.plane = static_cast<float*>(plane);
  ms_bin_kernel<<<(unsigned)p.slices, SB_THREADS, bin_smem(p.bins), st>>>(a);
  ms_tile_kernel<<<(unsigned)((long long)p.bins * p.subs), ST_THREADS,
                   tile_smem(p.acc_shift), st>>>(a);
  return (int)cudaGetLastError();
}
