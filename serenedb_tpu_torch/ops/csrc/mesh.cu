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
// each row (exact in int32: |hi| <= 128 * 2^15, lo <= 128 * 65535). One
// warp a row: each lane reads 4 values by one 16-byte load and 4 mask
// bytes by one 4-byte load, the sums reduce by shuffles, lane 0 writes
// the row and adds the warp's count to the one counter (an int atomic:
// exact in any order). Bound: bytes (5 bytes a lane read, 8 a row
// written).
//
// mesh_score_blocks replaces the scoring body of `sharded_bm25_topk`
// (BM25: `contrib()` of contrib.cuh, the reference's max(., 1e-9)
// guards) and `sharded_query_step` (saturation: tf / (tf + 1.2)) for one
// shard: entry e of gidx (Rb, W) int32 (e < 0 is padding) gathers
// posting g = gidx[e] (doc flat_docs[g], tf flat_tfs[g], dl norms[doc],
// weight idf[block_term[e / W]]) and adds its contribution into the
// shard's f32 plane. The reference scatter-adds in XLA's order; here each
// doc's contributions are added in gidx order from +0.0, with no float
// atomics: a counting sort of the valid entries by doc (counts by int
// atomics, an exclusive scan over the docs in tiles, a scatter into each
// doc's segment), then one thread a doc puts its segment in entry order
// (an insertion sort of its few entries) and adds them up, writing every
// doc of the plane (no memset of the plane). Five kernels and one memset
// of the counts; the segments and counts are one scratch buffer
// (`score_bytes`). Bound: bytes (each entry's gidx, doc, tf, dl and its
// segment slot; the counts, prefix and plane once each).
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
constexpr int AGG_WARPS = 8;          // rows a block of mesh_agg_partials
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_PER_THREAD = 16;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_PER_THREAD;  // docs a tile
constexpr int TOPS_THREADS = 1024;
constexpr int MS_THREADS = 256;
constexpr int MS_MAX_BLOCKS = 132 * 16;

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
  const unsigned g = (unsigned)(blocks < MS_MAX_BLOCKS ? blocks
                                                       : MS_MAX_BLOCKS);
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

// ------------------------------------------------------- mesh_agg_partials

__global__ void mesh_agg_kernel(const int4* __restrict__ vals,
                                const unsigned* __restrict__ mask,
                                long long R, long long lo, long long hi,
                                int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * AGG_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  const int4 v4 = vals[r * 32 + lane];
  const unsigned m4 = mask[r * 32 + lane];   // four bool bytes
  const int v[4] = {v4.x, v4.y, v4.z, v4.w};
  int cnt = 0, hs = 0, ls = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool sel = ((m4 >> (8 * j)) & 0xFFu) != 0u &&
                     (long long)v[j] >= lo && (long long)v[j] < hi;
    if (sel) {
      ++cnt;
      hs += v[j] >> 16;
      ls += v[j] & 0xFFFF;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_xor_sync(FULL, cnt, o);
    hs += __shfl_xor_sync(FULL, hs, o);
    ls += __shfl_xor_sync(FULL, ls, o);
  }
  if (lane == 0) {
    out[1 + 2 * r] = hs;
    out[2 + 2 * r] = ls;
    if (cnt) atomicAdd(out, cnt);
  }
}

// out: [count, (hi16, lo16) x R] int32
extern "C" int mesh_agg_partials(const void* vals, const void* mask,
                                 long long R, long long lo, long long hi,
                                 void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, sizeof(int), st);
  if (R > 0)
    mesh_agg_kernel<<<(unsigned)ceil_div(R, AGG_WARPS), AGG_WARPS * 32, 0,
                      st>>>(static_cast<const int4*>(vals),
                            static_cast<const unsigned*>(mask), R, lo, hi,
                            static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- mesh_score_blocks

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
  int* cnt;               // (ndocs,) counts, then cursors
  int* pre;               // (ndocs,) exclusive prefix within a tile
  int* tot;               // (tiles + 1,) tile sums -> their prefix, total
  int* seg_pos;           // (E,) entry of each segment slot
  float* seg_val;         // (E,) its contribution
  float* plane;           // (ndocs,)
};

__device__ __forceinline__ int doc_start(const ScoreArgs& a, long long d) {
  return d >= a.ndocs ? a.tot[ceil_div(a.ndocs, SCAN_TILE)]
                      : a.pre[d] + a.tot[d / SCAN_TILE];
}

__global__ void ms_count_kernel(const __grid_constant__ ScoreArgs a) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < a.E; e += (long long)gridDim.x * blockDim.x) {
    const int g = a.gidx[e];
    if (g >= 0) atomicAdd(a.cnt + a.docs[g], 1);
  }
}

// Exclusive scan of v over the block; the block's total in *total.
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

// One tile of SCAN_TILE docs a block: pre = the exclusive prefix of the
// counts within the tile, tot[tile] = the tile's sum.
__global__ void ms_scan_tiles_kernel(const __grid_constant__ ScoreArgs a) {
  const long long base = (long long)blockIdx.x * SCAN_TILE +
                         (long long)threadIdx.x * SCAN_PER_THREAD;
  int c[SCAN_PER_THREAD];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < SCAN_PER_THREAD; ++j) {
    c[j] = base + j < a.ndocs ? a.cnt[base + j] : 0;
    sum += c[j];
  }
  int total;
  int run = block_excl_scan<SCAN_THREADS>(sum, &total);
#pragma unroll
  for (int j = 0; j < SCAN_PER_THREAD; ++j) {
    if (base + j < a.ndocs) a.pre[base + j] = run;
    run += c[j];
  }
  if (threadIdx.x == 0) a.tot[blockIdx.x] = total;
}

// One block: the exclusive prefix of the tile sums in place, and the
// grand total after them.
__global__ void ms_scan_tops_kernel(const __grid_constant__ ScoreArgs a,
                                    long long tiles) {
  int carry = 0;
  for (long long base = 0; base < tiles; base += TOPS_THREADS) {
    const long long i = base + threadIdx.x;
    const int v = i < tiles ? a.tot[i] : 0;
    int total;
    const int ex = block_excl_scan<TOPS_THREADS>(v, &total);
    if (i < tiles) a.tot[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) a.tot[tiles] = carry;
}

__device__ __forceinline__ float entry_contrib(const ScoreArgs& a,
                                               long long e, int g, int d) {
  const float tf = (float)a.tfs[g];
  if (a.mode == MS_SAT) return tf / (tf + 1.2f);
  const float w = a.idf[a.block_term[e / a.W]];
  return contrib(SC_BM25, tf, (float)a.norms[d], w, a.k1, a.b, a.avg);
}

// Each valid entry into a slot of its doc's segment (slots taken by
// counting the doc's count down; their order is put right per doc).
__global__ void ms_scatter_kernel(const __grid_constant__ ScoreArgs a) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < a.E; e += (long long)gridDim.x * blockDim.x) {
    const int g = a.gidx[e];
    if (g < 0) continue;
    const int d = a.docs[g];
    const int slot = atomicSub(a.cnt + d, 1) - 1;
    const int at = doc_start(a, d) + slot;
    a.seg_pos[at] = (int)e;
    a.seg_val[at] = entry_contrib(a, e, g, d);
  }
}

// One thread a doc: its segment in entry order, added from +0.0.
__global__ void ms_sum_kernel(const __grid_constant__ ScoreArgs a) {
  const long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= a.ndocs) return;
  const int s = doc_start(a, d), n = doc_start(a, d + 1) - s;
  int* pos = a.seg_pos + s;
  float* val = a.seg_val + s;
  for (int i = 1; i < n; ++i) {
    const int p = pos[i];
    const float v = val[i];
    int j = i - 1;
    while (j >= 0 && pos[j] > p) {
      pos[j + 1] = pos[j];
      val[j + 1] = val[j];
      --j;
    }
    pos[j + 1] = p;
    val[j + 1] = v;
  }
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) acc += val[i];
  a.plane[d] = acc;
}

static long long align16(long long n) { return (n + 15) & ~15ll; }

// Bytes of mesh_score_blocks' scratch at (E entries, ndocs docs).
extern "C" long long score_bytes(long long E, long long ndocs) {
  const long long tiles = ceil_div(ndocs, SCAN_TILE);
  return 2 * align16(4 * ndocs) + align16(4 * (tiles + 1)) +
         2 * align16(4 * E);
}

extern "C" int mesh_score_blocks(const void* docs, const void* tfs,
                                 const void* norms, const void* gidx,
                                 const void* block_term, const void* idf,
                                 long long E, int W, long long ndocs,
                                 int mode, float k1, float b, float avg,
                                 void* buf, void* plane, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ndocs < 1 || W < 1 || E < 0 || (mode != MS_BM25 && mode != MS_SAT))
    return (int)cudaErrorInvalidValue;
  const long long tiles = ceil_div(ndocs, SCAN_TILE);
  char* p = static_cast<char*>(buf);
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
  a.cnt = reinterpret_cast<int*>(p);
  p += align16(4 * ndocs);
  a.pre = reinterpret_cast<int*>(p);
  p += align16(4 * ndocs);
  a.tot = reinterpret_cast<int*>(p);
  p += align16(4 * (tiles + 1));
  a.seg_pos = reinterpret_cast<int*>(p);
  p += align16(4 * E);
  a.seg_val = reinterpret_cast<float*>(p);
  a.plane = static_cast<float*>(plane);
  cudaMemsetAsync(a.cnt, 0, 4 * ndocs, st);
  const long long eb = ceil_div(E, MS_THREADS);
  const unsigned egrid = (unsigned)(eb < 1 ? 1
                                    : (eb < MS_MAX_BLOCKS ? eb
                                                          : MS_MAX_BLOCKS));
  ms_count_kernel<<<egrid, MS_THREADS, 0, st>>>(a);
  ms_scan_tiles_kernel<<<(unsigned)tiles, SCAN_THREADS, 0, st>>>(a);
  ms_scan_tops_kernel<<<1, TOPS_THREADS, 0, st>>>(a, tiles);
  ms_scatter_kernel<<<egrid, MS_THREADS, 0, st>>>(a);
  ms_sum_kernel<<<(unsigned)ceil_div(ndocs, MS_THREADS), MS_THREADS, 0,
                  st>>>(a);
  return (int)cudaGetLastError();
}
