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
// shard's device and combines the partials on the mesh's first device
// (a partial on another card is brought there by a peer copy first) with
// `mesh_combine`. Three kernels:
//
// mesh_combine replaces the psum / pmin / pmax of `apply_axis_combines`
// (and the psums of `sharded_agg_step`, `sharded_bm25_topk`,
// `sharded_query_step`, ops/bm25.py `_mesh_score_fn`, exec/device_agg.py
// `_mesh_wrap`): for each output of a call, out[i] = x_0[i] op ... op
// x_{M-1}[i] over the M shards' partials, read where they lie on the
// first device (no stack, no staging copy). Sums add in shard order
// 0..M-1 from shard 0's value (no atomics, the same bits every run); min
// and max give NaN (0x7FC00000, torch's NaN) if any shard holds one, and
// an unsigned flag compares int32 words as u32 (agg_scan's float images).
// Bound: bytes (each part read once, the output written once: 2.56 GB,
// 0.76 ms, for the search leg's four 16 x 8,000,512 f32 planes). The
// first design (a thread an element, 4-byte loads with default caching,
// 64-bit index arithmetic, over an (M, N) stack the callers had to copy
// the partials into) lost to torch's `stack.sum(0)` and cost its callers
// a copy of every partial. Now:
//  - one launch a call takes every output (segment) of it, of any dtype
//    and op: a descriptor by value lists each segment's kind, length,
//    output and M input pointers; tiles are numbered segment after
//    segment, and a block finds its tile's segment from their first
//    tiles, so the type/op branch is uniform in a block;
//  - a segment whose pointers are all 16-byte aligned moves 16-byte
//    vectors, a tile of MC_TILE (8 KB a shard) a block. Thread 0 asks
//    for the tile of MC_BULK_M shards at a time by one bulk copy each
//    (cp.async.bulk, the Tensor Memory Accelerator) into the block's
//    shared stage behind an mbarrier, so each shard's 8 KB arrives as one
//    contiguous request; each thread combines its MC_VEC vectors from
//    shared memory in shard order into registers, and after the last
//    group stores them with st.global.cs. The tail past the last whole
//    vector, and any segment with a pointer off 16 bytes (views at odd
//    offsets), take a scalar path;
//  - indices are 32-bit within a segment (the wrapper cuts an output past
//    2^30 elements into several segments); the grid is a block a tile up
//    to MC_BLOCKS_SM blocks an SM, past which blocks walk the tiles with
//    the grid's stride.
// On the search leg's sum (NVIDIA H100 80GB HBM3, 700 W;
// scripts/mesh_variants.py, each line one call beside `stack.sum(0)`):
// the bulk copies 0.816-0.824 ms against the library's 0.821-0.833;
// 16-byte ld.global.nc.L1::no_allocate loads straight to registers
// (four shards' loads out before their combines) 0.816-0.893, from one
// build and card to the next (a persistent grid of 4-16 blocks an SM
// 0.829-0.834; .cs loads 0.875, default loads and ones with an L2
// prefetch hint as no_allocate's; default stores with no_allocate loads
// 0.879); the first design 0.903. 40 registers a thread (the register
// loads took 124); 0.818 ms at 4 shards against the library's
// 0.821-0.825, 0.741 at 8 shards of half the length (bound 0.687);
// staging 2 shards at a time took the same at both, and so did 16 KB
// copies (MC_VEC 4, 2 shards staged); an L2 evict_first hint on the
// copies took 0.861 against 0.827.
// The cap: a descriptor holds MC_SEGS (48) segments and MC_PTRS (256)
// shard pointers, 3,592 bytes of the 4 KB of kernel parameters; a call
// past either is split by the wrapper into the fewest launches that fit
// (`mesh_kernels.combine_launches`).
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
#include <string.h>

#include <type_traits>

#include "contrib.cuh"

#define FULL 0xFFFFFFFFu

enum { MC_SUM = 0, MC_MIN = 1, MC_MAX = 2 };
enum { MT_I32 = 0, MT_I64 = 1, MT_F32 = 2, MT_U32 = 3 };  // U32: int32 as u32
enum { MS_BM25 = 0, MS_SAT = 1 };

constexpr int MC_THREADS = 256;
constexpr int MC_VEC = 2;            // 16-byte vectors a thread a shard
// blocks an SM at most: 512 is a block a tile up to a 67,584-tile call
// (a persistent grid of 4, 8 or 16 an SM took 0.829-0.834 ms on the
// search leg's sum, a block a tile 0.816-0.827)
constexpr int MC_BLOCKS_SM = 512;
constexpr int MC_TILE = MC_THREADS * MC_VEC;   // vectors a tile
// shards a vector tile stages at a time, by one bulk copy a shard
// (cp.async.bulk behind an mbarrier) before their combines
constexpr int MC_BULK_M = 4;
constexpr int MC_SEGS = 48;          // segments a launch
constexpr int MC_PTRS = 256;         // shard pointers a launch

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

// One segment of a launch: out[i] = x_0[i] op x_1[i] op ... op x_{m-1}[i]
// for i < n, the shards' pointers at ptr[ptr0 .. ptr0 + m). The C entry
// sets nvec, vec and tile0 from the pointers.
struct McSeg {
  void* out;
  int n;          // elements (< 2^31: indices are 32-bit)
  int nvec;       // whole 16-byte vectors (0 when !vec)
  int tile0;      // the segment's first tile in the launch
  int ptr0;       // shard 0's pointer in McDesc::ptr
  short m;        // shards
  unsigned char kind;   // MC_KIND(op, type)
  unsigned char vec;    // every pointer 16-byte aligned
};

struct McDesc {
  int n_seg;
  int tiles;
  McSeg seg[MC_SEGS];
  const void* ptr[MC_PTRS];
};
static_assert(sizeof(McDesc) <= 4000,
              "the descriptor fits the 4 KB of kernel parameters");

#define MC_KIND(op, type) ((op) * 4 + (type))

template <typename T, int OP>
__device__ __forceinline__ T combine2(T acc, T v) {
  if constexpr (OP == MC_SUM) {
    return acc + v;
  } else {
    if constexpr (std::is_same<T, float>::value) {
      if (acc != acc || v != v) return __int_as_float(0x7FC00000);
    }
    if constexpr (OP == MC_MIN) return v < acc ? v : acc;
    return v > acc ? v : acc;
  }
}

// Two 16-byte words combined element by element.
template <typename T, int OP>
__device__ __forceinline__ uint4 combine16(uint4 a, uint4 b) {
  constexpr int K = 16 / sizeof(T);
  T x[K], y[K];
  memcpy(x, &a, 16);
  memcpy(y, &b, 16);
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = combine2<T, OP>(x[k], y[k]);
  memcpy(&a, x, 16);
  return a;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits for the mbarrier's phase `phase` to complete; traps (a launch
// error, not a hang) if it never does.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
    if (spins > (1ll << 22)) __trap();
  }
}

// Element i over the segment's shards, shard 0 first.
template <typename T, int OP>
__device__ __forceinline__ void combine_one(const void* const* P, int m,
                                            T* out, int i) {
  T acc = __ldcs(static_cast<const T*>(P[0]) + i);
  for (int s = 1; s < m; ++s)
    acc = combine2<T, OP>(acc, __ldcs(static_cast<const T*>(P[s]) + i));
  out[i] = acc;
}

// Tile lt of a segment. A vector segment's tile is MC_TILE vectors, a
// thread's MC_VEC of them strided by the block: the shards come through
// the shared stage MC_BULK_M at a time, a bulk copy a shard, and each
// thread keeps its running results in registers; its tile 0 also takes
// the tail past the last whole vector. A scalar segment's tile is
// MC_TILE * 4 elements.
template <typename T, int OP>
__device__ void combine_tile(const McDesc& d, const McSeg& g, int lt,
                             uint4* stage, uint32_t bar, uint32_t& phase) {
  const void* const* P = d.ptr + g.ptr0;
  const int m = g.m;
  T* out = static_cast<T*>(g.out);
  if (!g.vec) {
#pragma unroll
    for (int r = 0; r < MC_VEC * 4; ++r) {
      const int i = (lt * MC_VEC * 4 + r) * MC_THREADS + threadIdx.x;
      if (i < g.n) combine_one<T, OP>(P, m, out, i);
    }
    return;
  }
  const int nv = min(MC_TILE, g.nvec - lt * MC_TILE);  // block-uniform
  if (nv > 0) {
    const uint32_t bytes = (uint32_t)nv * 16;
    uint4 acc[MC_VEC];
    for (int c = 0; c < m; c += MC_BULK_M) {
      const int k = min(MC_BULK_M, m - c);
      __syncthreads();                // the stage's last readers are done
      if (threadIdx.x == 0) {
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
            :: "r"(bar), "r"(bytes * k) : "memory");
        for (int j = 0; j < k; ++j)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];"
              :: "r"(smem_u32(stage + j * MC_TILE)),
                 "l"(static_cast<const uint4*>(P[c + j]) + lt * MC_TILE),
                 "r"(bytes), "r"(bar) : "memory");
      }
      bar_wait(bar, phase);
      phase ^= 1;
#pragma unroll
      for (int v = 0; v < MC_VEC; ++v) {
        const int i = threadIdx.x + v * MC_THREADS;
        if (i < nv) {
          for (int j = 0; j < k; ++j)
            acc[v] = c + j == 0 ? stage[i]
                                : combine16<T, OP>(acc[v], stage[j * MC_TILE + i]);
        }
      }
    }
    uint4* o = reinterpret_cast<uint4*>(out) + lt * MC_TILE;
#pragma unroll
    for (int v = 0; v < MC_VEC; ++v) {
      const int i = threadIdx.x + v * MC_THREADS;
      if (i < nv) __stcs(o + i, acc[v]);
    }
  }
  // the tail past the last whole vector: under 16 / sizeof(T) elements
  const int tail0 = g.nvec * (int)(16 / sizeof(T));
  if (lt == 0 && threadIdx.x < g.n - tail0)
    combine_one<T, OP>(P, m, out, tail0 + threadIdx.x);
}

__global__ void __launch_bounds__(MC_THREADS)
    mesh_combine_kernel(const __grid_constant__ McDesc d) {
  __shared__ alignas(128) uint4 stage[MC_BULK_M * MC_TILE];
  __shared__ alignas(8) unsigned long long bar_word;
  const uint32_t bar = smem_u32(&bar_word);
  uint32_t phase = 0;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int t = blockIdx.x; t < d.tiles; t += gridDim.x) {
    int s = 0;   // the tile's segment, the same for the whole block
    while (s + 1 < d.n_seg && d.seg[s + 1].tile0 <= t) ++s;
    const McSeg& g = d.seg[s];
    const int lt = t - g.tile0;
    switch (g.kind) {
      // integer sums add as unsigned: the same bits, a defined wrap
      case MC_KIND(MC_SUM, MT_I32):
        combine_tile<unsigned, MC_SUM>(d, g, lt, stage, bar, phase);
        break;
      case MC_KIND(MC_SUM, MT_I64):
        combine_tile<unsigned long long, MC_SUM>(d, g, lt, stage, bar, phase);
        break;
      case MC_KIND(MC_SUM, MT_F32):
        combine_tile<float, MC_SUM>(d, g, lt, stage, bar, phase);
        break;
      case MC_KIND(MC_MIN, MT_I32):
        combine_tile<int, MC_MIN>(d, g, lt, stage, bar, phase);
        break;
      case MC_KIND(MC_MIN, MT_U32):
        combine_tile<unsigned, MC_MIN>(d, g, lt, stage, bar, phase);
        break;
      case MC_KIND(MC_MIN, MT_I64):
        combine_tile<long long, MC_MIN>(d, g, lt, stage, bar, phase);
        break;
      case MC_KIND(MC_MIN, MT_F32):
        combine_tile<float, MC_MIN>(d, g, lt, stage, bar, phase);
        break;
      case MC_KIND(MC_MAX, MT_I32):
        combine_tile<int, MC_MAX>(d, g, lt, stage, bar, phase);
        break;
      case MC_KIND(MC_MAX, MT_U32):
        combine_tile<unsigned, MC_MAX>(d, g, lt, stage, bar, phase);
        break;
      case MC_KIND(MC_MAX, MT_I64):
        combine_tile<long long, MC_MAX>(d, g, lt, stage, bar, phase);
        break;
      case MC_KIND(MC_MAX, MT_F32):
        combine_tile<float, MC_MAX>(d, g, lt, stage, bar, phase);
        break;
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

// One launch over the segments that `host` lists (int64 words): their
// count, then six words a segment (out, n, m, ptr0, type MT_*, op MC_*),
// then the shards' pointers, segment after segment. Refuses more than
// MC_SEGS segments or MC_PTRS pointers (the wrapper splits a call into
// launches that fit), an empty segment, and a sum of MT_U32.
extern "C" int mesh_combine(const long long* host, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  McDesc d;
  memset(&d, 0, sizeof d);
  const long long n_seg = host[0];
  if (n_seg < 1 || n_seg > MC_SEGS) return (int)cudaErrorInvalidValue;
  const long long* ptrs = host + 1 + 6 * n_seg;
  long long n_ptr = 0, tiles = 0;
  for (long long s = 0; s < n_seg; ++s) {
    const long long* w = host + 1 + 6 * s;
    const long long n = w[1], m = w[2], p0 = w[3], type = w[4], op = w[5];
    if (n < 1 || n > 0x7FFFFFFFll || m < 1 || p0 != n_ptr ||
        p0 + m > MC_PTRS || type < MT_I32 || type > MT_U32 ||
        op < MC_SUM || op > MC_MAX || (type == MT_U32 && op == MC_SUM))
      return (int)cudaErrorInvalidValue;
    n_ptr += m;
    McSeg& g = d.seg[s];
    g.out = reinterpret_cast<void*>(w[0]);
    g.n = (int)n;
    g.m = (short)m;
    g.ptr0 = (int)p0;
    g.kind = (unsigned char)MC_KIND(op, type);
    const long long esize = type == MT_I64 ? 8 : 4;
    bool vec = (w[0] & 15) == 0;
    for (long long j = 0; j < m; ++j) {
      d.ptr[p0 + j] = reinterpret_cast<const void*>(ptrs[p0 + j]);
      vec = vec && (ptrs[p0 + j] & 15) == 0;
    }
    g.vec = vec;
    g.nvec = vec ? (int)(n * esize / 16) : 0;
    g.tile0 = (int)tiles;
    tiles += vec ? (g.nvec > 0 ? ceil_div(g.nvec, MC_TILE) : 1)
                 : ceil_div(n, (long long)MC_TILE * 4);
    if (tiles > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  }
  d.n_seg = (int)n_seg;
  d.tiles = (int)tiles;
  const long long cap = (long long)MC_BLOCKS_SM * sm_count();
  mesh_combine_kernel<<<(unsigned)(tiles < cap ? tiles : cap), MC_THREADS,
                        0, st>>>(d);
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
