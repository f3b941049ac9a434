// Analytics scan kernels for Hopper (sm_90a), with a plain C interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; each entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrappers, the descriptor layout and
// the plain PyTorch version of each kernel live in ops/agg_kernels.py
// (keep the constants below in step with it).
//
// 1. agg_scan
//    Replaces serenedb_tpu/exec/device_agg.py `_run` → `program`
//    (:251-301), with the ops/agg.py reductions it calls in its body
//    (`group_count_scatter`, `group_sum_int_limbs`, `group_sum_float`,
//    `group_min_max`, `masked_sum_int_partials`, and `_presence_scatter`
//    :455). One call scans rows [row_start, row_end) of one table: per
//    row it decodes the input columns (u8/u16 frame-of-reference + offset,
//    i8, i32, f32), runs the predicate programs — flat postfix programs
//    lowered by exec/device.py, interpreted on a register stack of
//    (32-bit value, valid bit) entries with SQL three-valued logic — forms
//    the group code (direct key plans, factorized codes, or one group) and
//    evaluates each aggregate's argument program.
//    The split: block b owns rows [b·RPB, (b+1)·RPB) of the range and
//    walks them 256 at a time, thread t on row base + t (warp w on the
//    32 rows base + 32w ...); RPB and the block count P depend only on
//    the row count. The descriptor is a kernel parameter (no upload), and
//    the call sets its outputs' starting values itself (`init_kernel`,
//    one launch before the scan), so the wrapper allocates them unset.
//    The wrapper picks one of four regimes from the spec:
//    - SCALAR (G == 1): each thread accumulates its rows in its own
//      shared-memory slots ([aggregate][thread]: no run-time-indexed
//      array, so nothing spills to local memory); at the end a warp then
//      block reduction issues one global atomic per block and output. An
//      f32 sum is the thread's rows in row order, then the warp's 32
//      partials in a fixed shuffle tree (lane i + lane i+16, then +8, +4,
//      +2, +1), then the block's 8 warp sums in warp order: one plane
//      cell per block.
//    - SMALL (every aggregate's cells for all G groups fit the block's
//      shared-memory budget): block-private cells; counts, int64 sums and
//      min/max (on order-preserving u32 images for f32) take shared
//      atomics, exact in any order. An f32 sum keeps one shared row per
//      warp: lanes of one code find each other with __match_any_sync and
//      the lowest adds its peers' values in lane order, so each cell is
//      the warp's rows of its group in row order; the block folds its 8
//      rows in warp order into plane row b, written without atomics.
//      Each block flushes once: one global atomic per nonzero cell.
//    - LARGE (no f32 sum): one global atomic per (warp step, code) and
//      output: the lanes of one code elect a leader with
//      __match_any_sync, which reduces its peers' values (it pays on
//      skewed codes and costs little where a warp's codes are distinct:
//      PERF.md §6).
//    - SORT (large G with an f32 sum): no atomics. Pass 1 writes each
//      row's code, a bit per aggregate that takes it and the aggregates'
//      values; a stable counting sort by code bucket (per-warp bucket
//      histograms over fixed row ranges, a prefix per bucket, the bucket
//      bases, a stable scatter) puts each bucket's rows in row order; one
//      warp per bucket then reduces each code's rows in row order into
//      its cells. An f32 sum is 0 + the group's rows in row order, as
//      np.add.at adds them: no plane, no fold (P = 1).
//    - DISTINCT: each (group, value) cell of the presence grid gets a 1,
//      a plain store from every row that has it (all write the same 1).
//    Integer addition commutes exactly, so every integer output is
//    independent of thread order; the f32 orders above are fixed by
//    (rows, G) alone.
//    Bound: bytes — each input tile, mask, the row mask and the codes are
//    read once; the accumulators are small next to them. The interpreter
//    (a switch per op per row) costs instructions, not bytes.
//
// 2. agg_fold
//    The second half of the float sums: out[g] is the sum of plane[p, g]
//    over p in a fixed two-level order. Runs of L = max(16, ceil(P/256))
//    consecutive p: run r adds plane[rL, g] + plane[rL+1, g] + ... in
//    order; then the R = ceil(P/L) <= 256 run sums add in order of r.
//    One launch: a block owns 32 groups, lanes along g so the reads
//    coalesce; its rows of threads (as many as the runs, up to 32) take
//    the runs, shared memory holds their sums and one row adds them in
//    order. P == 1 copies the row.
//    Bound: bytes — the plane is read once.

#include "expr.cuh"

namespace {

using namespace expr;

// agg_scan's header words (ops/agg_kernels.py); word 0 holds the column
// count, which the kernel does not need
constexpr int H_FACT = 2, H_G = 5, H_CODES = 7, H_ROWCOUNT = 8,
              H_ROW_START = 9, H_ROW_END = 10, H_RPB = 11, H_SCRATCH = 14;

enum {
  AGG_COUNT, AGG_SUM_I, AGG_SUM_F, AGG_MIN_I, AGG_MAX_I, AGG_MIN_F,
  AGG_MAX_F, AGG_PRESENCE
};
enum { RED_SUM, RED_MIN, RED_MAX };
enum { REGIME_SCALAR, REGIME_SMALL, REGIME_LARGE, REGIME_SORT };

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
// the counting sort of the LARGE regime's f32 sums
constexpr long long SORT_RANGE = 2048;  // rows a warp histograms, scatters
constexpr int SORT_MIN_BITS = 8, SORT_MAX_BUCKETS = 4096;
constexpr int SORT_WARPS = 4;  // warps per block of the sort kernels
// agg_fold
constexpr long long FOLD_RUNS = 256, FOLD_MIN_RUN = 16;
// dynamic shared memory the kernels may ask for (bytes)
constexpr int MAX_DYN_SMEM = 96 << 10;

__device__ __forceinline__ long long combine(long long x, long long y,
                                             int red) {
  return red == RED_SUM ? x + y : (red == RED_MIN ? min(x, y) : max(x, y));
}

// Reduce x over the block; the result is valid in thread 0. Every thread
// of the block calls it.
__device__ long long block_reduce(long long x, int red, long long* s_red) {
  for (int o = 16; o > 0; o >>= 1)
    x = combine(x, __shfl_down_sync(FULL, x, o), red);
  __syncthreads();  // s_red is free again
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < WARPS; ++w) x = combine(x, s_red[w], red);
  return x;
}

// The row's mask and group code; a code outside [0, G) drops the row.
__device__ __forceinline__ bool row_head(const long long* d, long long row,
                                         bool in, int G, int& code) {
  bool m = row_mask(d, row, in);
  code = 0;
  if (in)
    code = d[H_FACT] != 0 ? ptr<const int32_t>(d[H_CODES])[row]
                          : direct_code(d, row);
  if (code < 0 || code >= G) m = false;
  return m;
}

// DISTINCT: the row's (group, value) cell of the presence grid gets a 1.
__device__ __forceinline__ void presence(const long long* d,
                                         const long long* A, long long row,
                                         bool m, int code) {
  if (!m) return;
  bool ok = false;
  const uint32_t v = load_col(d, static_cast<int>(A[6]), row, ok);
  if (!ok) return;
  const int vsize = static_cast<int>(A[9]);
  int vc = A[7] == KEY_DICT
               ? static_cast<int>(v)
               : static_cast<int>(v - static_cast<uint32_t>(A[8]));
  vc = min(max(vc, 0), vsize - 1);
  ptr<int32_t>(A[3])[static_cast<long long>(code) * vsize + vc] = 1;
}

// ---------------------------------------------------------------- SCALAR

// Every scan kernel is __launch_bounds__(THREADS, 1): without a minimum
// block count ptxas caps the registers low enough to spill.
__global__ void __launch_bounds__(THREADS, 1)
    agg_scalar_kernel(const __grid_constant__ Desc desc) {
  __shared__ long long d[DESC_WORDS];
  __shared__ long long s_red[WARPS];
  __shared__ float s_f[WARPS];
  extern __shared__ __align__(8) unsigned char smem[];
  load_desc(desc.w, d);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  // per aggregate and thread: a value (count, int64 sum, f32 sum bits,
  // min/max), a count and a non-NaN count
  long long* acc = reinterpret_cast<long long*>(smem);
  uint32_t* cnt = reinterpret_cast<uint32_t*>(acc + n_aggs * THREADS);
  uint32_t* cnt2 = cnt + n_aggs * THREADS;
  for (int a = 0; a < n_aggs; ++a) {
    const int kind = static_cast<int>(d[D_AGGS + AGG_W * a]);
    acc[a * THREADS + tid] =
        kind == AGG_MIN_I   ? INT32_MAX
        : kind == AGG_MAX_I ? INT32_MIN
        : kind == AGG_MIN_F ? static_cast<long long>(IMG_POS_INF)
        : kind == AGG_MAX_F ? static_cast<long long>(IMG_NEG_INF)
                            : 0;
    cnt[a * THREADS + tid] = 0;
    cnt2[a * THREADS + tid] = 0;
  }

  const long long r0 = d[H_ROW_START] + blockIdx.x * d[H_RPB];
  const long long r1 = min(r0 + d[H_RPB], d[H_ROW_END]);
  uint32_t rc = 0;
  for (long long base = r0; base < r1; base += THREADS) {
    const long long row = base + tid;
    int code;
    const bool m = row_head(d, row, row < r1, 1, code);
    rc += m;
    for (int a = 0; a < n_aggs; ++a) {
      const long long* A = d + D_AGGS + AGG_W * a;
      const int kind = static_cast<int>(A[0]);
      if (kind == AGG_PRESENCE) {
        presence(d, A, row, m, 0);
        continue;
      }
      uint32_t v = 0;
      bool ok = false;
      if (m)
        eval_expr(d, static_cast<int>(A[1]), static_cast<int>(A[2]), row, v,
                  ok);
      if (!(m && ok)) continue;
      const int s = a * THREADS + tid;
      cnt[s] += 1;
      switch (kind) {
        case AGG_COUNT:
          break;
        case AGG_SUM_I:
          acc[s] += static_cast<int32_t>(v);
          break;
        case AGG_SUM_F:
          acc[s] = __float_as_uint(__fadd_rn(
              __uint_as_float(static_cast<uint32_t>(acc[s])),
              __uint_as_float(v)));
          break;
        case AGG_MIN_I:
          acc[s] = min(acc[s], static_cast<long long>(
                                   static_cast<int32_t>(v)));
          break;
        case AGG_MAX_I:
          acc[s] = max(acc[s], static_cast<long long>(
                                   static_cast<int32_t>(v)));
          break;
        case AGG_MIN_F:
          if (!is_nan_bits(v)) {
            cnt2[s] += 1;
            acc[s] = min(acc[s], static_cast<long long>(image(v)));
          }
          break;
        default:  // AGG_MAX_F
          acc[s] = max(acc[s], static_cast<long long>(image(v)));
          break;
      }
    }
  }

  // one atomic per block and output
  long long x = block_reduce(rc, RED_SUM, s_red);
  if (tid == 0 && x)
    atomicAdd(ptr<unsigned long long>(d[H_ROWCOUNT]),
              static_cast<unsigned long long>(x));
  for (int a = 0; a < n_aggs; ++a) {
    const long long* A = d + D_AGGS + AGG_W * a;
    const int kind = static_cast<int>(A[0]);
    if (kind == AGG_PRESENCE) continue;
    const int s = a * THREADS + tid;
    x = block_reduce(cnt[s], RED_SUM, s_red);
    if (tid == 0 && x)
      atomicAdd(ptr<unsigned long long>(kind == AGG_COUNT ? A[3] : A[4]),
                static_cast<unsigned long long>(x));
    if (kind == AGG_COUNT) continue;
    if (kind == AGG_SUM_F) {
      float f = __uint_as_float(static_cast<uint32_t>(acc[s]));
      for (int o = 16; o > 0; o >>= 1)
        f = __fadd_rn(f, __shfl_down_sync(FULL, f, o));
      __syncthreads();
      if (lane == 0) s_f[warp] = f;
      __syncthreads();
      if (tid == 0) {
        float t = s_f[0];
        for (int w = 1; w < WARPS; ++w) t = __fadd_rn(t, s_f[w]);
        ptr<float>(A[3])[blockIdx.x] = t;
      }
      continue;
    }
    const int red = (kind == AGG_MIN_I || kind == AGG_MIN_F)   ? RED_MIN
                    : (kind == AGG_MAX_I || kind == AGG_MAX_F) ? RED_MAX
                                                               : RED_SUM;
    x = block_reduce(acc[s], red, s_red);
    if (tid == 0) {
      switch (kind) {
        case AGG_SUM_I:
          if (x) atomicAdd(ptr<unsigned long long>(A[3]),
                           static_cast<unsigned long long>(x));
          break;
        case AGG_MIN_I:
          atomicMin(ptr<int>(A[3]), static_cast<int>(x));
          break;
        case AGG_MAX_I:
          atomicMax(ptr<int>(A[3]), static_cast<int>(x));
          break;
        case AGG_MIN_F:
          atomicMin(ptr<unsigned>(A[3]), static_cast<unsigned>(x));
          break;
        default:  // AGG_MAX_F
          atomicMax(ptr<unsigned>(A[3]), static_cast<unsigned>(x));
          break;
      }
    }
    if (kind == AGG_MIN_F) {
      x = block_reduce(cnt2[s], RED_SUM, s_red);
      if (tid == 0 && x)
        atomicAdd(ptr<unsigned long long>(A[5]),
                  static_cast<unsigned long long>(x));
    }
  }
}

// ----------------------------------------------------------------- SMALL

// Cells of the block, in units of G words (ops/agg_kernels.py
// `small_cells` counts the same): the int64 sums first (two units each),
// then the row counts, then per aggregate its 32-bit arrays in order —
// COUNT [count], SUM_I [count], SUM_F [count, 8 warp rows], MIN/MAX_I
// [value, count], MIN_F [image, count, non-NaN count], MAX_F [image,
// count], PRESENCE none.
__device__ __forceinline__ int units32(int kind) {
  switch (kind) {
    case AGG_COUNT:
    case AGG_SUM_I:
      return 1;
    case AGG_SUM_F:
      return 1 + WARPS;
    case AGG_MIN_F:
      return 3;
    case AGG_PRESENCE:
      return 0;
    default:
      return 2;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    agg_small_kernel(const __grid_constant__ Desc desc) {
  __shared__ long long d[DESC_WORDS];
  __shared__ uint32_t s_val[WARPS][32];
  __shared__ int s_o64[MAX_AGGS], s_o32[MAX_AGGS];
  __shared__ int s_n64, s_n32, s_any_f;
  extern __shared__ __align__(8) unsigned char smem[];
  load_desc(desc.w, d);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = static_cast<int>(d[H_G]);
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  if (tid == 0) {
    int n64 = 0, n32 = 1, any_f = 0;  // unit 0: the row counts
    for (int a = 0; a < n_aggs; ++a) {
      const int kind = static_cast<int>(d[D_AGGS + AGG_W * a]);
      s_o64[a] = kind == AGG_SUM_I ? n64++ : -1;
      s_o32[a] = n32;
      n32 += units32(kind);
      any_f |= kind == AGG_SUM_F;
    }
    s_n64 = n64;
    s_n32 = n32;
    s_any_f = any_f;
  }
  __syncthreads();
  long long* c64 = reinterpret_cast<long long*>(smem);
  uint32_t* c32 = reinterpret_cast<uint32_t*>(c64 + s_n64 * G);
  {
    uint32_t* w = reinterpret_cast<uint32_t*>(smem);
    const int words = (2 * s_n64 + s_n32) * G;
    for (int i = tid; i < words; i += THREADS) w[i] = 0u;
    __syncthreads();
    for (int a = 0; a < n_aggs; ++a) {
      const int kind = static_cast<int>(d[D_AGGS + AGG_W * a]);
      const uint32_t ident =
          kind == AGG_MIN_I   ? static_cast<uint32_t>(INT32_MAX)
          : kind == AGG_MAX_I ? static_cast<uint32_t>(INT32_MIN)
          : kind == AGG_MIN_F ? IMG_POS_INF
          : kind == AGG_MAX_F ? IMG_NEG_INF
                              : 0u;
      if (ident == 0u) continue;
      uint32_t* u = c32 + s_o32[a] * G;
      for (int g = tid; g < G; g += THREADS) u[g] = ident;
    }
    __syncthreads();
  }
  const bool any_f = s_any_f != 0;

  const long long r0 = d[H_ROW_START] + blockIdx.x * d[H_RPB];
  const long long r1 = min(r0 + d[H_RPB], d[H_ROW_END]);
  for (long long base = r0; base < r1; base += THREADS) {
    const long long row = base + tid;
    int code;
    const bool m = row_head(d, row, row < r1, G, code);
    if (m) atomicAdd(&c32[code], 1u);
    unsigned peers = 0;
    if (any_f) peers = __match_any_sync(FULL, m ? code : -1);
    for (int a = 0; a < n_aggs; ++a) {
      const long long* A = d + D_AGGS + AGG_W * a;
      const int kind = static_cast<int>(A[0]);
      if (kind == AGG_PRESENCE) {
        presence(d, A, row, m, code);
        continue;
      }
      uint32_t v = 0;
      bool ok = false;
      if (m)
        eval_expr(d, static_cast<int>(A[1]), static_cast<int>(A[2]), row, v,
                  ok);
      const bool am = m && ok;
      uint32_t* u = c32 + s_o32[a] * G;
      if (kind == AGG_SUM_F) {
        const unsigned act = __ballot_sync(FULL, am);
        s_val[warp][lane] = v;
        __syncwarp();
        if (am) atomicAdd(&u[code], 1u);
        unsigned mine = act & peers;
        if (m && lane == __ffs(peers) - 1 && mine) {
          float* cell = reinterpret_cast<float*>(u + (1 + warp) * G) + code;
          float s = *cell;
          while (mine) {
            const int l = __ffs(mine) - 1;
            mine &= mine - 1;
            s = __fadd_rn(s, __uint_as_float(s_val[warp][l]));
          }
          *cell = s;
        }
        __syncwarp();
        continue;
      }
      if (!am) continue;
      switch (kind) {
        case AGG_COUNT:
          atomicAdd(&u[code], 1u);
          break;
        case AGG_SUM_I:
          atomicAdd(reinterpret_cast<unsigned long long*>(
                        c64 + s_o64[a] * G + code),
                    static_cast<unsigned long long>(
                        static_cast<long long>(static_cast<int32_t>(v))));
          atomicAdd(&u[code], 1u);
          break;
        case AGG_MIN_I:
          atomicMin(reinterpret_cast<int*>(u) + code, static_cast<int>(v));
          atomicAdd(&u[G + code], 1u);
          break;
        case AGG_MAX_I:
          atomicMax(reinterpret_cast<int*>(u) + code, static_cast<int>(v));
          atomicAdd(&u[G + code], 1u);
          break;
        case AGG_MIN_F:
          atomicAdd(&u[G + code], 1u);
          if (!is_nan_bits(v)) {
            atomicAdd(&u[2 * G + code], 1u);
            atomicMin(&u[code], image(v));
          }
          break;
        default:  // AGG_MAX_F
          atomicAdd(&u[G + code], 1u);
          atomicMax(&u[code], image(v));
          break;
      }
    }
  }
  __syncthreads();

  // flush: one global atomic per nonzero cell, the plane rows as stores
  unsigned long long* rowcount = ptr<unsigned long long>(d[H_ROWCOUNT]);
  for (int g = tid; g < G; g += THREADS)
    if (c32[g]) atomicAdd(&rowcount[g], static_cast<unsigned long long>(c32[g]));
  for (int a = 0; a < n_aggs; ++a) {
    const long long* A = d + D_AGGS + AGG_W * a;
    const int kind = static_cast<int>(A[0]);
    if (kind == AGG_PRESENCE) continue;
    const uint32_t* u = c32 + s_o32[a] * G;
    unsigned long long* out0 = ptr<unsigned long long>(A[3]);
    unsigned long long* cnt_out = ptr<unsigned long long>(A[4]);
    for (int g = tid; g < G; g += THREADS) {
      switch (kind) {
        case AGG_COUNT:
          if (u[g]) atomicAdd(&out0[g], static_cast<unsigned long long>(u[g]));
          break;
        case AGG_SUM_I: {
          if (!u[g]) break;
          const long long s = c64[s_o64[a] * G + g];
          if (s) atomicAdd(&out0[g], static_cast<unsigned long long>(s));
          atomicAdd(&cnt_out[g], static_cast<unsigned long long>(u[g]));
          break;
        }
        case AGG_SUM_F: {
          if (u[g])
            atomicAdd(&cnt_out[g], static_cast<unsigned long long>(u[g]));
          const float* rows = reinterpret_cast<const float*>(u + G);
          float s = rows[g];
          for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, rows[w * G + g]);
          ptr<float>(A[3])[static_cast<long long>(blockIdx.x) * G + g] = s;
          break;
        }
        case AGG_MIN_I:
        case AGG_MAX_I:
          if (!u[G + g]) break;
          if (kind == AGG_MIN_I)
            atomicMin(ptr<int>(A[3]) + g, static_cast<int>(u[g]));
          else
            atomicMax(ptr<int>(A[3]) + g, static_cast<int>(u[g]));
          atomicAdd(&cnt_out[g], static_cast<unsigned long long>(u[G + g]));
          break;
        case AGG_MIN_F:
          if (!u[G + g]) break;
          atomicAdd(&cnt_out[g], static_cast<unsigned long long>(u[G + g]));
          if (u[2 * G + g]) {
            atomicAdd(ptr<unsigned long long>(A[5]) + g,
                      static_cast<unsigned long long>(u[2 * G + g]));
            atomicMin(ptr<unsigned>(A[3]) + g, u[g]);
          }
          break;
        default:  // AGG_MAX_F
          if (!u[G + g]) break;
          atomicAdd(&cnt_out[g], static_cast<unsigned long long>(u[G + g]));
          atomicMax(ptr<unsigned>(A[3]) + g, u[g]);
          break;
      }
    }
  }
}

// ----------------------------------------------------------------- LARGE

__global__ void __launch_bounds__(THREADS, 1)
    agg_large_kernel(const __grid_constant__ Desc desc) {
  __shared__ long long d[DESC_WORDS];
  __shared__ uint32_t s_val[WARPS][32];
  load_desc(desc.w, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = static_cast<int>(d[H_G]);
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  unsigned long long* rowcount = ptr<unsigned long long>(d[H_ROWCOUNT]);

  const long long r0 = d[H_ROW_START] + blockIdx.x * d[H_RPB];
  const long long r1 = min(r0 + d[H_RPB], d[H_ROW_END]);
  for (long long base = r0; base < r1; base += THREADS) {
    const long long row = base + tid;
    int code;
    const bool m = row_head(d, row, row < r1, G, code);
    const unsigned peers = __match_any_sync(FULL, m ? code : -1);
    const bool leader = m && lane == __ffs(peers) - 1;
    if (leader)
      atomicAdd(&rowcount[code],
                static_cast<unsigned long long>(__popc(peers)));
    for (int a = 0; a < n_aggs; ++a) {
      const long long* A = d + D_AGGS + AGG_W * a;
      const int kind = static_cast<int>(A[0]);
      if (kind == AGG_PRESENCE) {
        presence(d, A, row, m, code);
        continue;
      }
      uint32_t v = 0;
      bool ok = false;
      if (m)
        eval_expr(d, static_cast<int>(A[1]), static_cast<int>(A[2]), row, v,
                  ok);
      const bool am = m && ok;
      unsigned long long* out0 = ptr<unsigned long long>(A[3]);
      unsigned long long* cnt_out = ptr<unsigned long long>(A[4]);
      const unsigned act = __ballot_sync(FULL, am);
      const unsigned act_nn = __ballot_sync(FULL, am && !is_nan_bits(v));
      s_val[warp][lane] = v;
      __syncwarp();
      unsigned mine = act & peers;
      if (leader && mine) {
        const unsigned long long c = __popc(mine);
        switch (kind) {
          case AGG_COUNT:
            atomicAdd(&out0[code], c);
            break;
          case AGG_SUM_I: {
            long long s = 0;
            while (mine) {
              const int l = __ffs(mine) - 1;
              mine &= mine - 1;
              s += static_cast<int32_t>(s_val[warp][l]);
            }
            atomicAdd(&out0[code], static_cast<unsigned long long>(s));
            atomicAdd(&cnt_out[code], c);
            break;
          }
          case AGG_MIN_I:
          case AGG_MAX_I: {
            int32_t x = kind == AGG_MIN_I ? INT32_MAX : INT32_MIN;
            while (mine) {
              const int l = __ffs(mine) - 1;
              mine &= mine - 1;
              const int32_t y = static_cast<int32_t>(s_val[warp][l]);
              x = kind == AGG_MIN_I ? min(x, y) : max(x, y);
            }
            if (kind == AGG_MIN_I)
              atomicMin(ptr<int>(A[3]) + code, x);
            else
              atomicMax(ptr<int>(A[3]) + code, x);
            atomicAdd(&cnt_out[code], c);
            break;
          }
          case AGG_MIN_F: {
            unsigned nn = act_nn & peers;
            atomicAdd(&cnt_out[code], c);
            if (nn) {
              atomicAdd(ptr<unsigned long long>(A[5]) + code,
                        static_cast<unsigned long long>(__popc(nn)));
              uint32_t x = IMG_POS_INF;
              while (nn) {
                const int l = __ffs(nn) - 1;
                nn &= nn - 1;
                x = min(x, image(s_val[warp][l]));
              }
              atomicMin(ptr<unsigned>(A[3]) + code, x);
            }
            break;
          }
          default: {  // AGG_MAX_F
            uint32_t x = IMG_NEG_INF;
            while (mine) {
              const int l = __ffs(mine) - 1;
              mine &= mine - 1;
              x = max(x, image(s_val[warp][l]));
            }
            atomicMax(ptr<unsigned>(A[3]) + code, x);
            atomicAdd(&cnt_out[code], c);
            break;
          }
        }
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------------ SORT

// Large G with f32 sums: every aggregate through a stable counting sort
// of the rows by code bucket (buckets of 2^bits codes). Pass 1 writes per
// row one record of 2 + n_aggs words: its code (-1 when dropped), a bit
// per aggregate that takes it, and each aggregate's value; warp w owns
// records [w·SORT_RANGE, ...) in the histogram and scatter passes, which
// move whole records; one warp per bucket then reduces each
// code's rows in row order into its output cells (no atomics: a bucket's
// codes belong to that warp alone).

__global__ void __launch_bounds__(THREADS, 1)
    agg_rows_kernel(const __grid_constant__ Desc desc) {
  __shared__ long long d[DESC_WORDS];
  load_desc(desc.w, d);
  const int G = static_cast<int>(d[H_G]);
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  const int stride = 2 + n_aggs;
  uint32_t* rows = ptr<uint32_t>(d[H_SCRATCH]);
  const long long r0 = d[H_ROW_START] + blockIdx.x * d[H_RPB];
  const long long r1 = min(r0 + d[H_RPB], d[H_ROW_END]);
  for (long long base = r0; base < r1; base += THREADS) {
    const long long row = base + threadIdx.x;
    if (row >= r1) break;
    uint32_t* rec = rows + (row - d[H_ROW_START]) * stride;
    int code;
    const bool m = row_head(d, row, true, G, code);
    uint32_t bits = 0;
    for (int a = 0; a < n_aggs; ++a) {
      const long long* A = d + D_AGGS + AGG_W * a;
      if (A[0] == AGG_PRESENCE) {
        presence(d, A, row, m, code);
        continue;
      }
      uint32_t v = 0;
      bool ok = false;
      if (m)
        eval_expr(d, static_cast<int>(A[1]), static_cast<int>(A[2]), row, v,
                  ok);
      bits |= static_cast<uint32_t>(m && ok) << a;
      rec[2 + a] = v;
    }
    rec[0] = m ? static_cast<uint32_t>(code) : 0xFFFFFFFFu;
    rec[1] = bits;
  }
}

__device__ __forceinline__ int bucket_of(const int32_t* rows, int stride,
                                         long long i, long long r1,
                                         int bits) {
  const int c = i < r1 ? rows[i * stride] : -1;
  return c >= 0 ? c >> bits : -1;
}

// hist[w · nb + b]: rows of bucket b in warp w's range
__global__ void __launch_bounds__(SORT_WARPS * 32)
    sort_hist_kernel(const int32_t* __restrict__ rows, int stride,
                     long long n, int bits, int nb, long long pw,
                     uint32_t* __restrict__ hist) {
  extern __shared__ uint32_t sh[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * SORT_WARPS + warp;
  if (w >= pw) return;
  uint32_t* h = sh + warp * nb;
  for (int b = lane; b < nb; b += 32) h[b] = 0u;
  __syncwarp();
  const long long r0 = w * SORT_RANGE, r1 = min(r0 + SORT_RANGE, n);
  for (long long base = r0; base < r1; base += 32) {
    const int b = bucket_of(rows, stride, base + lane, r1, bits);
    const unsigned peers = __match_any_sync(FULL, b);
    if (b >= 0 && lane == __ffs(peers) - 1) h[b] += __popc(peers);
    __syncwarp();
  }
  for (int b = lane; b < nb; b += 32) hist[w * nb + b] = h[b];
}

// per bucket: the exclusive prefix over the warps (in place), the total.
// Block (32, 8): lanes along 32 buckets, row y sums the y-th eighth of
// the warp ranges, then writes its part of the prefix, loads in batches
__global__ void __launch_bounds__(256)
    sort_prefix_kernel(uint32_t* __restrict__ hist, long long pw, int nb,
                       uint32_t* __restrict__ total) {
  __shared__ uint32_t s[8][32];
  const int b = blockIdx.x * 32 + threadIdx.x, y = threadIdx.y;
  const long long seg = (pw + 7) / 8;
  const long long w0 = min(y * seg, pw), w1 = min(w0 + seg, pw);
  uint32_t sum = 0;
  if (b < nb)
    for (long long w = w0; w < w1; ++w) sum += hist[w * nb + b];
  s[y][threadIdx.x] = sum;
  __syncthreads();
  if (b >= nb) return;
  uint32_t run = 0;
  for (int k = 0; k < y; ++k) run += s[k][threadIdx.x];
  if (y == 7) total[b] = run + sum;
  for (long long w = w0; w < w1; w += 8) {
    uint32_t x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = w + k < w1 ? hist[(w + k) * nb + b] : 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (w + k < w1) {
        hist[(w + k) * nb + b] = run;
        run += x[k];
      }
  }
}

// base[b]: the exclusive scan of the totals (one block of 1,024 threads)
__global__ void __launch_bounds__(1024)
    sort_base_kernel(const uint32_t* __restrict__ total, int nb,
                     uint32_t* __restrict__ base) {
  __shared__ uint32_t s[1024];
  const int t = threadIdx.x;
  const int per = (nb + 1023) / 1024;
  const int lo = min(t * per, nb), hi = min(lo + per, nb);
  uint32_t sum = 0;
  for (int b = lo; b < hi; ++b) sum += total[b];
  s[t] = sum;
  __syncthreads();
  for (int o = 1; o < 1024; o <<= 1) {
    const uint32_t x = t >= o ? s[t - o] : 0u;
    __syncthreads();
    s[t] += x;
    __syncthreads();
  }
  uint32_t run = s[t] - sum;
  for (int b = lo; b < hi; ++b) {
    base[b] = run;
    run += total[b];
  }
}

// the stable scatter: each warp walks its records in order again and
// moves each whole to its slot
__global__ void __launch_bounds__(SORT_WARPS * 32)
    sort_scatter_kernel(const int32_t* __restrict__ rows, int stride,
                        long long n, int bits, int nb, long long pw,
                        const uint32_t* __restrict__ hist,
                        const uint32_t* __restrict__ base,
                        int32_t* __restrict__ sorted) {
  extern __shared__ uint32_t sh[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * SORT_WARPS + warp;
  if (w >= pw) return;
  const uint32_t* __restrict__ src = reinterpret_cast<const uint32_t*>(rows);
  uint32_t* __restrict__ dst = reinterpret_cast<uint32_t*>(sorted);
  uint32_t* cur = sh + warp * nb;
  for (int b = lane; b < nb; b += 32) cur[b] = base[b] + hist[w * nb + b];
  __syncwarp();
  const long long r0 = w * SORT_RANGE, r1 = min(r0 + SORT_RANGE, n);
  for (long long i0 = r0; i0 < r1; i0 += 32) {
    const long long i = i0 + lane;
    // the whole record first, in registers (constant indices), so its
    // loads are in flight together with the code's
    uint32_t rec[2 + MAX_AGGS];
#pragma unroll
    for (int k = 0; k < 2 + MAX_AGGS; ++k)
      rec[k] = i < r1 && k < stride ? src[i * stride + k] : 0u;
    const int c = i < r1 ? static_cast<int>(rec[0]) : -1;
    const int b = c >= 0 ? c >> bits : -1;
    const unsigned peers = __match_any_sync(FULL, b);
    if (b >= 0) {
      const long long pos =
          cur[b] + __popc(peers & ((1u << lane) - 1u));
#pragma unroll
      for (int k = 0; k < 2 + MAX_AGGS; ++k)
        if (k < stride) dst[pos * stride + k] = rec[k];
    }
    __syncwarp();
    if (b >= 0 && lane == __ffs(peers) - 1) cur[b] += __popc(peers);
    __syncwarp();
  }
}

// 8-byte cell slots a code takes in sort_reduce: the row count, then per
// aggregate its outputs (csrc and agg_kernels.py `reduce_slots`)
__host__ __device__ __forceinline__ int reduce_slots(int kind) {
  switch (kind) {
    case AGG_COUNT:
      return 1;
    case AGG_MIN_F:
      return 3;
    case AGG_PRESENCE:
      return 0;
    default:
      return 2;
  }
}

// one warp per bucket: each code's rows, in row order, into its cells —
// the bucket's cells in shared memory where they fit (smem), else the
// outputs in device memory; a bucket's codes are this warp's alone
__global__ void __launch_bounds__(SORT_WARPS * 32)
    sort_reduce_kernel(const __grid_constant__ Desc desc,
                       const int32_t* __restrict__ sorted, int nb,
                       int bits, int wpb, bool smem,
                       const uint32_t* __restrict__ base,
                       const uint32_t* __restrict__ total) {
  __shared__ uint32_t s_val[SORT_WARPS][32];
  __shared__ int s_slot[MAX_AGGS];
  __shared__ int s_slots;
  extern __shared__ __align__(8) unsigned long long cells[];
  const long long* d = desc.w;
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  if (threadIdx.x == 0) {
    int k = 1;  // slot 0: the row count
    for (int a = 0; a < n_aggs; ++a) {
      s_slot[a] = k;
      k += reduce_slots(static_cast<int>(d[D_AGGS + AGG_W * a]));
    }
    s_slots = k;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * wpb + warp;
  if (warp >= wpb || b >= nb) return;
  const long long G = d[H_G];
  const int W = 1 << bits;
  const long long c0 = static_cast<long long>(b) << bits;
  const int wn = static_cast<int>(min(static_cast<long long>(W), G - c0));
  unsigned long long* mine_cells = cells + static_cast<long long>(warp) *
                                               s_slots * W;
  // the cell of (slot k, code c): the shared slot, or the output itself
  // (an 8- or 4-byte value: f32 sums, int and f32-image min/max)
  auto out_of = [&](int k) -> void* {
    if (k == 0) return ptr<void>(d[H_ROWCOUNT]);
    for (int a = n_aggs - 1; a >= 0; --a)
      if (k >= s_slot[a])
        return ptr<void>(d[D_AGGS + AGG_W * a + 3 + (k - s_slot[a])]);
    return nullptr;
  };
  auto wide = [&](int k) -> bool {  // 8-byte output
    for (int a = n_aggs - 1; a >= 0; --a)
      if (k >= s_slot[a]) {
        const long long kind = d[D_AGGS + AGG_W * a];
        return k > s_slot[a] || kind == AGG_COUNT || kind == AGG_SUM_I;
      }
    return true;
  };
  if (smem) {  // the bucket's cells from the outputs
    for (int k = 0; k < s_slots; ++k) {
      const void* o = out_of(k);
      const bool w8 = wide(k);
      for (int c = lane; c < wn; c += 32)
        mine_cells[k * W + c] =
            w8 ? static_cast<const unsigned long long*>(o)[c0 + c]
               : static_cast<const uint32_t*>(o)[c0 + c];
    }
    __syncwarp();
  }
  auto cell = [&](int k, int c) -> void* {
    if (smem) return mine_cells + k * W + (c - c0);
    return static_cast<char*>(out_of(k)) + (wide(k) ? 8 : 4) *
                                               static_cast<long long>(c);
  };
  const int stride = 2 + n_aggs;
  const long long lo = base[b], hi = lo + total[b];
  for (long long j0 = lo; j0 < hi; j0 += 32) {
    const long long j = j0 + lane;
    const bool in = j < hi;
    const int32_t* rec = sorted + j * stride;
    const int c = in ? rec[0] : -1;
    const uint32_t vm = in ? static_cast<uint32_t>(rec[1]) : 0u;
    const unsigned peers = __match_any_sync(FULL, c);
    const bool leader = c >= 0 && lane == __ffs(peers) - 1;
    if (leader)
      *static_cast<unsigned long long*>(cell(0, c)) += __popc(peers);
    for (int a = 0; a < n_aggs; ++a) {
      const long long* A = d + D_AGGS + AGG_W * a;
      const int kind = static_cast<int>(A[0]);
      if (kind == AGG_PRESENCE) continue;
      const uint32_t v = in ? static_cast<uint32_t>(rec[2 + a]) : 0u;
      const bool ok = (vm >> a) & 1u;
      const unsigned act = __ballot_sync(FULL, ok);
      const unsigned act_nn = __ballot_sync(FULL, ok && !is_nan_bits(v));
      s_val[warp][lane] = v;
      __syncwarp();
      unsigned mine = act & peers;
      if (leader && mine) {
        const int k = s_slot[a];
        const unsigned cnt = __popc(mine);
        unsigned long long* cnt_cell =
            static_cast<unsigned long long*>(cell(k + 1, c));
        switch (kind) {
          case AGG_COUNT:
            *static_cast<unsigned long long*>(cell(k, c)) += cnt;
            break;
          case AGG_SUM_I: {
            long long x = 0;
            while (mine) {
              const int l = __ffs(mine) - 1;
              mine &= mine - 1;
              x += static_cast<int32_t>(s_val[warp][l]);
            }
            *static_cast<unsigned long long*>(cell(k, c)) +=
                static_cast<unsigned long long>(x);
            *cnt_cell += cnt;
            break;
          }
          case AGG_SUM_F: {
            float* f = static_cast<float*>(cell(k, c));
            float x = *f;
            while (mine) {
              const int l = __ffs(mine) - 1;
              mine &= mine - 1;
              x = __fadd_rn(x, __uint_as_float(s_val[warp][l]));
            }
            *f = x;
            *cnt_cell += cnt;
            break;
          }
          case AGG_MIN_I:
          case AGG_MAX_I: {
            int* p = static_cast<int*>(cell(k, c));
            int32_t x = *p;
            while (mine) {
              const int l = __ffs(mine) - 1;
              mine &= mine - 1;
              const int32_t y = static_cast<int32_t>(s_val[warp][l]);
              x = kind == AGG_MIN_I ? min(x, y) : max(x, y);
            }
            *p = x;
            *cnt_cell += cnt;
            break;
          }
          case AGG_MIN_F: {
            *cnt_cell += cnt;
            unsigned nn = act_nn & peers;
            if (nn) {
              *static_cast<unsigned long long*>(cell(k + 2, c)) +=
                  __popc(nn);
              unsigned* p = static_cast<unsigned*>(cell(k, c));
              uint32_t x = *p;
              while (nn) {
                const int l = __ffs(nn) - 1;
                nn &= nn - 1;
                x = min(x, image(s_val[warp][l]));
              }
              *p = x;
            }
            break;
          }
          default: {  // AGG_MAX_F
            unsigned* p = static_cast<unsigned*>(cell(k, c));
            uint32_t x = *p;
            while (mine) {
              const int l = __ffs(mine) - 1;
              mine &= mine - 1;
              x = max(x, image(s_val[warp][l]));
            }
            *p = x;
            *cnt_cell += cnt;
            break;
          }
        }
      }
      __syncwarp();
    }
  }
  if (smem) {  // the cells back to the outputs
    for (int k = 0; k < s_slots; ++k) {
      void* o = out_of(k);
      const bool w8 = wide(k);
      for (int c = lane; c < wn; c += 32) {
        if (w8)
          static_cast<unsigned long long*>(o)[c0 + c] = mine_cells[k * W + c];
        else
          static_cast<uint32_t*>(o)[c0 + c] =
              static_cast<uint32_t>(mine_cells[k * W + c]);
      }
    }
  }
}

// ------------------------------------------------------------------ fold

// The sum of run r of group g: plane[rL, g] + plane[rL+1, g] + ..., in
// order of p.
__device__ __forceinline__ float fold_run(const float* __restrict__ plane,
                                          long long P, long long G,
                                          long long L, int r, long long g) {
  const long long p0 = r * L, p1 = min(p0 + L, P);
  float x = plane[p0 * G + g];
  long long p = p0 + 1;
  for (; p + 8 <= p1; p += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = plane[(p + k) * G + g];
#pragma unroll
    for (int k = 0; k < 8; ++k) x = __fadd_rn(x, v[k]);
  }
  for (; p < p1; ++p) x = __fadd_rn(x, plane[p * G + g]);
  return x;
}

// Block (32, ry) owns 32 groups: row y adds runs y, y + ry, ..., shared
// memory holds the run sums, and row 0 adds them in order of r.
__global__ void __launch_bounds__(1024)
    fold_kernel(const float* __restrict__ plane, long long P, long long G,
                long long L, int R, float* __restrict__ out) {
  __shared__ float s[FOLD_RUNS][32];
  const long long g = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  if (g < G)
    for (int r = threadIdx.y; r < R; r += blockDim.y)
      s[r][threadIdx.x] = fold_run(plane, P, G, L, r, g);
  __syncthreads();
  if (threadIdx.y != 0 || g >= G) return;
  float t = s[0][threadIdx.x];
  int r = 1;
  for (; r + 8 <= R; r += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = s[r + k][threadIdx.x];
#pragma unroll
    for (int k = 0; k < 8; ++k) t = __fadd_rn(t, v[k]);
  }
  for (; r < R; ++r) t = __fadd_rn(t, s[r][threadIdx.x]);
  out[g] = t;
}

// --------------------------------------------------------------- OUTPUTS

// The outputs' starting values, written by the scan's own call before it
// scans (the wrapper allocates them unset): 0 for the row counts, counts,
// int64 sums, the f32 plane (P x G) and the presence grid (G x vsize);
// a min/max value starts at its order's identity (INT32_MAX, INT32_MIN,
// the images of +inf and -inf). Thread i sets cell i of every output.
__global__ void __launch_bounds__(THREADS)
    init_kernel(const __grid_constant__ Desc desc, long long P,
                long long cells) {
  const long long* d = desc.w;
  const long long G = d[H_G];
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cells; i += step) {
    if (i < G) ptr<long long>(d[H_ROWCOUNT])[i] = 0;
    for (int a = 0; a < n_aggs; ++a) {
      const long long* A = d + D_AGGS + AGG_W * a;
      const int kind = static_cast<int>(A[0]);
      if (kind == AGG_PRESENCE) {
        if (i < G * A[9]) ptr<int32_t>(A[3])[i] = 0;
        continue;
      }
      if (kind == AGG_SUM_F && i < P * G) ptr<float>(A[3])[i] = 0.0f;
      if (i >= G) continue;
      if (kind == AGG_COUNT) {
        ptr<long long>(A[3])[i] = 0;
        continue;
      }
      ptr<long long>(A[4])[i] = 0;  // the count beside each value
      if (kind == AGG_SUM_I)
        ptr<long long>(A[3])[i] = 0;
      else if (kind != AGG_SUM_F)
        ptr<uint32_t>(A[3])[i] =
            kind == AGG_MIN_I   ? static_cast<uint32_t>(INT32_MAX)
            : kind == AGG_MAX_I ? static_cast<uint32_t>(INT32_MIN)
            : kind == AGG_MIN_F ? IMG_POS_INF
                                : IMG_NEG_INF;
      if (kind == AGG_MIN_F) ptr<long long>(A[5])[i] = 0;
    }
  }
}

int sort_bits(long long G) {
  int bits = SORT_MIN_BITS;
  while (((G - 1) >> bits) >= SORT_MAX_BUCKETS) ++bits;
  return bits;
}

bool g_attrs = false;

cudaError_t set_attrs() {
  if (g_attrs) return cudaSuccess;
  const void* kernels[] = {
      reinterpret_cast<const void*>(agg_scalar_kernel),
      reinterpret_cast<const void*>(agg_small_kernel),
      reinterpret_cast<const void*>(sort_hist_kernel),
      reinterpret_cast<const void*>(sort_scatter_kernel),
      reinterpret_cast<const void*>(sort_reduce_kernel)};
  for (const void* k : kernels) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
    if (e != cudaSuccess) return e;
  }
  g_attrs = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One scan: desc is the host's descriptor (DESC_WORDS int64 words),
// passed by value; n_blocks blocks of THREADS threads cover its rows,
// each with smem bytes of dynamic shared memory. SORT: scratch holds, in
// 4-byte words, the n records of 2 + n_aggs words pass 1 writes, the
// same sorted, then the histograms (pw · nb), the bucket totals (nb) and
// bases (nb).
int agg_scan(const void* desc, int regime, long long n_blocks,
             long long smem, long long n, long long G, int n_aggs,
             void* scratch, void* stream) {
  const cudaError_t e = set_attrs();
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Desc& dd = *static_cast<const Desc*>(desc);
  // the outputs' starting values: cells per group to cover, the f32
  // planes' rows (one per block at G = 1 and small G) and the grids'
  const long long P =
      regime == REGIME_SCALAR || regime == REGIME_SMALL ? n_blocks : 1;
  long long span = 1;
  for (int a = 0; a < n_aggs; ++a) {
    const long long* A = dd.w + D_AGGS + AGG_W * a;
    if (A[0] == AGG_SUM_F && P > span) span = P;
    if (A[0] == AGG_PRESENCE && A[9] > span) span = A[9];
  }
  const long long cells = G * span;
  const long long init_blocks = (cells + THREADS - 1) / THREADS;
  init_kernel<<<static_cast<unsigned>(init_blocks < 4096 ? init_blocks
                                                         : 4096),
                THREADS, 0, s>>>(dd, P, cells);
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned nbk = static_cast<unsigned>(n_blocks);
  const size_t sm = static_cast<size_t>(smem);
  switch (regime) {
    case REGIME_SCALAR:
      agg_scalar_kernel<<<nbk, THREADS, sm, s>>>(dd);
      return static_cast<int>(cudaGetLastError());
    case REGIME_SMALL:
      agg_small_kernel<<<nbk, THREADS, sm, s>>>(dd);
      return static_cast<int>(cudaGetLastError());
    case REGIME_LARGE:
      agg_large_kernel<<<nbk, THREADS, 0, s>>>(dd);
      return static_cast<int>(cudaGetLastError());
    default:  // REGIME_SORT
      break;
  }
  agg_rows_kernel<<<nbk, THREADS, 0, s>>>(dd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const int bits = sort_bits(G);
  const int nb = static_cast<int>(((G - 1) >> bits) + 1);
  const long long pw = (n + SORT_RANGE - 1) / SORT_RANGE;
  const int stride = 2 + n_aggs;
  int32_t* rows = static_cast<int32_t*>(scratch);
  int32_t* sorted = rows + stride * n;
  uint32_t* hist = reinterpret_cast<uint32_t*>(sorted + stride * n);
  uint32_t* total = hist + pw * nb;
  uint32_t* base = total + nb;
  const unsigned sort_blocks =
      static_cast<unsigned>((pw + SORT_WARPS - 1) / SORT_WARPS);
  const size_t hist_smem = static_cast<size_t>(SORT_WARPS) * nb * 4;
  sort_hist_kernel<<<sort_blocks, SORT_WARPS * 32, hist_smem, s>>>(
      rows, stride, n, bits, nb, pw, hist);
  sort_prefix_kernel<<<(nb + 31) / 32, dim3(32, 8), 0, s>>>(hist, pw, nb,
                                                          total);
  sort_base_kernel<<<1, 1024, 0, s>>>(total, nb, base);
  sort_scatter_kernel<<<sort_blocks, SORT_WARPS * 32, hist_smem, s>>>(
      rows, stride, n, bits, nb, pw, hist, base, sorted);
  // the bucket's cells: 8-byte slots (row count + each aggregate's) for
  // 2^bits codes a warp, in shared memory while a warp's fit
  int slots = 1;
  for (int a = 0; a < n_aggs; ++a)
    slots += reduce_slots(static_cast<int>(dd.w[D_AGGS + AGG_W * a]));
  const long long warp_bytes = static_cast<long long>(slots) * 8 << bits;
  int wpb = static_cast<int>(MAX_DYN_SMEM / warp_bytes);
  const bool in_smem = wpb > 0;
  wpb = in_smem ? (wpb < SORT_WARPS ? wpb : SORT_WARPS) : SORT_WARPS;
  sort_reduce_kernel<<<(nb + wpb - 1) / wpb, SORT_WARPS * 32,
                       in_smem ? static_cast<size_t>(warp_bytes) * wpb : 0,
                       s>>>(dd, sorted, nb, bits, wpb, in_smem, base,
                            total);
  return static_cast<int>(cudaGetLastError());
}

// out[g] = the fold of plane[p * G + g] over p: runs of L, then the runs.
int agg_fold(const void* plane, long long P, long long G, void* out,
             void* stream) {
  if (G <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  const long long want = (P + FOLD_RUNS - 1) / FOLD_RUNS;
  const long long L = want > FOLD_MIN_RUN ? want : FOLD_MIN_RUN;
  const int R = static_cast<int>((P + L - 1) / L);
  int ry = 1;  // rows of threads: the runs, up to 32
  while (ry < R && ry < 32) ry <<= 1;
  fold_kernel<<<static_cast<unsigned>((G + 31) / 32), dim3(32, ry), 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane), P, G, L, R,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
