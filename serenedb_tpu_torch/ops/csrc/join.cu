// Fused join kernels for Hopper (sm_90a), with a plain C interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; the entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrapper, the descriptor layout, the
// outputs' layout, the regime rule and the plain PyTorch version live in
// ops/join_kernels.py.
//
// The fused join tier joins through codes, never through pairs: both
// sides' keys share one dense code space (host factorized; NULL build
// keys carry code g, masked or NULL probe rows g + 1, so neither ever
// matches). The build phase — a GROUP BY over the build code, computed
// by agg_scan (agg.cu) — leaves per-code partials on the card: the match
// count, and per build-side aggregate its value count, exact int64 sum
// or int32 min/max. These kernels are the probe phase.
//
// 1. join_probe
//    Replaces serenedb_tpu/exec/device_pipeline.py `_probe_phase`
//    (:1243-1456, K8). Per probe row: the predicate programs (expr.cuh)
//    ANDed with the row mask; the code pc (g + 1 where masked); the match
//    count cnt[pc] and the row's output weight w (cnt, or max(cnt, 1)
//    for LEFT/FULL); the direct group code of the key plans; then one
//    integer accumulation into the (group space) outputs: the output-row
//    count w; per probe-side aggregate its program's value weighted by w
//    (counts, int64 sums, min/max gated on w > 0, FILTER through
//    OP_GATE); per build-side aggregate the partials gathered at pc
//    (min/max gated on a value count > 0); DISTINCT presence grids (one
//    cell per (group, value), set to 1 where w > 0). For RIGHT/FULL it
//    also marks the codes a surviving probe row holds (pcc[pc] = 1).
// 2. join_unmatched (RIGHT/FULL only, after join_probe on the stream)
//    The build rows that survive the build predicates and whose code no
//    surviving probe row matched (pcc == 0) null-extend: their probe
//    side is all NULL, so every reduction lands in the all-NULL group
//    slot (:1381-1434). Each thread keeps its sums in its own shared-
//    memory slots ([aggregate][thread], as agg_scan's SCALAR regime: no
//    run-time-indexed array, no stack frame), then one atomic per warp
//    and output.
//
// One call is init + probe (+ unmatched): `join_init_kernel` sets every
// output's starting value (0, INT32_MAX, INT32_MIN) in the one buffer the
// wrapper carves them from, so the wrapper allocates nothing else. The
// descriptors travel by value as kernel parameters: no upload, no copy
// to wait for.
//
// The probe's regime is picked on the host from the spec alone
// (join_kernels.probe_regime; `probe_regime` below mirrors it and the
// entry refuses a mismatch):
// - SMALL (every output's G cells fit PROBE_SMALL_BYTES of shared memory;
//   every main-path shape, G <= 17): block-private cells that take
//   shared-memory integer atomics (int64 add, int32 min/max), exact in
//   any order. Where most lanes of a warp step add something, the lanes
//   that share a group (__match_any_sync) first reduce each output over a
//   shuffle tree and the group's lowest lane adds it: one atomic a (warp
//   step, group) instead of one a row on the few hot groups of a GROUP
//   BY over a join; else each lane adds its own. Each block flushes once:
//   one global atomic per nonzero cell.
// - LARGE: the lanes of one code elect a leader with __match_any_sync,
//   which adds its peers' values; one global atomic per (warp step,
//   code) and output.
// DISTINCT grids take a plain store of 1 in both, as agg_scan's do.
// Each thread holds ROWS rows a step (codes, masks and the match-count
// gathers of all of them issued before any is used; the interpreter's
// passes loop over them, so its code appears once) and the row loop has
// no barrier; an inner join's row that matches no build row adds nothing
// and is dropped before its key plans and entries. Integer atomics only:
// every output is independent of thread order.
// Bound: bytes — each probe tile, the codes and the row mask are read
// once; the per-code partials are gathered once a surviving row.

#include "expr.cuh"

namespace {

using namespace expr;

// join_probe's header words (ops/join_kernels.py)
constexpr int H_G = 5, H_CODES = 7, H_ROWCOUNT = 8, H_ROWS = 10, H_CNT = 11,
              H_GSENT = 12, H_OUTER = 13, H_PCC = 14, H_NULLGC = 15;
enum {
  JP_COUNT, JP_SUM, JP_MIN, JP_MAX, JP_PRESENCE,  // probe-side programs
  JB_COUNT, JB_SUM, JB_MIN, JB_MAX                // build-side partials
};
enum { REGIME_SMALL, REGIME_LARGE };

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 4;  // rows a thread holds in flight a step
// SMALL: a warp step reduces over groups of lanes before its atomics when
// at least this many lanes add something (on the card per-lane atomics are
// faster where a quarter of the rows survive, the reduction where all do;
// PERF.md section 6)
constexpr int AGG_LANES = 16;
// shared bytes of one block's cells in SMALL (join_kernels.py
// PROBE_SMALL_BYTES)
constexpr long long SMALL_BYTES = 48 << 10;
constexpr int MAX_DYN_SMEM = 64 << 10;

typedef unsigned long long u64;

__device__ __forceinline__ bool is_min(int kind) {
  return kind == JP_MIN || kind == JB_MIN;
}
__device__ __forceinline__ bool is_minmax(int kind) {
  return kind == JP_MIN || kind == JP_MAX || kind == JB_MIN ||
         kind == JB_MAX;
}

// 64-bit cell arrays (of G cells) an entry takes in SMALL: a count, a sum
// and a count, or the count beside a min/max; and 32-bit ones: the min/max
// (join_kernels.py `_units` counts the same).
__host__ __device__ __forceinline__ int units64(int kind) {
  return kind == JP_SUM || kind == JB_SUM ? 2
         : kind == JP_PRESENCE             ? 0
                                           : 1;
}
__host__ __device__ __forceinline__ int units32(int kind) {
  return kind == JP_MIN || kind == JP_MAX || kind == JB_MIN ||
                 kind == JB_MAX
             ? 1
             : 0;
}

// Every predicate program TRUE (the row mask is tested by the caller).
__device__ __forceinline__ bool preds_hold(const long long* d,
                                           long long row) {
  const int n_preds = static_cast<int>(d[H_NPREDS]);
  bool m = true;
  for (int k = 0; k < n_preds && m; ++k) {
    uint32_t v;
    bool ok;
    eval_expr(d, static_cast<int>(d[D_PREDS + PRED_W * k]),
              static_cast<int>(d[D_PREDS + PRED_W * k + 1]), row, v, ok);
    m = ok && v != 0u;
  }
  return m;
}

// The presence grid's cell of a row's (group, value).
__device__ __forceinline__ long long presence_cell(const long long* A,
                                                   uint32_t v, int gcode) {
  const int vsize = static_cast<int>(A[9]);
  int vc = A[7] == KEY_DICT
               ? static_cast<int>(v)
               : static_cast<int>(v - static_cast<uint32_t>(A[8]));
  vc = min(max(vc, 0), vsize - 1);
  return static_cast<long long>(gcode) * vsize + vc;
}

// ---------------------------------------------------------------- INIT

// buf (int32 words): [0, zero) set to 0, then max words INT32_MAX (the
// MIN entries' values), then min words INT32_MIN (the MAX entries').
__global__ void __launch_bounds__(THREADS)
    join_init_kernel(int32_t* __restrict__ buf, long long zero,
                     long long n_max, long long n_min) {
  const long long total = zero + n_max + n_min;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < total; i += step)
    buf[i] = i < zero ? 0 : (i < zero + n_max ? INT32_MAX : INT32_MIN);
}

// ---------------------------------------------------------------- PROBE

// The ROWS rows of one thread's step, staged in shared memory (each
// thread its own [r][tid] slots, so no barrier): the code pc, -1 where the
// row adds nothing (it fails the row mask or a predicate, or its weight is
// 0: an inner join's row that matches no build row); the match count cnt
// (a LEFT/FULL row's weight is max(cnt, 1); where cnt is 0 the build
// partials at pc are 0 too, so they are not gathered); the group code gc.
// The loads of one kind for all ROWS rows (row mask and codes, then the
// match counts) are issued before any is used; the interpreter's passes
// (predicates, key plans) walk the rows in a loop, so its code appears
// once.
struct Stage {
  int pc[ROWS][THREADS];
  int gc[ROWS][THREADS];
  long long cnt[ROWS][THREADS];
};

__device__ __forceinline__ void stage_rows(const long long* d, long long base,
                                           Stage& st) {
  const int tid = threadIdx.x;
  const long long n = d[H_ROWS];
  const bool outer = d[H_OUTER] != 0;
  const uint8_t* rm = ptr<const uint8_t>(d[H_ROWMASK]);
  const int32_t* codes = ptr<const int32_t>(d[H_CODES]);
  const long long* cnt_code = ptr<const long long>(d[H_CNT]);
  int pc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = base + r * THREADS;
    pc[r] = row < n && rm[row] != 0 ? codes[row] : -1;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) st.pc[r][tid] = pc[r];
#pragma unroll 1
  for (int r = 0; r < ROWS; ++r)
    if (st.pc[r][tid] >= 0 && !preds_hold(d, base + r * THREADS))
      st.pc[r][tid] = -1;
  long long cnt[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    pc[r] = st.pc[r][tid];
    cnt[r] = pc[r] >= 0 ? cnt_code[pc[r]] : 0;
  }
  int* pcc = ptr<int>(d[H_PCC]);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (pcc != nullptr && pc[r] >= 0) pcc[pc[r]] = 1;
    st.cnt[r][tid] = cnt[r];
    if (!outer && cnt[r] == 0) st.pc[r][tid] = -1;
  }
#pragma unroll 1
  for (int r = 0; r < ROWS; ++r)
    st.gc[r][tid] =
        st.pc[r][tid] >= 0 ? direct_code(d, base + r * THREADS) : 0;
}

__device__ __forceinline__ void add64(long long* cell, long long x) {
  if (x) atomicAdd(reinterpret_cast<u64*>(cell), static_cast<u64>(x));
}

// The lanes of a warp that hold one key (a group, or -1 for rows that do
// not survive): for each lane the lanes of the 1st, 2nd, 4th, 8th and 16th
// peer above it (-1 where there is none), and whether it is the group's
// lowest lane. Every lane of the warp calls it.
struct Peers {
  int src[5];
  bool lead;
};

__device__ __forceinline__ Peers peers_of(int key) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(FULL, key);
  Peers p;
  p.lead = (peers & ((1u << lane) - 1u)) == 0u;
  unsigned t = peers & (0xFFFFFFFEu << lane);  // the peers above this lane
  int k = 0;
#pragma unroll
  for (int o = 1; o <= 16; ++o) {
    if ((o & (o - 1)) == 0) p.src[k++] = t ? __ffs(t) - 1 : -1;
    t &= t - 1u;
  }
  return p;
}

// The sum of x over the lane's group, valid in its lowest lane: a tree
// over the group's ranks (rank i adds rank i + 1, then i + 2, i + 4 ...).
// Integer addition: exact, whatever the order.
__device__ __forceinline__ long long seg_sum(long long x, const Peers& p) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const long long y = __shfl_sync(FULL, x, p.src[i] < 0 ? lane : p.src[i]);
    if (p.src[i] >= 0) x += y;
  }
  return x;
}

__device__ __forceinline__ int seg_minmax(int x, bool want_min,
                                          const Peers& p) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int y = __shfl_sync(FULL, x, p.src[i] < 0 ? lane : p.src[i]);
    if (p.src[i] >= 0) x = want_min ? min(x, y) : max(x, y);
  }
  return x;
}

// SMALL: cells [unit][G] in shared memory — 64-bit units first (the row
// counts, then each entry's in order), then the 32-bit min/max units.
// (THREADS, 1) here and below: without a minimum block count ptxas caps
// these kernels at 40-48 registers and spills.
__global__ void __launch_bounds__(THREADS, 1)
    join_small_kernel(const __grid_constant__ Desc desc) {
  __shared__ long long d[DESC_WORDS];
  __shared__ Stage st;
  __shared__ int s_o64[MAX_AGGS], s_o32[MAX_AGGS];
  __shared__ int s_n64;
  extern __shared__ __align__(8) unsigned char smem[];
  load_desc(desc.w, d);

  const int tid = threadIdx.x;
  const int G = static_cast<int>(d[H_G]);
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  if (tid == 0) {
    int n64 = 1, n32 = 0;  // unit 0: the row counts
    for (int a = 0; a < n_aggs; ++a) {
      const int kind = static_cast<int>(d[D_AGGS + AGG_W * a]);
      s_o64[a] = n64;
      s_o32[a] = n32;
      n64 += units64(kind);
      n32 += units32(kind);
    }
    s_n64 = n64;
  }
  __syncthreads();
  long long* c64 = reinterpret_cast<long long*>(smem);
  int* c32 = reinterpret_cast<int*>(c64 + s_n64 * G);
  for (int i = tid; i < s_n64 * G; i += THREADS) c64[i] = 0;
  for (int a = 0; a < n_aggs; ++a) {
    const int kind = static_cast<int>(d[D_AGGS + AGG_W * a]);
    if (!is_minmax(kind)) continue;
    int* u = c32 + s_o32[a] * G;
    for (int i = tid; i < G; i += THREADS)
      u[i] = is_min(kind) ? INT32_MAX : INT32_MIN;
  }
  __syncthreads();

  const int lane = tid & 31;
  const long long n = d[H_ROWS];
  const long long span = static_cast<long long>(THREADS) * ROWS;
  // warp-uniform steps (the bound is the warp's first row): the group
  // reductions below take every lane
  for (long long base = blockIdx.x * span + tid; base - lane < n;
       base += gridDim.x * span) {
    stage_rows(d, base, st);
#pragma unroll 1
    for (int r = 0; r < ROWS; ++r) {
      const int pc = st.pc[r][tid];
      const bool pm = pc >= 0;
      // most lanes add something: reduce over each group's lanes first
      // (shuffles), else each lane adds its own (atomics); warp-uniform
      const bool agg = __popc(__ballot_sync(FULL, pm)) >= AGG_LANES;
      if (!agg && !pm) continue;
      const long long row = base + r * THREADS;
      const long long cnt = st.cnt[r][tid];
      const long long w = pm ? max(cnt, 1ll) : 0;  // cnt >= 1 unless outer
      const bool gather = pm && cnt > 0;
      const int gc = st.gc[r][tid];
      Peers pe{};
      if (agg) pe = peers_of(pm ? gc : -1);
      const bool lead = pm && (!agg || pe.lead);
      // a value over the lane's group (agg) or the lane's own
      auto sum = [&](long long x) { return agg ? seg_sum(x, pe) : x; };
      auto mm = [&](int x, bool mn) {
        return agg ? seg_minmax(x, mn, pe) : x;
      };
      const long long rw = sum(w);
      if (lead) add64(&c64[gc], rw);
      for (int a = 0; a < n_aggs; ++a) {
        const long long* A = d + D_AGGS + AGG_W * a;
        const int kind = static_cast<int>(A[0]);
        long long* u64c = c64 + s_o64[a] * G + gc;
        int* u32c = c32 + s_o32[a] * G + gc;
        if (kind <= JP_PRESENCE) {
          uint32_t v = 0;
          bool ok = false;
          if (pm)
            eval_expr(d, static_cast<int>(A[1]), static_cast<int>(A[2]),
                      row, v, ok);
          const long long vp = ok ? w : 0;  // w is 0 where !pm
          if (kind == JP_PRESENCE) {
            if (vp > 0) ptr<int32_t>(A[3])[presence_cell(A, v, gc)] = 1;
            continue;
          }
          if (kind == JP_SUM) {
            const long long x =
                sum(static_cast<long long>(static_cast<int32_t>(v)) * vp);
            if (lead) add64(u64c, x);
            u64c += G;  // the count beside the sum
          } else if (kind != JP_COUNT) {  // JP_MIN, JP_MAX
            const bool mn = kind == JP_MIN;
            const int id = mn ? INT32_MAX : INT32_MIN;
            const int x = mm(vp > 0 ? static_cast<int32_t>(v) : id, mn);
            if (lead && x != id) {
              if (mn)
                atomicMin(u32c, x);
              else
                atomicMax(u32c, x);
            }
          }
          const long long c = sum(vp);
          if (lead) add64(u64c, c);
          continue;
        }
        // build-side partials, gathered at the row's code
        const long long gathered =
            gather ? ptr<const long long>(A[6])[pc] : 0;
        if (kind == JB_SUM) {
          const long long x =
              sum(gather ? ptr<const long long>(A[5])[pc] : 0);
          if (lead) add64(u64c, x);
          u64c += G;
        } else if (kind != JB_COUNT) {  // JB_MIN, JB_MAX
          const bool mn = kind == JB_MIN;
          const int id = mn ? INT32_MAX : INT32_MIN;
          const int x =
              mm(gathered > 0 ? ptr<const int32_t>(A[5])[pc] : id, mn);
          if (lead && x != id) {
            if (mn)
              atomicMin(u32c, x);
            else
              atomicMax(u32c, x);
          }
        }
        const long long c = sum(gathered);
        if (lead) add64(u64c, c);
      }
    }
  }
  __syncthreads();

  // flush: one global atomic per nonzero cell
  for (int i = tid; i < G; i += THREADS)
    add64(ptr<long long>(d[H_ROWCOUNT]) + i, c64[i]);
  for (int a = 0; a < n_aggs; ++a) {
    const long long* A = d + D_AGGS + AGG_W * a;
    const int kind = static_cast<int>(A[0]);
    if (kind == JP_PRESENCE) continue;
    const long long* u = c64 + s_o64[a] * G;
    const int* v32 = c32 + s_o32[a] * G;
    for (int i = tid; i < G; i += THREADS) {
      if (kind == JP_SUM || kind == JB_SUM) {
        add64(ptr<long long>(A[3]) + i, u[i]);
        add64(ptr<long long>(A[4]) + i, u[G + i]);
      } else if (is_minmax(kind)) {
        if (!u[i]) continue;  // no value reached this min/max cell
        if (is_min(kind))
          atomicMin(ptr<int>(A[3]) + i, v32[i]);
        else
          atomicMax(ptr<int>(A[3]) + i, v32[i]);
        add64(ptr<long long>(A[4]) + i, u[i]);
      } else {  // JP_COUNT, JB_COUNT
        add64(ptr<long long>(A[3]) + i, u[i]);
      }
    }
  }
}

// LARGE: the lowest lane of each group of peers adds the group's values
// into out[code] with one global atomic. Every lane of the warp calls it.
__device__ __forceinline__ void warp_add(long long* s_val, unsigned peers,
                                         bool leader, long long val,
                                         long long* out, int code) {
  const int lane = threadIdx.x & 31;
  s_val[lane] = val;
  __syncwarp();
  if (leader) {
    long long t = 0;
    unsigned mm = peers;
    while (mm) {
      const int l = __ffs(mm) - 1;
      mm &= mm - 1;
      t += s_val[l];
    }
    add64(out + code, t);
  }
  __syncwarp();
}

__device__ __forceinline__ void warp_minmax(long long* s_val, unsigned peers,
                                            bool leader, bool has,
                                            int32_t val, bool want_min,
                                            int* out, int code) {
  const int lane = threadIdx.x & 31;
  const unsigned with = __ballot_sync(FULL, has) & peers;
  s_val[lane] = val;
  __syncwarp();
  if (leader && with) {
    unsigned mm = with;
    int32_t x = want_min ? INT32_MAX : INT32_MIN;
    while (mm) {
      const int l = __ffs(mm) - 1;
      mm &= mm - 1;
      const int32_t y = static_cast<int32_t>(s_val[l]);
      x = want_min ? min(x, y) : max(x, y);
    }
    if (want_min)
      atomicMin(out + code, x);
    else
      atomicMax(out + code, x);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 1)
    join_large_kernel(const __grid_constant__ Desc desc) {
  __shared__ long long d[DESC_WORDS];
  __shared__ long long s_val[WARPS][32];
  __shared__ Stage st;
  load_desc(desc.w, d);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n = d[H_ROWS];
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  long long* rowcount = ptr<long long>(d[H_ROWCOUNT]);
  long long* sv = s_val[warp];
  const long long span = static_cast<long long>(THREADS) * ROWS;
  // every lane of a warp walks the same steps (the loop's bound is the
  // warp's first row), so the warp-wide steps below see all 32 lanes
  for (long long base = blockIdx.x * span + tid; base - lane < n;
       base += gridDim.x * span) {
    stage_rows(d, base, st);
#pragma unroll 1
    for (int r = 0; r < ROWS; ++r) {
      const long long row = base + r * THREADS;
      const int pc = st.pc[r][tid];
      const bool pm = pc >= 0;
      const long long cnt = st.cnt[r][tid];
      const long long w = pm ? max(cnt, 1ll) : 0;  // cnt >= 1 unless outer
      const int gcode = st.gc[r][tid];
      const unsigned peers = __match_any_sync(FULL, pm ? gcode : -1);
      const bool leader = pm && lane == __ffs(peers) - 1;
      warp_add(sv, peers, leader, w, rowcount, gcode);
      for (int a = 0; a < n_aggs; ++a) {
        const long long* A = d + D_AGGS + AGG_W * a;
        const int kind = static_cast<int>(A[0]);
        if (kind <= JP_PRESENCE) {
          uint32_t v = 0;
          bool ok = false;
          if (pm)
            eval_expr(d, static_cast<int>(A[1]), static_cast<int>(A[2]),
                      row, v, ok);
          const bool m = pm && ok;
          if (kind == JP_PRESENCE) {
            if (m && w > 0)
              ptr<int32_t>(A[3])[presence_cell(A, v, gcode)] = 1;
            continue;
          }
          const long long vp = m ? w : 0;
          if (kind == JP_COUNT) {
            warp_add(sv, peers, leader, vp, ptr<long long>(A[3]), gcode);
          } else if (kind == JP_SUM) {
            warp_add(sv, peers, leader,
                     static_cast<long long>(static_cast<int32_t>(v)) * vp,
                     ptr<long long>(A[3]), gcode);
            warp_add(sv, peers, leader, vp, ptr<long long>(A[4]), gcode);
          } else {  // JP_MIN, JP_MAX
            warp_minmax(sv, peers, leader, m && w > 0,
                        static_cast<int32_t>(v), kind == JP_MIN,
                        ptr<int>(A[3]), gcode);
            warp_add(sv, peers, leader, vp, ptr<long long>(A[4]), gcode);
          }
          continue;
        }
        const long long gathered =
            pm && cnt > 0 ? ptr<const long long>(A[6])[pc] : 0;
        if (kind == JB_COUNT) {
          warp_add(sv, peers, leader, gathered, ptr<long long>(A[3]), gcode);
        } else if (kind == JB_SUM) {
          warp_add(sv, peers, leader,
                   pm && cnt > 0 ? ptr<const long long>(A[5])[pc] : 0,
                   ptr<long long>(A[3]), gcode);
          warp_add(sv, peers, leader, gathered, ptr<long long>(A[4]), gcode);
        } else {  // JB_MIN, JB_MAX
          const bool has = gathered > 0;
          warp_minmax(sv, peers, leader, has,
                      has ? ptr<const int32_t>(A[5])[pc] : 0,
                      kind == JB_MIN, ptr<int>(A[3]), gcode);
          warp_add(sv, peers, leader, gathered, ptr<long long>(A[4]), gcode);
        }
      }
    }
  }
}

// ------------------------------------------------------------ UNMATCHED

__device__ __forceinline__ long long warp_reduce(long long x, int red) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_down_sync(FULL, x, o);
    x = red == 0 ? x + y : (red == 1 ? min(x, y) : max(x, y));
  }
  return x;
}

// Per aggregate and thread a value (count, sum, min or max) and a count,
// in shared memory ([aggregate][thread]).
__global__ void __launch_bounds__(THREADS, 1)
    join_unmatched_kernel(const __grid_constant__ Desc desc) {
  __shared__ long long d[DESC_WORDS];
  extern __shared__ __align__(8) unsigned char smem[];
  load_desc(desc.w, d);

  const int tid = threadIdx.x, lane = tid & 31;
  const long long n = d[H_ROWS];
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  const int32_t* codes = ptr<const int32_t>(d[H_CODES]);
  const int* pcc = ptr<const int>(d[H_PCC]);
  const int null_gc = static_cast<int>(d[H_NULLGC]);
  long long* acc = reinterpret_cast<long long*>(smem);
  long long* cnt = acc + n_aggs * THREADS;
  for (int a = 0; a < n_aggs; ++a) {
    const int kind = static_cast<int>(d[D_AGGS + AGG_W * a]);
    acc[a * THREADS + tid] =
        kind == JB_MIN ? INT32_MAX : (kind == JB_MAX ? INT32_MIN : 0);
    cnt[a * THREADS + tid] = 0;
  }
  long long ub = 0;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long row = static_cast<long long>(blockIdx.x) * THREADS + tid;
       row < n; row += step) {
    if (!row_mask(d, row, true) || pcc[codes[row]] != 0) continue;
    ++ub;
    for (int a = 0; a < n_aggs; ++a) {
      const long long* A = d + D_AGGS + AGG_W * a;
      const int kind = static_cast<int>(A[0]);
      uint32_t v;
      bool ok;
      eval_expr(d, static_cast<int>(A[1]), static_cast<int>(A[2]), row, v,
                ok);
      if (!ok) continue;
      const long long x = static_cast<int32_t>(v);
      const int s = a * THREADS + tid;
      if (kind == JB_COUNT) {
        acc[s] += 1;
        continue;
      }
      acc[s] = kind == JB_SUM ? acc[s] + x
                              : (kind == JB_MIN ? min(acc[s], x)
                                                : max(acc[s], x));
      cnt[s] += 1;
    }
  }
  ub = warp_reduce(ub, 0);
  if (lane == 0) add64(ptr<long long>(d[H_ROWCOUNT]) + null_gc, ub);
  for (int a = 0; a < n_aggs; ++a) {
    const long long* A = d + D_AGGS + AGG_W * a;
    const int kind = static_cast<int>(A[0]);
    const int red = kind == JB_MIN ? 1 : (kind == JB_MAX ? 2 : 0);
    const long long x = warp_reduce(acc[a * THREADS + tid], red);
    const long long c = warp_reduce(cnt[a * THREADS + tid], 0);
    if (lane != 0) continue;
    if (kind == JB_COUNT || kind == JB_SUM) {
      add64(ptr<long long>(A[3]) + null_gc, x);
    } else if (c) {
      if (kind == JB_MIN)
        atomicMin(ptr<int>(A[3]) + null_gc, static_cast<int>(x));
      else
        atomicMax(ptr<int>(A[3]) + null_gc, static_cast<int>(x));
    }
    if (kind != JB_COUNT) add64(ptr<long long>(A[4]) + null_gc, c);
  }
}

// ------------------------------------------------------------- HELPERS

// The regime of a probe over G groups with these entries (the host's
// join_kernels.probe_regime).
int probe_regime(const Desc& dd, long long* cells) {
  const long long G = dd.w[H_G];
  const int n_aggs = static_cast<int>(dd.w[H_NAGGS]);
  long long n64 = 1, n32 = 0;
  for (int a = 0; a < n_aggs; ++a) {
    const int kind = static_cast<int>(dd.w[D_AGGS + AGG_W * a]);
    n64 += units64(kind);
    n32 += units32(kind);
  }
  *cells = (8 * n64 + 4 * n32) * G;
  return *cells <= SMALL_BYTES ? REGIME_SMALL : REGIME_LARGE;
}

int g_sms = 0;

cudaError_t prepare() {
  if (g_sms) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const void* kernels[] = {reinterpret_cast<const void*>(join_small_kernel),
                           reinterpret_cast<const void*>(
                               join_unmatched_kernel)};
  for (const void* k : kernels)
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
  if (e == cudaSuccess) g_sms = sms;
  return e;
}

// Blocks of a pass over n rows, `per` rows a block a step: at most four
// blocks an SM, each walking its steps.
unsigned blocks_for(long long n, long long per) {
  const long long want = (n + per - 1) / per;
  const long long cap = 4ll * g_sms;
  return static_cast<unsigned>(want < 1 ? 1 : (want > cap ? cap : want));
}

}  // namespace

extern "C" {

// One probe call: desc (DESC_WORDS int64 words, host memory) by value;
// `regime` as the host picked it (refused if the rule here disagrees);
// n probe rows. buf holds every output (int32 words: zero words set to 0,
// then n_max to INT32_MAX, then n_min to INT32_MIN; the descriptor's
// pointers point into it). udesc (or NULL) is the RIGHT/FULL unmatched
// pass over un build rows. Launches: init, probe, and unmatched when
// udesc is given.
int join_probe(const void* desc, int regime, long long n, void* buf,
               long long zero, long long n_max, long long n_min,
               const void* udesc, long long un, void* stream) {
  cudaError_t e = prepare();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Desc& dd = *static_cast<const Desc*>(desc);
  long long cells = 0;
  const long long un_aggs =
      udesc != nullptr ? static_cast<const Desc*>(udesc)->w[H_NAGGS] : 0;
  if (probe_regime(dd, &cells) != regime || un_aggs < 0 ||
      un_aggs > MAX_AGGS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = zero + n_max + n_min;
  const long long ib = (words + THREADS - 1) / THREADS;
  join_init_kernel<<<static_cast<unsigned>(ib < 1 ? 1 : (ib > 1024 ? 1024
                                                                   : ib)),
                     THREADS, 0, s>>>(static_cast<int32_t*>(buf), zero,
                                      n_max, n_min);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned nb = blocks_for(n, static_cast<long long>(THREADS) * ROWS);
  if (n > 0) {
    if (regime == REGIME_SMALL)
      join_small_kernel<<<nb, THREADS, static_cast<size_t>(cells), s>>>(dd);
    else
      join_large_kernel<<<nb, THREADS, 0, s>>>(dd);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (udesc != nullptr && un > 0)
    join_unmatched_kernel<<<blocks_for(un, THREADS), THREADS,
                            static_cast<size_t>(un_aggs) * THREADS * 16,
                            s>>>(*static_cast<const Desc*>(udesc));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
