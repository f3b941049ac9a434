// Fused join kernels for Hopper (sm_90a), with a plain C interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; each entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrappers, the descriptor layout and
// the plain PyTorch version live in ops/join_kernels.py.
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
//    also counts the surviving probe rows of each code (pcc).
// 2. join_unmatched (RIGHT/FULL only, after join_probe on the stream)
//    The build rows that survive the build predicates and whose code no
//    surviving probe row matched (pcc == 0) null-extend: their probe
//    side is all NULL, so every reduction lands in the all-NULL group
//    slot (:1381-1434). Per-thread accumulators, then one atomic per warp
//    and output.
// Integer atomics only: every output is independent of thread order.
// Lanes of a warp that share a group code merge first (__match_any_sync;
// the lowest lane adds its peers' values), as in agg_scan.
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

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_BLOCKS = 132 * 16;

typedef unsigned long long u64;

// The lowest lane of each group of peers adds the group's values into
// out[code]. Every lane of the warp calls it.
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
    if (t) atomicAdd(reinterpret_cast<u64*>(out) + code, static_cast<u64>(t));
  }
  __syncwarp();
}

__device__ __forceinline__ void warp_minmax(long long* s_val, unsigned peers,
                                            bool leader, bool has,
                                            int32_t val, bool is_min,
                                            int* out, int code) {
  const int lane = threadIdx.x & 31;
  const unsigned with = __ballot_sync(FULL, has) & peers;
  s_val[lane] = val;
  __syncwarp();
  if (leader && with) {
    unsigned mm = with;
    int32_t x = is_min ? INT32_MAX : INT32_MIN;
    while (mm) {
      const int l = __ffs(mm) - 1;
      mm &= mm - 1;
      const int32_t y = static_cast<int32_t>(s_val[l]);
      x = is_min ? min(x, y) : max(x, y);
    }
    if (is_min)
      atomicMin(out + code, x);
    else
      atomicMax(out + code, x);
  }
  __syncwarp();
}

// (THREADS, 1): without a minimum block count ptxas caps the registers
// low enough to spill the interpreter's register stack
__global__ void __launch_bounds__(THREADS, 1)
    join_probe_kernel(const long long* __restrict__ gdesc) {
  __shared__ long long d[DESC_WORDS];
  __shared__ long long s_val[WARPS][32];
  for (int i = threadIdx.x; i < DESC_WORDS; i += THREADS) d[i] = gdesc[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = d[H_ROWS];
  const int g = static_cast<int>(d[H_GSENT]);
  const bool outer = d[H_OUTER] != 0;
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  const int32_t* codes = ptr<const int32_t>(d[H_CODES]);
  const long long* cnt_code = ptr<const long long>(d[H_CNT]);
  int* pcc = ptr<int>(d[H_PCC]);
  long long* rowcount = ptr<long long>(d[H_ROWCOUNT]);
  long long* sv = s_val[warp];

  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long base = (static_cast<long long>(blockIdx.x) * WARPS + warp) *
                        32;
       base < n; base += step) {
    const long long row = base + lane;
    const bool in = row < n;
    const bool pm = row_mask(d, row, in);
    const int pc = pm ? codes[row] : g + 1;
    const long long cnt = pm ? cnt_code[pc] : 0;
    const long long w = pm ? (outer ? max(cnt, 1ll) : cnt) : 0;
    const int gcode = pm ? direct_code(d, row) : 0;
    if (pcc != nullptr && pm) atomicAdd(&pcc[pc], 1);
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
          eval_expr(d, static_cast<int>(A[1]), static_cast<int>(A[2]), row,
                    v, ok);
        const bool m = pm && ok;
        if (kind == JP_PRESENCE) {
          const bool pres = m && w > 0;
          const int vsize = static_cast<int>(A[9]);
          int vc = A[7] == KEY_DICT
                       ? static_cast<int>(v)
                       : static_cast<int>(v - static_cast<uint32_t>(A[8]));
          vc = min(max(vc, 0), vsize - 1);
          const int cell = gcode * vsize + vc;
          const unsigned same = __match_any_sync(FULL, pres ? cell : -1);
          if (pres && lane == __ffs(same) - 1) ptr<int32_t>(A[3])[cell] = 1;
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
          warp_minmax(sv, peers, leader, m && w > 0, static_cast<int32_t>(v),
                      kind == JP_MIN, ptr<int>(A[3]), gcode);
          warp_add(sv, peers, leader, vp, ptr<long long>(A[4]), gcode);
        }
        continue;
      }
      // build-side partials, gathered at the row's code
      const long long gathered = pm ? ptr<const long long>(A[6])[pc] : 0;
      if (kind == JB_COUNT) {
        warp_add(sv, peers, leader, gathered, ptr<long long>(A[3]), gcode);
      } else if (kind == JB_SUM) {
        warp_add(sv, peers, leader, pm ? ptr<const long long>(A[5])[pc] : 0,
                 ptr<long long>(A[3]), gcode);
        warp_add(sv, peers, leader, gathered, ptr<long long>(A[4]), gcode);
      } else {  // JB_MIN, JB_MAX
        const bool has = gathered > 0;
        warp_minmax(sv, peers, leader, has,
                    has ? ptr<const int32_t>(A[5])[pc] : 0, kind == JB_MIN,
                    ptr<int>(A[3]), gcode);
        warp_add(sv, peers, leader, gathered, ptr<long long>(A[4]), gcode);
      }
    }
  }
}

__device__ __forceinline__ long long warp_reduce(long long x, int red) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_down_sync(FULL, x, o);
    x = red == 0 ? x + y : (red == 1 ? min(x, y) : max(x, y));
  }
  return x;
}

__global__ void __launch_bounds__(THREADS, 1)
    join_unmatched_kernel(const long long* __restrict__ gdesc) {
  __shared__ long long d[DESC_WORDS];
  for (int i = threadIdx.x; i < DESC_WORDS; i += THREADS) d[i] = gdesc[i];
  __syncthreads();

  const long long n = d[H_ROWS];
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  const int32_t* codes = ptr<const int32_t>(d[H_CODES]);
  const int* pcc = ptr<const int>(d[H_PCC]);
  const int null_gc = static_cast<int>(d[H_NULLGC]);
  long long ub = 0;
  long long acc[MAX_AGGS], cnt[MAX_AGGS];
  for (int a = 0; a < n_aggs; ++a) {
    const int kind = static_cast<int>(d[D_AGGS + AGG_W * a]);
    acc[a] = kind == JB_MIN ? INT32_MAX : (kind == JB_MAX ? INT32_MIN : 0);
    cnt[a] = 0;
  }
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long row = static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x;
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
      if (kind == JB_COUNT) {
        ++acc[a];
      } else {
        acc[a] = kind == JB_SUM ? acc[a] + x
                                : (kind == JB_MIN ? min(acc[a], x)
                                                  : max(acc[a], x));
        ++cnt[a];
      }
    }
  }
  const int lane = threadIdx.x & 31;
  ub = warp_reduce(ub, 0);
  if (lane == 0 && ub)
    atomicAdd(ptr<u64>(d[H_ROWCOUNT]) + null_gc, static_cast<u64>(ub));
  for (int a = 0; a < n_aggs; ++a) {
    const long long* A = d + D_AGGS + AGG_W * a;
    const int kind = static_cast<int>(A[0]);
    const int red = kind == JB_MIN ? 1 : (kind == JB_MAX ? 2 : 0);
    const long long x = warp_reduce(acc[a], red);
    const long long c = warp_reduce(cnt[a], 0);
    if (lane != 0) continue;
    if (kind == JB_COUNT || kind == JB_SUM) {
      if (x) atomicAdd(ptr<u64>(A[3]) + null_gc, static_cast<u64>(x));
    } else if (c) {
      if (kind == JB_MIN)
        atomicMin(ptr<int>(A[3]) + null_gc, static_cast<int>(x));
      else
        atomicMax(ptr<int>(A[3]) + null_gc, static_cast<int>(x));
    }
    if (kind != JB_COUNT && c)
      atomicAdd(ptr<u64>(A[4]) + null_gc, static_cast<u64>(c));
  }
}

unsigned blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

}  // namespace

extern "C" {

// The probe pass over n probe rows; the descriptor (DESC_WORDS int64
// words) is already on the device.
int join_probe(const void* desc, long long n, void* stream) {
  if (n > 0)
    join_probe_kernel<<<blocks_for(n), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(desc));
  return static_cast<int>(cudaGetLastError());
}

// The unmatched-build pass over n build rows (RIGHT/FULL).
int join_unmatched(const void* desc, long long n, void* stream) {
  if (n > 0)
    join_unmatched_kernel<<<blocks_for(n), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(desc));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
