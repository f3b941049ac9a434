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
//    :455). One launch scans rows [row_start, row_end) of one table: per
//    row it decodes the input columns (u8/u16 frame-of-reference + offset,
//    i8, i32, f32), runs the predicate programs — flat postfix programs
//    lowered by exec/device.py, interpreted on a small per-thread stack of
//    (32-bit value, valid bit) entries with SQL three-valued logic — forms
//    the group code (direct key plans, factorized codes, or one group) and
//    evaluates each aggregate's argument program.
//    Every warp owns one contiguous range of rows and walks it 32 rows at
//    a time, lane i on row base + i.
//    - G > 1: lanes with the same code find each other with
//      __match_any_sync; the lowest such lane reduces its peers' values
//      (through shared memory) and issues one integer atomic per
//      (warp step, group): counts as u64 adds, int sums as exact int64
//      adds of the int32 values, int min/max as atomicMin/atomicMax, f32
//      min/max as atomicMin/atomicMax of the order-preserving u32 image
//      (NaN made the positive quiet NaN, so it sorts above +inf; MIN skips
//      NaN rows and counts the rest for the PG rule).
//    - G == 1: each thread keeps its accumulators in registers; at the end
//      a warp then block reduction issues one atomic per block and output,
//      so 100M rows never meet on one address.
//    - Float SUM/AVG take no float atomics: warp p owns row p of a (P, G)
//      f32 partial plane, and the lane adding for a group adds its peers'
//      values one by one in lane order, so each cell is the row-order sum
//      of its group's rows in that warp's range, the same on every run.
//    - DISTINCT: each (group, value) cell of the presence grid gets a 1,
//      one store per distinct cell per warp step.
//    Integer addition commutes exactly, so every integer output is
//    independent of thread order.
//    Bound: bytes — each input tile, mask, the row mask and the codes are
//    read once; the accumulators are small next to them. The interpreter
//    (a switch per op per row) costs instructions, not bytes: at a few ops
//    a row it stays under the memory time on this card.
//
// 2. agg_fold
//    The second half of the float sums: out[g] = ((0 + plane[0,g]) +
//    plane[1,g]) + ... in f32, one thread per group, p in order.
//    Bound: bytes — the plane is read once.

#include "expr.cuh"

namespace {

using namespace expr;

// agg_scan's header words (ops/agg_kernels.py); word 0 holds the column
// count, which the kernel does not need
constexpr int H_FACT = 2, H_G = 5, H_CODES = 7, H_ROWCOUNT = 8,
              H_ROW_START = 9, H_ROW_END = 10, H_RPW = 11, H_P = 12;

enum {
  AGG_COUNT, AGG_SUM_I, AGG_SUM_F, AGG_MIN_I, AGG_MAX_I, AGG_MIN_F,
  AGG_MAX_F, AGG_PRESENCE
};
enum { RED_SUM, RED_MIN, RED_MAX };

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

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

__global__ void __launch_bounds__(THREADS)
    agg_scan_kernel(const long long* __restrict__ gdesc) {
  __shared__ long long d[DESC_WORDS];
  __shared__ uint32_t s_val[WARPS][32];
  __shared__ long long s_red[WARPS];
  for (int i = threadIdx.x; i < DESC_WORDS; i += THREADS) d[i] = gdesc[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = static_cast<long long>(blockIdx.x) * WARPS + warp;
  const int G = static_cast<int>(d[H_G]);
  const int n_aggs = static_cast<int>(d[H_NAGGS]);
  const bool fact = d[H_FACT] != 0;
  const bool scalar = G == 1;
  const int32_t* codes = ptr<const int32_t>(d[H_CODES]);
  unsigned long long* rowcount = ptr<unsigned long long>(d[H_ROWCOUNT]);
  const long long rpw = d[H_RPW];
  const long long r0 = d[H_ROW_START] + p * rpw;
  const long long r1 = p < d[H_P] ? min(r0 + rpw, d[H_ROW_END]) : r0;

  // G == 1: per-thread accumulators (count or value, count, non-NaN count)
  long long acc[MAX_AGGS];
  long long cnt[MAX_AGGS];
  long long cnt2[MAX_AGGS];
  float facc[MAX_AGGS];
  long long rc = 0;
  if (scalar) {
    for (int a = 0; a < n_aggs; ++a) {
      const int kind = static_cast<int>(d[D_AGGS + AGG_W * a]);
      acc[a] = kind == AGG_MIN_I   ? INT32_MAX
               : kind == AGG_MAX_I ? INT32_MIN
               : kind == AGG_MIN_F ? static_cast<long long>(IMG_POS_INF)
               : kind == AGG_MAX_F ? static_cast<long long>(IMG_NEG_INF)
                                   : 0;
      cnt[a] = 0;
      cnt2[a] = 0;
      facc[a] = 0.0f;
    }
  }

  for (long long base = r0; base < r1; base += 32) {
    const long long row = base + lane;
    const bool in = row < r1;
    bool m = row_mask(d, row, in);
    int code = 0;
    if (in) code = fact ? codes[row] : direct_code(d, row);
    if (code < 0 || code >= G) m = false;  // out of range: dropped

    unsigned peers = 0;
    bool leader = false;
    if (scalar) {
      rc += m;
    } else {
      peers = __match_any_sync(FULL, m ? code : -1);
      leader = m && lane == __ffs(peers) - 1;
      if (leader)
        atomicAdd(&rowcount[code],
                  static_cast<unsigned long long>(__popc(peers)));
    }

    for (int a = 0; a < n_aggs; ++a) {
      const long long* A = d + D_AGGS + AGG_W * a;
      const int kind = static_cast<int>(A[0]);
      if (kind == AGG_PRESENCE) {
        bool ok = false;
        uint32_t v = 0;
        if (in) v = load_col(d, static_cast<int>(A[6]), row, ok);
        const int vsize = static_cast<int>(A[9]);
        int vc = A[7] == KEY_DICT
                     ? static_cast<int>(v)
                     : static_cast<int>(v - static_cast<uint32_t>(A[8]));
        vc = min(max(vc, 0), vsize - 1);
        const bool pm = m && ok;
        const int cell = code * vsize + vc;
        const unsigned same = __match_any_sync(FULL, pm ? cell : -1);
        if (pm && lane == __ffs(same) - 1) ptr<int32_t>(A[3])[cell] = 1;
        continue;
      }
      uint32_t v = 0;
      bool ok = false;
      if (m)
        eval_expr(d, static_cast<int>(A[1]), static_cast<int>(A[2]), row, v,
                  ok);
      const bool am = m && ok;
      if (scalar) {
        switch (kind) {
          case AGG_COUNT:
            acc[a] += am;
            break;
          case AGG_SUM_I:
            if (am) acc[a] += static_cast<int32_t>(v);
            cnt[a] += am;
            break;
          case AGG_SUM_F: {
            const unsigned act = __ballot_sync(FULL, am);
            s_val[warp][lane] = v;
            __syncwarp();
            if (lane == 0) {
              unsigned mm = act;
              while (mm) {
                const int l = __ffs(mm) - 1;
                mm &= mm - 1;
                facc[a] = __fadd_rn(facc[a], __uint_as_float(s_val[warp][l]));
              }
            }
            __syncwarp();
            cnt[a] += am;
            break;
          }
          case AGG_MIN_I:
            if (am) acc[a] = min(acc[a], static_cast<long long>(
                                             static_cast<int32_t>(v)));
            cnt[a] += am;
            break;
          case AGG_MAX_I:
            if (am) acc[a] = max(acc[a], static_cast<long long>(
                                             static_cast<int32_t>(v)));
            cnt[a] += am;
            break;
          case AGG_MIN_F:
            cnt[a] += am;
            if (am && !is_nan_bits(v)) {
              cnt2[a] += 1;
              acc[a] = min(acc[a], static_cast<long long>(image(v)));
            }
            break;
          default:  // AGG_MAX_F
            cnt[a] += am;
            if (am) acc[a] = max(acc[a], static_cast<long long>(image(v)));
            break;
        }
        continue;
      }
      // G > 1: the leader of each code reduces its peers
      const bool nn = am && !is_nan_bits(v);
      const unsigned act = __ballot_sync(FULL, am);
      const unsigned act_nn = __ballot_sync(FULL, nn);
      s_val[warp][lane] = v;
      __syncwarp();
      unsigned mine = act & peers;
      if (leader && mine) {
        unsigned long long* out0 = ptr<unsigned long long>(A[3]);
        unsigned long long* cnt_out = ptr<unsigned long long>(A[4]);
        const unsigned long long n = __popc(mine);
        switch (kind) {
          case AGG_COUNT:
            atomicAdd(&out0[code], n);
            break;
          case AGG_SUM_I: {
            long long s = 0;
            while (mine) {
              const int l = __ffs(mine) - 1;
              mine &= mine - 1;
              s += static_cast<int32_t>(s_val[warp][l]);
            }
            atomicAdd(&out0[code], static_cast<unsigned long long>(s));
            atomicAdd(&cnt_out[code], n);
            break;
          }
          case AGG_SUM_F: {
            float* cell = ptr<float>(A[3]) + p * G + code;
            float s = *cell;
            while (mine) {
              const int l = __ffs(mine) - 1;
              mine &= mine - 1;
              s = __fadd_rn(s, __uint_as_float(s_val[warp][l]));
            }
            *cell = s;
            atomicAdd(&cnt_out[code], n);
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
            atomicAdd(&cnt_out[code], n);
            break;
          }
          case AGG_MIN_F: {
            unsigned nn_mine = act_nn & peers;
            atomicAdd(&cnt_out[code], n);
            if (nn_mine) {
              atomicAdd(ptr<unsigned long long>(A[5]) + code,
                        static_cast<unsigned long long>(__popc(nn_mine)));
              uint32_t x = IMG_POS_INF;
              while (nn_mine) {
                const int l = __ffs(nn_mine) - 1;
                nn_mine &= nn_mine - 1;
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
            atomicAdd(&cnt_out[code], n);
            break;
          }
        }
      }
      __syncwarp();
    }
  }

  if (!scalar) return;
  // G == 1: one atomic per block and output
  long long x = block_reduce(rc, RED_SUM, s_red);
  if (threadIdx.x == 0 && x)
    atomicAdd(rowcount, static_cast<unsigned long long>(x));
  for (int a = 0; a < n_aggs; ++a) {
    const long long* A = d + D_AGGS + AGG_W * a;
    const int kind = static_cast<int>(A[0]);
    if (kind == AGG_PRESENCE) continue;
    if (kind == AGG_SUM_F) {
      if (lane == 0 && p < d[H_P]) ptr<float>(A[3])[p] = facc[a];
    } else {
      const int red = (kind == AGG_MIN_I || kind == AGG_MIN_F)   ? RED_MIN
                      : (kind == AGG_MAX_I || kind == AGG_MAX_F) ? RED_MAX
                                                                 : RED_SUM;
      x = block_reduce(acc[a], red, s_red);
      if (threadIdx.x == 0) {
        switch (kind) {
          case AGG_COUNT:
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
    }
    if (kind == AGG_COUNT) continue;
    x = block_reduce(cnt[a], RED_SUM, s_red);
    if (threadIdx.x == 0 && x)
      atomicAdd(ptr<unsigned long long>(A[4]),
                static_cast<unsigned long long>(x));
    if (kind == AGG_MIN_F) {
      x = block_reduce(cnt2[a], RED_SUM, s_red);
      if (threadIdx.x == 0 && x)
        atomicAdd(ptr<unsigned long long>(A[5]),
                  static_cast<unsigned long long>(x));
    }
  }
}

__global__ void agg_fold_kernel(const float* __restrict__ plane, long long P,
                                long long G, float* __restrict__ out) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (g >= G) return;
  float acc = 0.0f;
  long long p = 0;
  for (; p + 16 <= P; p += 16) {
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = plane[(p + j) * G + g];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc = __fadd_rn(acc, v[j]);
  }
  for (; p < P; ++p) acc = __fadd_rn(acc, plane[p * G + g]);
  out[g] = acc;
}

}  // namespace

extern "C" {

// One scan: the descriptor (DESC_WORDS int64 words) is already on the
// device; n_blocks blocks of WARPS warps cover its P row ranges.
int agg_scan(const void* desc, long long n_blocks, void* stream) {
  if (n_blocks > 0)
    agg_scan_kernel<<<static_cast<unsigned>(n_blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(desc));
  return static_cast<int>(cudaGetLastError());
}

// out[g] = sum over p of plane[p * G + g], p in order.
int agg_fold(const void* plane, long long P, long long G, void* out,
             void* stream) {
  if (G > 0) {
    const long long blocks = (G + 255) / 256;
    agg_fold_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(plane), P, G, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
