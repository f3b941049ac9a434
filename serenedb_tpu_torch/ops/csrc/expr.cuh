// The expression interpreter and descriptor layout shared by the port's
// scan kernels (agg.cu, topn.cu, join.cu).
//
// A scan kernel reads one descriptor of DESC_WORDS int64 words (built by
// ops/agg_kernels.py `new_descriptor`; keep the constants in step with
// it): 16 header words whose meaning each kernel defines, then the input
// columns (data, mask, decode kind, frame-of-reference offset), direct
// key plans, predicate programs, per-kernel aggregate entries and the
// flat postfix programs lowered by exec/device.py `compile_expr`. A
// program is interpreted per row on a small register stack of (32-bit
// value, valid bit) entries with SQL three-valued logic.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace expr {

constexpr int DESC_WORDS = 480;
// header words every kernel reads the same way
constexpr int H_NKEYS = 1, H_NPREDS = 3, H_NAGGS = 4, H_ROWMASK = 6;
constexpr int D_COLS = 16, D_KEYS = 80, D_PREDS = 112, D_AGGS = 128,
              D_OPS = 288;
constexpr int COL_W = 4, KEY_W = 4, PRED_W = 2, AGG_W = 10;
constexpr int MAX_AGGS = 16, MAX_STACK = 8;

enum {
  OP_COL, OP_I32, OP_F32, OP_NULL, OP_I2F, OP_F2I, OP_TOBOOL_I, OP_TOBOOL_F,
  OP_NOT, OP_AND, OP_OR, OP_IS_NULL, OP_IS_NOT_NULL, OP_CMP_I, OP_CMP_F,
  OP_ADD_I, OP_SUB_I, OP_MUL_I, OP_ADD_F, OP_SUB_F, OP_MUL_F, OP_WRAP8,
  OP_SETV, OP_SHRA, OP_SHRL, OP_ANDI, OP_GATE, OP_NVL
};
enum { COL_I32, COL_I8, COL_F32, COL_U8, COL_U16 };
enum { KEY_DICT, KEY_INT };

constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t IMG_POS_INF = 0xFF800000u;  // image of +inf
constexpr uint32_t IMG_NEG_INF = 0x007FFFFFu;  // image of -inf

// The descriptor travels by value as a kernel parameter (3,840 bytes of
// the 4 KiB allowed; agg.cu and topn.cu pass it so): no upload, no copy
// to wait for.
struct Desc {
  long long w[DESC_WORDS];
};

// Copy the descriptor into the block's shared memory (every thread calls
// it; it ends with a barrier).
__device__ __forceinline__ void load_desc(const long long* __restrict__ g,
                                          long long* d) {
  for (int i = threadIdx.x; i < DESC_WORDS; i += blockDim.x) d[i] = g[i];
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T* ptr(long long w) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(w));
}

// Order-preserving u32 image of an f32 (bits given), NaN canonicalised.
__device__ __forceinline__ uint32_t image(uint32_t bits) {
  if ((bits & 0x7F800000u) == 0x7F800000u && (bits & 0x007FFFFFu))
    bits = 0x7FC00000u;
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ bool is_nan_bits(uint32_t bits) {
  return (bits & 0x7F800000u) == 0x7F800000u && (bits & 0x007FFFFFu);
}

// Decoded value (32-bit pattern) and validity of one input slot at `row`.
__device__ __forceinline__ uint32_t load_col(const long long* d, int slot,
                                             long long row, bool& ok) {
  const long long* c = d + D_COLS + COL_W * slot;
  ok = ptr<const uint8_t>(c[1])[row] != 0;
  const uint32_t off = static_cast<uint32_t>(c[3]);
  switch (static_cast<int>(c[2])) {
    case COL_I8:
      return static_cast<uint32_t>(
          static_cast<int32_t>(ptr<const int8_t>(c[0])[row]));
    case COL_U8:
      return static_cast<uint32_t>(ptr<const uint8_t>(c[0])[row]) + off;
    case COL_U16:
      return static_cast<uint32_t>(ptr<const uint16_t>(c[0])[row]) + off;
    default:  // COL_I32, COL_F32: the bits as they are
      return ptr<const uint32_t>(c[0])[row];
  }
}

template <typename T>
__device__ __forceinline__ uint32_t compare(T a, T b, int code) {
  switch (code) {
    case 0: return a == b;
    case 1: return a != b;
    case 2: return a < b;
    case 3: return a <= b;
    case 4: return a > b;
    default: return a >= b;
  }
}

// The interpreter's stack lives in registers: entries shift up on a push
// and down on a pop, so every index is a constant once the loops unroll
// (no local memory), and the valid bits sit in one word, the top in bit 0.
__device__ __forceinline__ void push(uint32_t (&sv)[MAX_STACK], uint32_t& so,
                                     uint32_t v, bool ok) {
#pragma unroll
  for (int i = MAX_STACK - 1; i > 0; --i) sv[i] = sv[i - 1];
  sv[0] = v;
  so = (so << 1) | static_cast<uint32_t>(ok);
}

__device__ __forceinline__ void pop(uint32_t (&sv)[MAX_STACK], uint32_t& so) {
#pragma unroll
  for (int i = 0; i < MAX_STACK - 1; ++i) sv[i] = sv[i + 1];
  so >>= 1;
}

// Run the postfix program ops[start, start+count) for one row.
__device__ __forceinline__ void eval_expr(const long long* d, int start,
                                          int count, long long row,
                                          uint32_t& out_v, bool& out_ok) {
  uint32_t sv[MAX_STACK];
#pragma unroll
  for (int i = 0; i < MAX_STACK; ++i) sv[i] = 0u;
  uint32_t so = 0u;
  for (int i = 0; i < count; ++i) {
    const long long w = d[D_OPS + start + i];
    const int op = static_cast<int>(w & 0xFF);
    const int arg = static_cast<int>((w >> 8) & 0xFFFFFF);
    const uint32_t imm =
        static_cast<uint32_t>(static_cast<unsigned long long>(w) >> 32);
    switch (op) {
      case OP_COL: {
        bool ok;
        const uint32_t v = load_col(d, arg, row, ok);
        push(sv, so, v, ok);
        break;
      }
      case OP_I32:
      case OP_F32:
        push(sv, so, imm, true);
        break;
      case OP_NULL:
        push(sv, so, 0u, false);
        break;
      case OP_I2F:
        sv[0] = __float_as_uint(__int2float_rn(static_cast<int>(sv[0])));
        break;
      case OP_F2I: {
        // PG rounding, half away from zero; the convert saturates and
        // takes NaN to 0 (as XLA's does)
        const float f = __uint_as_float(sv[0]);
        const float r = copysignf(floorf(__fadd_rn(fabsf(f), 0.5f)), f);
        sv[0] = static_cast<uint32_t>(__float2int_rz(r));
        break;
      }
      case OP_TOBOOL_I:
        sv[0] = sv[0] != 0u;
        break;
      case OP_TOBOOL_F:
        sv[0] = __uint_as_float(sv[0]) != 0.0f;
        break;
      case OP_NOT:
        sv[0] ^= 1u;
        break;
      case OP_IS_NULL:
        sv[0] = (so & 1u) ^ 1u;
        so |= 1u;
        break;
      case OP_IS_NOT_NULL:
        sv[0] = so & 1u;
        so |= 1u;
        break;
      case OP_WRAP8:
        sv[0] = static_cast<uint32_t>(static_cast<int32_t>(
            static_cast<int8_t>(static_cast<uint8_t>(sv[0] & 0xFFu))));
        break;
      case OP_SETV:
        sv[0] = imm;
        break;
      case OP_SHRA:
        sv[0] = static_cast<uint32_t>(static_cast<int32_t>(sv[0]) >> imm);
        break;
      case OP_SHRL:
        sv[0] >>= imm;
        break;
      case OP_ANDI:
        sv[0] &= imm;
        break;
      case OP_NVL:  // the value, or imm where it is NULL; valid
        if (!(so & 1u)) sv[0] = imm;
        so |= 1u;
        break;
      default: {  // binary ops: a below b
        const uint32_t a = sv[1], b = sv[0];
        const bool oa = (so >> 1) & 1u, ob = so & 1u;
        pop(sv, so);
        bool ok = oa && ob;
        uint32_t v;
        switch (op) {
          case OP_AND: {
            const bool f = (oa && !a) || (ob && !b);
            v = !f;
            ok = f || ok;
            break;
          }
          case OP_OR: {
            const bool t = (oa && a) || (ob && b);
            v = t;
            ok = t || ok;
            break;
          }
          case OP_GATE:
            // a's value, valid only where the boolean b is TRUE (an
            // aggregate's FILTER clause)
            v = a;
            ok = ok && b != 0u;
            break;
          case OP_CMP_I:
            v = compare(static_cast<int32_t>(a), static_cast<int32_t>(b),
                        arg);
            break;
          case OP_CMP_F:
            v = compare(__uint_as_float(a), __uint_as_float(b), arg);
            break;
          case OP_ADD_I: v = a + b; break;  // wraps, as XLA's int32 does
          case OP_SUB_I: v = a - b; break;
          case OP_MUL_I: v = a * b; break;
          case OP_ADD_F:
            v = __float_as_uint(__fadd_rn(__uint_as_float(a),
                                          __uint_as_float(b)));
            break;
          case OP_SUB_F:
            v = __float_as_uint(__fsub_rn(__uint_as_float(a),
                                          __uint_as_float(b)));
            break;
          default:  // OP_MUL_F
            v = __float_as_uint(__fmul_rn(__uint_as_float(a),
                                          __uint_as_float(b)));
            break;
        }
        sv[0] = v;
        so = (so & ~1u) | static_cast<uint32_t>(ok);
      }
    }
  }
  out_v = sv[0];
  out_ok = so & 1u;
}

// The row's mask: its row-validity byte, then every predicate program
// (a row survives only where each is TRUE).
__device__ __forceinline__ bool row_mask(const long long* d, long long row,
                                         bool in) {
  bool m = in && ptr<const uint8_t>(d[H_ROWMASK])[row] != 0;
  const int n_preds = static_cast<int>(d[H_NPREDS]);
  for (int k = 0; k < n_preds && m; ++k) {
    uint32_t v;
    bool ok;
    eval_expr(d, static_cast<int>(d[D_PREDS + PRED_W * k]),
              static_cast<int>(d[D_PREDS + PRED_W * k + 1]), row, v, ok);
    m = ok && v != 0u;
  }
  return m;
}

// The direct group code of the key plans (kind, slot, lo, size): NULL
// takes the last code of its key, values clip into [0, size).
__device__ __forceinline__ int direct_code(const long long* d,
                                           long long row) {
  int code = 0;
  const int n_keys = static_cast<int>(d[H_NKEYS]);
  for (int k = 0; k < n_keys; ++k) {
    const long long* kp = d + D_KEYS + KEY_W * k;
    const int size = static_cast<int>(kp[3]);
    bool ok;
    const uint32_t v = load_col(d, static_cast<int>(kp[1]), row, ok);
    int c = kp[0] == KEY_DICT
                ? static_cast<int>(v)
                : static_cast<int>(v - static_cast<uint32_t>(kp[2]));
    if (!ok) c = size - 1;
    c = min(max(c, 0), size - 1);
    code = code * size + c;
  }
  return code;
}

}  // namespace expr
