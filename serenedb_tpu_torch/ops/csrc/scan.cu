// The split prepare of a scan statement for Hopper (sm_90a), with a plain C
// interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; the entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrapper, the plan's words and the
// plain PyTorch version live in ops/scan_kernels.py (keep the constants
// below in step with it).
//
// scan_eval
//    Replaces no reference kernel. The reference's XLA traces any
//    expression, however deep or wide, into the one program of K5/K6/K8
//    (serenedb_tpu/exec/device.py:60 `compile_expr`). The port's scan
//    kernels interpret programs on an 8-entry register stack over at most
//    16 input columns, so the planner (exec/device_split.py) splits a
//    statement past those caps across launches, and this kernel runs,
//    once a chunk, every pass that feeds the scan launches, in plan order:
//    - derive passes: one program's value as a column tile (int32, int8
//      or the f32 bits) and its validity; the value of an invalid row is
//      0. A later pass of the same launch reads the value from the
//      thread's own stage in shared memory, as the tile holds it; the
//      scan launches read the tile as an ordinary column slot, so a tile
//      is written only where a scan launch reads it (or the stages run
//      out and a later pass reads it back from the tile: a thread reads
//      only rows it wrote itself, so no fence is needed);
//    - mask passes: the row mask ANDed with each predicate program,
//      written once at the end (a row survives where its rowmask byte is
//      set and every program is TRUE).
//    Every pass is row-local, so one launch does them all with no grid
//    sync, and nothing a pass produces goes through device memory unless
//    a scan launch reads it.
//    Bound: bytes — each input tile and mask read once (the row mask only
//    when there is a mask pass), each written tile, its validity and the
//    row mask written once.
//    What the design does about the costs of a one-row-a-thread
//    interpreter (each op word fetched and dispatched again for every
//    row, 1-byte loads and stores, a 3,840-byte descriptor copied by each
//    of at most 1,024 blocks):
//    - a thread takes R = 8 consecutive rows (a group), neighbouring
//      threads neighbouring groups, so each op word is fetched
//      (warp-uniform, from the plan's words in device memory, the next
//      one prefetched) and dispatched once for 8 rows. Measured: at 4
//      rows a thread the three recorded prepares took 1.5-1.75x as long
//      (the words fetched and dispatched twice as often), and 8 rows
//      still keep the stack's top in registers with no local memory;
//    - a group's input bytes are staged in shared memory by cp.async,
//      every input's at once, the next group's while this one runs (two
//      buffers; one measured within a few percent): an int32/f32 column
//      as two 16-byte copies, a byte column, mask or u16 column as 8 or
//      16 bytes. The ragged last group, and every group of a launch
//      whose base pointers are not all 16-byte aligned, read device
//      memory with scalar loads (the C entry checks). Outputs leave as
//      16- or 8-byte stores. A lane's 16-byte copies of an int32 column
//      lie 32 bytes apart; rows laid out so that a warp's copies are
//      contiguous (a thread's rows as two quads 512 rows apart) were
//      measured no faster at W3's and J6's shapes and 7% slower at W1's
//      (twice the copies for a byte column), and are not kept;
//    - the plan rewrites each program for the kernel (ops/scan_kernels.py
//      `_kernel_ops`): chains of int32 + and *, and of AND / OR, are
//      regrouped left-deep (every valid result the same bits: wrapping
//      int32 arithmetic and Kleene's AND / OR are associative and
//      commutative, and a value under NULL is never observed), and a
//      binary op whose right operand is a column or a constant is one
//      fused op that touches no stack entry. A 12-deep chain of sums
//      runs as 12 fused ops on a stack of depth 1;
//    - the stack keeps its top in registers and the entries below it in
//      the thread's column of shared memory, addressed by the
//      warp-uniform depth (a register array reached through a switch
//      compiled to per-op register moves and a compare tree: measured
//      slower), sized by the deepest program the plan runs;
//    - the plan's words sit in a device buffer, uploaded once a plan and
//      device, not in a larger kernel parameter: a fused prepare's ops
//      grow with its passes past any fixed parameter, while what changes
//      from call to call is only pointers. A call passes those and the
//      row count by value (__grid_constant__: the input pointers are
//      read from the constant bank at uniform indices), at most
//      MAX_INPUTS input pairs (the planner chains launches for a prepare
//      that reads more). No block copies a descriptor, so the grid is
//      sized to the card: the blocks an SM the occupancy calculator
//      gives, times the SMs, each walking its row groups.

#include <type_traits>

#include "expr.cuh"

namespace {

using namespace expr;

// rows a thread (a group)
constexpr int R = 8;
// the staged bytes of a group and the next
constexpr int BUFFERS = 2;
constexpr int THREADS = 128;
// (data, mask) pointer pairs a launch takes by value; stages (one derived
// value a thread's rows, and its valid bits, in shared memory); units of
// THREADS * R bytes of staged input bytes (a slot takes 1 for its mask and
// 1, 2 or 4 for its data)
constexpr int MAX_INPUTS = 128, MAX_STAGES = 16, MAX_RAW_UNITS = 40;
constexpr int NO_RAW = 0xFF;  // a base slot read from device memory
constexpr size_t STAGE_BYTES = (R + 1) * THREADS * sizeof(uint32_t);
// the entries below a program's top, for every thread of the block
constexpr size_t STACK_BYTES = (MAX_STACK - 1) * STAGE_BYTES;
constexpr size_t MAX_SMEM = BUFFERS * MAX_RAW_UNITS * THREADS * R +
                            STACK_BYTES +
                            MAX_STAGES * STAGE_BYTES;
static_assert(MAX_SMEM <= 227 * 1024, "past a block's shared memory");
constexpr uint32_t ALL = (1u << R) - 1u;

// The plan's words (ops/scan_kernels.py `_Plan`): the header, PASS_W
// words a pass, a word a staged input (pair | kind << 12 | unit << 16),
// the ops: expr.cuh's encoding (op | arg << 8 | imm << 32), but for
// - OP_COL, whose word carries its slot: OP_COL | source << 8 | kind << 10
//   | ref << 16 | offset << 32; ref is pair | staged unit << 8 for a base
//   slot (unit NO_RAW: not staged), the stage, or the derive pass whose
//   tile it reads back;
// - a binary op fused with its right operand: FUSE_COL | op, with a
//   column's fields as OP_COL's, or FUSE_IMM | op with the constant in
//   imm; the compare code in bits 13-15.
constexpr int W_PASSES = 0, W_OPS = 1, W_NPASS = 2, W_MASK = 3, W_RAW = 4,
              W_NRAW = 5;
enum { SRC_BASE, SRC_STAGE, SRC_OUT };
constexpr int FUSE_COL = 0x40, FUSE_IMM = 0x60;
// a pass: mode | kind << 8 | (stage + 1) << 16; start | count << 32; the
// tile's and its validity's offsets in the call's buffer, in n_pad bytes
// (-1: not written)
constexpr int PASS_W = 4;
enum { MODE_MASK, MODE_DERIVE };

struct Args {
  const long long* words;
  uint8_t* buf;
  const uint8_t* rowmask;
  long long n, n_pad;
  int vec, raw_units, stack;  // stack: entries below the top
  const uint8_t* ptr[2 * MAX_INPUTS];
};
static_assert(sizeof(Args) <= 4096, "by-value arguments exceed 4 KiB");

// -- loads and stores of a thread's R rows ----------------------------------

// NB bytes (8 or a multiple of 16), aligned to min(NB, 16)
template <int NB>
__device__ __forceinline__ void load_vec(const uint8_t* p,
                                         uint32_t (&w)[NB / 4]) {
  if constexpr (NB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  }
}

template <int NB>
__device__ __forceinline__ void store_vec(uint8_t* p,
                                          const uint32_t (&w)[NB / 4]) {
  if constexpr (NB == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
}

// The R elements of W bytes at rows row0.. (cnt of them real; the rest 0)
// as u32, zero-extended.
template <int W>
__device__ __forceinline__ void load_elems(const uint8_t* base,
                                           long long row0, int cnt,
                                           bool vec, uint32_t (&v)[R]) {
  const uint8_t* p = base + row0 * W;
  if (vec && cnt == R) {
    uint32_t w[R * W / 4];
    load_vec<R * W>(p, w);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (W == 4)
        v[r] = w[r];
      else if constexpr (W == 2)
        v[r] = (w[r >> 1] >> (16 * (r & 1))) & 0xFFFFu;
      else
        v[r] = (w[r >> 2] >> (8 * (r & 3))) & 0xFFu;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t x = 0u;
    if (r < cnt) {
      if constexpr (W == 4)
        x = reinterpret_cast<const uint32_t*>(p)[r];
      else if constexpr (W == 2)
        x = reinterpret_cast<const uint16_t*>(p)[r];
      else
        x = p[r];
    }
    v[r] = x;
  }
}

// The low W bytes of each of the R values at rows row0.. (cnt of them);
// the call's buffer is 16-byte aligned, its sections too.
template <int W>
__device__ __forceinline__ void store_elems(uint8_t* base, long long row0,
                                            int cnt, const uint32_t (&v)[R]) {
  uint8_t* p = base + row0 * W;
  if (cnt == R) {
    uint32_t w[R * W / 4];
#pragma unroll
    for (int i = 0; i < R * W / 4; ++i) w[i] = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (W == 4)
        w[r] = v[r];
      else
        w[r >> 2] |= (v[r] & 0xFFu) << (8 * (r & 3));
    }
    store_vec<R * W>(p, w);
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < cnt) {
      if constexpr (W == 4)
        reinterpret_cast<uint32_t*>(p)[r] = v[r];
      else
        p[r] = static_cast<uint8_t>(v[r]);
    }
  }
}

// bit r: the bool byte of row row0 + r is set
__device__ __forceinline__ uint32_t load_bits(const uint8_t* base,
                                              long long row0, int cnt,
                                              bool vec) {
  uint32_t b[R];
  load_elems<1>(base, row0, cnt, vec, b);
  uint32_t m = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) m |= static_cast<uint32_t>(b[r] != 0u) << r;
  return m;
}

__device__ __forceinline__ void store_bits(uint8_t* base, long long row0,
                                           int cnt, uint32_t m) {
  uint32_t b[R];
#pragma unroll
  for (int r = 0; r < R; ++r) b[r] = (m >> r) & 1u;
  store_elems<1>(base, row0, cnt, b);
}

__device__ __forceinline__ uint32_t nonzero(const uint32_t (&v)[R]) {
  uint32_t m = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) m |= static_cast<uint32_t>(v[r] != 0u) << r;
  return m;
}

// One slot's decoded values (expr.cuh `load_col`, R rows) and valid bits.
__device__ __forceinline__ void load_slot(const uint8_t* data,
                                          const uint8_t* mask, int kind,
                                          uint32_t off, long long row0,
                                          int cnt, bool vec,
                                          uint32_t (&v)[R], uint32_t& ok) {
  ok = load_bits(mask, row0, cnt, vec);
  switch (kind) {
    case COL_I8:
      load_elems<1>(data, row0, cnt, vec, v);
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = static_cast<uint32_t>(static_cast<int32_t>(
            static_cast<int8_t>(static_cast<uint8_t>(v[r]))));
      break;
    case COL_U8:
      load_elems<1>(data, row0, cnt, vec, v);
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] += off;
      break;
    case COL_U16:
      load_elems<2>(data, row0, cnt, vec, v);
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] += off;
      break;
    default:  // COL_I32, COL_F32: the bits as they are
      load_elems<4>(data, row0, cnt, vec, v);
  }
}

// -- staging a group's inputs ------------------------------------------------

// cp.async of NB bytes (8 or a multiple of 16), both ends aligned to
// min(NB, 16)
template <int NB>
__device__ __forceinline__ void copy_async(uint8_t* dst, const uint8_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (NB < 16) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(NB)
                 : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       d + 16 * i),
                   "l"(src + 16 * i)
                   : "memory");
  }
}

__device__ __forceinline__ int width(int kind) {
  return kind == COL_I32 || kind == COL_F32 ? 4 : kind == COL_U16 ? 2 : 1;
}

// -- the interpreter over R rows ---------------------------------------------

// The top entry in registers (t, tok), the d - 1 entries below it in the
// thread's column of the block's stack in shared memory (entry j: R / 4
// 16-byte words, neighbouring threads on neighbouring words, and a valid
// word), addressed by the warp-uniform depth: a push stores the old top,
// a binary op loads its left operand, and no register moves otherwise.
struct Stack {
  uint32_t t[R];
  uint32_t tok;
  int d;
  uint4* sv;      // entry j, word q: sv[(j * R / 4 + q) * THREADS]
  uint32_t* so;   // entry j's valid bits: so[j * THREADS]
};

// Make room for a new top: the old one goes below.
__device__ __forceinline__ void push(Stack& k) {
  if (k.d >= 1) {
    uint4* v = k.sv + (k.d - 1) * (R / 4) * THREADS;
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      v[q * THREADS] = make_uint4(k.t[4 * q], k.t[4 * q + 1],
                                  k.t[4 * q + 2], k.t[4 * q + 3]);
    k.so[(k.d - 1) * THREADS] = k.tok;
  }
  ++k.d;
}

// Take the second entry off (a binary op's left operand).
__device__ __forceinline__ void pop_second(Stack& k, uint32_t (&x)[R],
                                           uint32_t& xok) {
  const uint4* v = k.sv + (k.d - 2) * (R / 4) * THREADS;
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const uint4 u = v[q * THREADS];
    x[4 * q] = u.x;
    x[4 * q + 1] = u.y;
    x[4 * q + 2] = u.z;
    x[4 * q + 3] = u.w;
  }
  xok = k.so[(k.d - 2) * THREADS];
  --k.d;
}

template <typename T>
__device__ __forceinline__ void compare_rows(const uint32_t (&x)[R],
                                             uint32_t (&t)[R], int code) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if constexpr (std::is_same<T, float>::value)
      t[r] = compare(__uint_as_float(x[r]), __uint_as_float(t[r]), code);
    else
      t[r] = compare(static_cast<int32_t>(x[r]), static_cast<int32_t>(t[r]),
                     code);
  }
}

struct Env {
  const Args* a;
  const long long* passes;
  const uint8_t* raw;     // the block's staged input bytes
  const uint32_t* stage;  // this thread's column of the stages
  long long row0;
  int cnt;
  bool staged;  // this group's inputs are in `raw`
};

// An OP_COL's values and valid bits for the thread's rows (its word w
// says where): from a stage, from the group's staged bytes, or from
// device memory.
__device__ __forceinline__ void push_col(const Env& e, long long w,
                                         uint32_t (&v)[R], uint32_t& ok) {
  const int src = static_cast<int>((w >> 8) & 0x3);
  const int kind = static_cast<int>((w >> 10) & 0x7);
  const int ref = static_cast<int>((w >> 16) & 0xFFFF);
  const int idx = ref & 0xFF, at = ref >> 8;
  const uint32_t off =
      static_cast<uint32_t>(static_cast<unsigned long long>(w) >> 32);
  if (src == SRC_STAGE) {
    const uint32_t* st = e.stage + ref * (R + 1) * THREADS;
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = st[r * THREADS];
    ok = st[R * THREADS];
  } else if (src == SRC_BASE && e.staged && at != NO_RAW) {
    const uint8_t* m = e.raw + at * THREADS * R;
    load_slot(m + THREADS * R + threadIdx.x * R * width(kind),
              m + threadIdx.x * R, kind, off, 0, R, true, v, ok);
  } else if (src == SRC_BASE) {
    load_slot(e.a->ptr[2 * idx], e.a->ptr[2 * idx + 1], kind, off, e.row0,
              e.cnt, e.a->vec, v, ok);
  } else {  // SRC_OUT: the tile pass ref wrote, read back
    const long long* pw = e.passes + PASS_W * ref;
    load_slot(e.a->buf + pw[2] * e.a->n_pad, e.a->buf + pw[3] * e.a->n_pad,
              kind, 0u, e.row0, e.cnt, true, v, ok);
  }
}

// t = x op t for the thread's rows (expr.cuh `eval_expr`'s binary ops;
// arg: the compare code).
__device__ __forceinline__ void binary(int op, int arg,
                                       const uint32_t (&x)[R], uint32_t xok,
                                       uint32_t (&t)[R], uint32_t& tok) {
  const uint32_t both = xok & tok;
  switch (op) {
    case OP_AND: {
      const uint32_t f = (xok & ~nonzero(x)) | (tok & ~nonzero(t));
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = ((f >> r) & 1u) ^ 1u;
      tok = f | both;
      return;
    }
    case OP_OR: {
      const uint32_t tr = (xok & nonzero(x)) | (tok & nonzero(t));
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = (tr >> r) & 1u;
      tok = tr | both;
      return;
    }
    case OP_GATE: {
      // x's value, valid only where the boolean t is TRUE (an aggregate's
      // FILTER clause)
      const uint32_t on = nonzero(t);
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = x[r];
      tok = both & on;
      return;
    }
    case OP_CMP_I:
      compare_rows<int32_t>(x, t, arg);
      break;
    case OP_CMP_F:
      compare_rows<float>(x, t, arg);
      break;
    case OP_ADD_I:  // wraps, as XLA's int32 does
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = x[r] + t[r];
      break;
    case OP_SUB_I:
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = x[r] - t[r];
      break;
    case OP_MUL_I:
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = x[r] * t[r];
      break;
    case OP_ADD_F:
#pragma unroll
      for (int r = 0; r < R; ++r)
        t[r] = __float_as_uint(
            __fadd_rn(__uint_as_float(x[r]), __uint_as_float(t[r])));
      break;
    case OP_SUB_F:
#pragma unroll
      for (int r = 0; r < R; ++r)
        t[r] = __float_as_uint(
            __fsub_rn(__uint_as_float(x[r]), __uint_as_float(t[r])));
      break;
    default:  // OP_MUL_F
#pragma unroll
      for (int r = 0; r < R; ++r)
        t[r] = __float_as_uint(
            __fmul_rn(__uint_as_float(x[r]), __uint_as_float(t[r])));
      break;
  }
  tok = both;
}

// One op for the thread's rows (expr.cuh `eval_expr`, op for op).
__device__ __forceinline__ void step(const Env& e, long long w, Stack& k) {
  const int op = static_cast<int>(w & 0xFF);
  const int arg = static_cast<int>((w >> 8) & 0xFFFFFF);
  const uint32_t imm =
      static_cast<uint32_t>(static_cast<unsigned long long>(w) >> 32);
  if (op >= FUSE_COL) {  // top = top op (a column or a constant)
    uint32_t y[R], yok;
    if (op >= FUSE_IMM) {
#pragma unroll
      for (int r = 0; r < R; ++r) y[r] = imm;
      yok = ALL;
    } else {
      push_col(e, w, y, yok);
    }
    binary(op & 0x1F, static_cast<int>((w >> 13) & 0x7), k.t, k.tok, y,
           yok);
#pragma unroll
    for (int r = 0; r < R; ++r) k.t[r] = y[r];
    k.tok = yok;
    return;
  }
  switch (op) {
    case OP_COL:
      push(k);
      push_col(e, w, k.t, k.tok);
      break;
    case OP_I32:
    case OP_F32:
      push(k);
#pragma unroll
      for (int r = 0; r < R; ++r) k.t[r] = imm;
      k.tok = ALL;
      break;
    case OP_NULL:
      push(k);
#pragma unroll
      for (int r = 0; r < R; ++r) k.t[r] = 0u;
      k.tok = 0u;
      break;
    case OP_I2F:
#pragma unroll
      for (int r = 0; r < R; ++r)
        k.t[r] = __float_as_uint(__int2float_rn(static_cast<int>(k.t[r])));
      break;
    case OP_F2I:
      // PG rounding, half away from zero; the convert saturates and
      // takes NaN to 0 (as XLA's does)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float f = __uint_as_float(k.t[r]);
        const float q = copysignf(floorf(__fadd_rn(fabsf(f), 0.5f)), f);
        k.t[r] = static_cast<uint32_t>(__float2int_rz(q));
      }
      break;
    case OP_TOBOOL_I:
#pragma unroll
      for (int r = 0; r < R; ++r) k.t[r] = k.t[r] != 0u;
      break;
    case OP_TOBOOL_F:
#pragma unroll
      for (int r = 0; r < R; ++r) k.t[r] = __uint_as_float(k.t[r]) != 0.0f;
      break;
    case OP_NOT:
#pragma unroll
      for (int r = 0; r < R; ++r) k.t[r] ^= 1u;
      break;
    case OP_IS_NULL:
#pragma unroll
      for (int r = 0; r < R; ++r) k.t[r] = ((k.tok >> r) & 1u) ^ 1u;
      k.tok = ALL;
      break;
    case OP_IS_NOT_NULL:
#pragma unroll
      for (int r = 0; r < R; ++r) k.t[r] = (k.tok >> r) & 1u;
      k.tok = ALL;
      break;
    case OP_WRAP8:
#pragma unroll
      for (int r = 0; r < R; ++r)
        k.t[r] = static_cast<uint32_t>(static_cast<int32_t>(
            static_cast<int8_t>(static_cast<uint8_t>(k.t[r] & 0xFFu))));
      break;
    case OP_SETV:
#pragma unroll
      for (int r = 0; r < R; ++r) k.t[r] = imm;
      break;
    case OP_SHRA:
#pragma unroll
      for (int r = 0; r < R; ++r)
        k.t[r] = static_cast<uint32_t>(static_cast<int32_t>(k.t[r]) >> imm);
      break;
    case OP_SHRL:
#pragma unroll
      for (int r = 0; r < R; ++r) k.t[r] >>= imm;
      break;
    case OP_ANDI:
#pragma unroll
      for (int r = 0; r < R; ++r) k.t[r] &= imm;
      break;
    case OP_NVL:  // the value, or imm where it is NULL; valid
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (!((k.tok >> r) & 1u)) k.t[r] = imm;
      k.tok = ALL;
      break;
    default: {  // binary ops: x below t
      uint32_t x[R], xok;
      pop_second(k, x, xok);
      binary(op, arg, x, xok, k.t, k.tok);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    scan_eval_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long* words = a.words;
  Env e;
  e.a = &a;
  e.passes = words + words[W_PASSES];
  const long long* raws = words + words[W_RAW];
  const int n_raw = static_cast<int>(words[W_NRAW]);
  const size_t raw_bytes = static_cast<size_t>(a.raw_units) * THREADS * R;
  uint8_t* stack = smem + BUFFERS * raw_bytes;
  uint4* stack_v = reinterpret_cast<uint4*>(stack) + threadIdx.x;
  uint32_t* stack_ok = reinterpret_cast<uint32_t*>(
                           stack + a.stack * THREADS * R * 4) +
                       threadIdx.x;
  uint32_t* my_stage =
      reinterpret_cast<uint32_t*>(stack + a.stack * STAGE_BYTES) +
      threadIdx.x;
  e.stage = my_stage;
  const long long* ops = words + words[W_OPS];
  const int n_pass = static_cast<int>(words[W_NPASS]);
  const long long mask_at = words[W_MASK];
  const long long n = a.n;
  const long long groups = (n + R - 1) / R;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  // Every staged input's bytes of group g in flight at once, into buffer
  // `half` (a group that is no whole aligned vector reads device memory
  // instead); one commit group each, so a wait for all but the newest
  // leaves the next group's copies in flight. The thread reads back only
  // its own bytes, so no barrier.
  auto stage_group = [&](long long g, int half) {
    const long long row0 = g * R;
    if (g < groups && a.vec && n - row0 >= R) {
      uint8_t* base = smem + half * raw_bytes;
      for (int j = 0; j < n_raw; ++j) {
        const long long rw = raws[j];
        const int idx = static_cast<int>(rw & 0xFFF);
        const int kind = static_cast<int>((rw >> 12) & 0xF);
        uint8_t* m = base + ((rw >> 16) & 0xFFF) * THREADS * R;
        copy_async<R>(m + threadIdx.x * R, a.ptr[2 * idx + 1] + row0);
        uint8_t* d = m + THREADS * R;
        const uint8_t* src = a.ptr[2 * idx];
        switch (width(kind)) {
          case 1:
            copy_async<R>(d + threadIdx.x * R, src + row0);
            break;
          case 2:
            copy_async<2 * R>(d + threadIdx.x * 2 * R, src + row0 * 2);
            break;
          default:
            copy_async<4 * R>(d + threadIdx.x * 4 * R, src + row0 * 4);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (n_raw) stage_group(g, 0);
  for (int half = 0; g < groups; g += stride, half ^= 1) {
    e.row0 = g * R;
    e.cnt = static_cast<int>(n - e.row0 < R ? n - e.row0 : R);
    e.staged = a.vec && e.cnt == R;
    e.raw = smem + half * raw_bytes;
    if (n_raw) stage_group(g + stride, half ^ 1);
    uint32_t m =
        mask_at >= 0 ? load_bits(a.rowmask, e.row0, e.cnt, a.vec) : 0u;
    if (n_raw) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    for (int p = 0; p < n_pass; ++p) {
      const long long* pw = e.passes + PASS_W * p;
      const long long head = pw[0];
      const int mode = static_cast<int>(head & 0xFF);
      if (mode == MODE_MASK && !m) break;  // the mask passes come last
      Stack k;
      k.d = 0;
      k.tok = 0u;
      k.sv = stack_v;
      k.so = stack_ok;
      const long long* prog = ops + (pw[1] & 0xFFFFFFFF);
      const int count = static_cast<int>(pw[1] >> 32);
      long long w = prog[0];
      for (int i = 0; i < count; ++i) {
        const long long next = i + 1 < count ? prog[i + 1] : 0;
        step(e, w, k);
        w = next;
      }
      if (mode == MODE_MASK) {
        m &= k.tok & nonzero(k.t);
        continue;
      }
      // derive: the value as its tile holds it (0 where invalid; an int8
      // tile's byte, sign-extended as a reader decodes it)
      const int kind = static_cast<int>((head >> 8) & 0xFF);
      const int stage = static_cast<int>((head >> 16) & 0xFFFF) - 1;
      uint32_t v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        uint32_t x = (k.tok >> r) & 1u ? k.t[r] : 0u;
        if (kind == COL_I8)
          x = static_cast<uint32_t>(static_cast<int32_t>(
              static_cast<int8_t>(static_cast<uint8_t>(x & 0xFFu))));
        v[r] = x;
      }
      if (stage >= 0) {
        uint32_t* st = my_stage + stage * (R + 1) * THREADS;
#pragma unroll
        for (int r = 0; r < R; ++r) st[r * THREADS] = v[r];
        st[R * THREADS] = k.tok;
      }
      if (pw[2] >= 0) {
        if (kind == COL_I8)
          store_elems<1>(a.buf + pw[2] * a.n_pad, e.row0, e.cnt, v);
        else
          store_elems<4>(a.buf + pw[2] * a.n_pad, e.row0, e.cnt, v);
        store_bits(a.buf + pw[3] * a.n_pad, e.row0, e.cnt, k.tok);
      }
    }
    if (mask_at >= 0) store_bits(a.buf + mask_at * a.n_pad, e.row0, e.cnt, m);
  }
}

// Blocks of a launch: the groups' blocks, at most what stays resident on
// the card (the occupancy calculator's blocks an SM at this shared
// memory, times the SMs), per device and KiB of shared memory.
cudaError_t grid_for(long long groups, size_t smem, unsigned& grid) {
  static int sms[16] = {0};
  static int per_sm[16][(MAX_SMEM >> 10) + 1] = {{0}};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  dev &= 15;
  if (!sms[dev]) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(scan_eval_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(MAX_SMEM));
    if (e != cudaSuccess) return e;
    sms[dev] = n > 0 ? n : 1;
  }
  int& b = per_sm[dev][smem >> 10];
  if (!b) {
    int got = 0;
    // at the top of the KiB: a block of any size in it fits
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &got, scan_eval_kernel, THREADS, ((smem >> 10) + 1) << 10);
    if (e != cudaSuccess) return e;
    b = got > 0 ? got : 1;
  }
  const long long want = (groups + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(b) * sms[dev];
  grid = static_cast<unsigned>(want < cap ? want : cap);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One prepare over n rows: words is the plan's words in device memory,
// ptrs the host's 2 * n_in input pointers (data, mask per input slot),
// buf the call's output buffer (every written tile, its validity and the
// row mask, at the offsets the words give, in units of n rounded up to
// 16). n_stages, raw_units and stack (the entries below a program's top
// the deepest one needs) size the block's shared memory (the words say
// what uses it). Refuses more than MAX_INPUTS inputs, MAX_STAGES stages,
// MAX_RAW_UNITS units or MAX_STACK - 1 entries.
int scan_eval(const void* words, const void* ptrs, int n_in,
              const void* rowmask, void* buf, long long n, int n_stages,
              int raw_units, int stack, void* stream) {
  if (n_in < 0 || n_in > MAX_INPUTS || n_stages < 0 ||
      n_stages > MAX_STAGES || raw_units < 0 ||
      raw_units > MAX_RAW_UNITS || stack < 0 || stack > MAX_STACK - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Args a;
  a.words = static_cast<const long long*>(words);
  a.buf = static_cast<uint8_t*>(buf);
  a.rowmask = static_cast<const uint8_t*>(rowmask);
  a.n = n;
  a.n_pad = (n + 15) / 16 * 16;
  a.raw_units = raw_units;
  a.stack = stack;
  const long long* p = static_cast<const long long*>(ptrs);
  bool vec = (reinterpret_cast<uintptr_t>(rowmask) & 15) == 0;
  for (int i = 0; i < 2 * MAX_INPUTS; ++i) {
    a.ptr[i] = i < 2 * n_in ? reinterpret_cast<const uint8_t*>(
                                  static_cast<uintptr_t>(p[i]))
                            : nullptr;
    if (i < 2 * n_in) vec = vec && (p[i] & 15) == 0;
  }
  a.vec = vec;
  const size_t smem = BUFFERS * static_cast<size_t>(raw_units) * THREADS * R +
                      static_cast<size_t>(stack) * STAGE_BYTES +
                      static_cast<size_t>(n_stages) * STAGE_BYTES;
  unsigned grid = 0;
  const cudaError_t e = grid_for((n + R - 1) / R, smem, grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_eval_kernel<<<grid, THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
