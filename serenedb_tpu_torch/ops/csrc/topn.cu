// Top-N kernels for Hopper (sm_90a), with a plain C interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; each entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrappers and the plain PyTorch
// versions live in ops/topn_kernels.py; `topn_bytes` / `chain_bytes` give
// the one buffer a call writes (its outputs first, then its scratch), and
// the call sets every word of it that it reads: the wrapper allocates it
// unset.
//
// Both entries select by a unique 64-bit key: the high word is the
// order-preserving u32 image h of the row's (transformed) sort value, the
// low word ~index. Descending key order is then (value desc, index asc),
// which is `lax.top_k`'s order: the lowest index first on ties.
//
// 1. topn_scan
//    Replaces serenedb_tpu/exec/device_topn.py `_topn_indices` (the
//    `prog` at :202, K6) and the filtered program of
//    exec/device_pipeline.py `_run_fused_topn` (:2582, K7): per row the
//    frame-of-reference decode of the key and predicate columns, the
//    predicate programs (expr.cuh, shared with agg_scan) ANDed with the
//    row mask, the key transform of device_topn.py:170-181 (desc v, asc
//    ~v for ints, -v for f32; masked rows take the sentinel, int32 min or
//    -inf, whose image is the least of all), then the selection. -0.0 is
//    made +0.0 before the image, so the two tie as the host path's sort
//    ties them. Also counts the rows that survive the mask.
//    The selection finds the k-th largest image T and r, the rows equal
//    to T still to take; the result is every row above T and the first r
//    rows equal to T by index. No key array is written. Five launches,
//    each a pass over the same blocks (block b owns rows [b·RPB,
//    (b+1)·RPB) and a slab of candidates, a part a warp); the last block
//    of each pass (an atomic ticket) decides the next:
//    - init: the control words and the histogram;
//    - pass 0, the one read of the input on q1-like data: the survivor
//      count, the least and greatest survivor image, a 2,048-bin
//      histogram of bits 31-21 and, per block, the survivors and the rows
//      at the sentinel. Each warp also keeps every survivor at or above
//      its own threshold, which it raises, when its part fills, to the
//      floor of the bin holding its k-th largest image: never above T, so
//      the candidates hold every row at or above T. A lane takes four
//      consecutive rows, each column one vector load; a compare of a
//      column with a literal (or an AND chain of them) is evaluated
//      without the interpreter. No barrier in the loop. Fewer survivors
//      than k, or one value for all, fix T here;
//    - two HIST steps, bits 20-10 and 9-0 of the bucket (the bin of bits
//      31-21 that holds the k-th largest, or the one bin every survivor
//      shares): the candidates in the bucket stay (in place), their next
//      digit is histogrammed, the rows above the bucket go to the
//      selection. Where a warp gave up (its part full of ties), a step
//      reads the input instead; so the worst case reads the input once a
//      pass and still writes no key;
//    - TAKE, one 1,024-thread block an SM: from the candidates, every row
//      above T and every row equal to it, all sorted in the last block
//      (select.cuh's bitonic sort in shared memory, at most SORT_CAP
//      keys) and the best k written; where the rows equal to T are too
//      many to sort, or T is the sentinel, from the input: each block's
//      quota of them (the final digit's histogram is kept per block, a
//      prefix over blocks gives the quotas), taken in index order.
//    Bound: bytes, one read of the input; the interpreter and the
//    histogram's shared atomics cost instructions on top.
// 2. chain_topn
//    Replaces the stage-2 program of exec/device_pipeline.py
//    `try_device_chained_topn` (:2810, K7): the sort value of each group
//    slot — a resident count column, or the slot's group-key digit
//    (slot / stride) % size — transformed to v or ~v, absent slots (row
//    count 0) set to int32 min; the selection of k_pad slots; then each
//    stage-1 output's k_pad picked rows gathered into the call's buffer,
//    so the host reads only those. Up to a cap of slots (CHAIN_ONE_MAX
//    of the wrapper, set from card timings; at most ONE_LIMIT) it is one
//    block in one launch: the images in shared memory, a histogram level
//    for each digit the present slots do not all share, the same quota
//    rule, the sort, and the gather of every output (pointers and row
//    widths in the by-value parameter). Above the cap the slots are the
//    front end of topn_scan's passes, and one launch gathers every
//    output.
//    Bound: bytes (the row counts, the sort column, the picked rows), but
//    at the main path's 10,001 slots a call is its launch.

#include "expr.cuh"
#include "select.cuh"
#include "warp_cand.cuh"

namespace {

using namespace expr;
using cand::append;
using cand::lanes_below;
using cand::warp_keep;
using cand::warp_pick;
using cand::warp_rank;

typedef unsigned long long u64;

// topn_scan's header words (ops/topn_kernels.py)
constexpr int H_KEYSLOT = 11, H_FLAGS = 12;
constexpr int F_DESC = 1, F_FLOAT = 2;

constexpr int THREADS = 256, WARPS = THREADS / 32;
// consecutive rows a lane takes per tile (one vector load a column); a
// block's tile is TILE rows
constexpr int R = 4, TILE = THREADS * R;
constexpr int BINS = 2048;                 // an 11-bit digit
constexpr int SHIFT1 = 21, SHIFT2 = 10;    // digits: 31-21, 20-10, 9-0
constexpr int FINAL_BINS = 1 << SHIFT2;    // the last digit's bins
constexpr long long MAX_BLOCKS = 132 * 8;
constexpr long long SLAB_DIV = 16, MIN_SLAB = 1024;
constexpr int MAX_K = 8192;
// keys TAKE may sort: the rows above T and every row equal to it
constexpr int SORT_CAP = 16384;
constexpr int HIST8 = 256;  // a warp's histogram when it raises its threshold
constexpr int ONE_THREADS = 1024;
constexpr long long ONE_LIMIT = 32768;     // slots the one-block path holds
constexpr int MAX_OUT = 64;
constexpr uint32_t ALL = 0xFFFFFFFFu;

// control words (u32): the survivor count is a u64 in words 0-1
enum : int {
  C_NSURV = 0, C_LO = 2, C_HI = 3, C_TICKET = 4, C_MODE = 5, C_SRC = 6,
  C_SHIFT = 7, C_PREFIX = 8, C_PREV = 9, C_KREM = 10, C_NSEL = 11,
  C_OVER = 12, C_HIST = 16, CTL_WORDS = C_HIST + BINS
};
enum : unsigned { M_HIST, M_TAKE, M_DONE };
enum : unsigned { SRC_INPUT, SRC_CAND };
// per-block words: survivors, rows at the sentinel, quota, then each
// warp's count of candidates in its part of the block's slab
enum : int { B_SURV, B_EQS, B_QUOTA, B_CAND, BLK_W = B_CAND + WARPS };

// One call's scratch, carved from the wrapper's buffer, and its sizes.
struct Work {
  unsigned* ctl;        // CTL_WORDS
  unsigned* blk;        // nblk x BLK_W
  unsigned* bhist;      // nblk x FINAL_BINS
  u64* cand;            // nblk x slab
  u64* sel;             // SORT_CAP
  long long* out_idx;   // k
  long long* out_count; // 1
  long long n, rpb, slab;
  int k, nblk;
  uint32_t sent;        // the sentinel's image
};

struct Plan {
  long long rpb, nblk, slab, bytes;
};

long long round_up(long long a, long long b) { return (a + b - 1) / b * b; }

Plan plan_for(long long n, long long k) {
  Plan p;
  p.rpb = round_up((n + MAX_BLOCKS - 1) / MAX_BLOCKS, TILE);
  p.nblk = (n + p.rpb - 1) / p.rpb;
  const long long want = p.rpb / SLAB_DIV;
  p.slab = p.rpb < MIN_SLAB ? p.rpb : (want > MIN_SLAB ? want : MIN_SLAB);
  // out_idx, out_count, sel, cand (8-byte words), then ctl, blk, bhist;
  // a warp's part of a block's slab is slab / WARPS
  p.bytes = 8 * (k + 1 + SORT_CAP + p.nblk * p.slab) +
            4 * (CTL_WORDS + p.nblk * BLK_W + p.nblk * FINAL_BINS);
  return p;
}

Work carve(void* buf, long long n, long long k, const Plan& p,
           uint32_t sent) {
  Work w;
  w.out_idx = static_cast<long long*>(buf);
  w.out_count = w.out_idx + k;
  w.sel = reinterpret_cast<u64*>(w.out_count + 1);
  w.cand = w.sel + SORT_CAP;
  w.ctl = reinterpret_cast<unsigned*>(w.cand + p.nblk * p.slab);
  w.blk = w.ctl + CTL_WORDS;
  w.bhist = w.blk + p.nblk * BLK_W;
  w.n = n;
  w.rpb = p.rpb;
  w.slab = p.slab;
  w.k = static_cast<int>(k);
  w.nblk = static_cast<int>(p.nblk);
  w.sent = sent;
  return w;
}

// ------------------------------------------------------------ front ends

constexpr int MAX_PREDS = (D_AGGS - D_PREDS) / PRED_W;
constexpr int MAX_ATOMS = 16, ATOMS_AHEAD = 2;

// The R decoded values of input slot c (its descriptor words) at rows
// row..row+R-1 (row a multiple of R; the columns are (rows, 128) tiles),
// in one vector load, through the read-only path (the scan never writes
// its inputs).
__device__ __forceinline__ void load_data4(const long long* c, long long row,
                                           uint32_t (&v)[R]) {
  static_assert(R == 4, "one vector load holds four rows");
  const uint32_t off = static_cast<uint32_t>(c[3]);
  switch (static_cast<int>(c[2])) {
    case COL_I8: {
      const uint32_t x = __ldg(ptr<const uint32_t>(c[0]) + (row >> 2));
#pragma unroll
      for (int j = 0; j < R; ++j)
        v[j] = static_cast<uint32_t>(
            static_cast<int32_t>(static_cast<int8_t>(x >> (8 * j))));
      break;
    }
    case COL_U8: {
      const uint32_t x = __ldg(ptr<const uint32_t>(c[0]) + (row >> 2));
#pragma unroll
      for (int j = 0; j < R; ++j) v[j] = ((x >> (8 * j)) & 0xFFu) + off;
      break;
    }
    case COL_U16: {
      const uint2 x = __ldg(ptr<const uint2>(c[0]) + (row >> 2));
      v[0] = (x.x & 0xFFFFu) + off;
      v[1] = (x.x >> 16) + off;
      v[2] = (x.y & 0xFFFFu) + off;
      v[3] = (x.y >> 16) + off;
      break;
    }
    default: {  // COL_I32, COL_F32: the bits as they are
      const uint4 x = __ldg(ptr<const uint4>(c[0]) + (row >> 2));
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    }
  }
}

// The R bytes of a mask (row validity, a column's) at rows row..row+R-1.
__device__ __forceinline__ uint32_t load_mask4(long long mask, long long row) {
  return __ldg(ptr<const uint32_t>(mask) + (row >> 2));
}

// Predicate program p is TRUE at `row`: the interpreter, kept out of line
// so the unrolled row loops hold one copy of it.
__device__ __noinline__ bool pred_true(const long long* d, int p,
                                       long long row) {
  uint32_t v;
  bool ok;
  eval_expr(d, static_cast<int>(d[D_PREDS + PRED_W * p]),
            static_cast<int>(d[D_PREDS + PRED_W * p + 1]), row, v, ok);
  return ok && v != 0u;
}

// The rows of a scan: the row mask, the predicates, the key's image.
// A lane takes R consecutive rows; their row-mask bytes, key values and
// the compares' columns come in one vector load each, all issued before
// any is used. A predicate that is a compare of a column with a literal,
// or an AND chain of such compares (what compile_expr emits for `c1 = 1
// AND c2 < 50`), is TRUE exactly where every compare's column is valid
// and the compare holds, so it runs as those compares ("atoms"); any
// other program goes to the interpreter. A row that fails takes the
// sentinel.
struct ScanFront {
  Desc desc;
  struct Shared {
    long long d[DESC_WORDS];
    int n_atoms, n_progs;
    int a_slot[MAX_ATOMS], a_code[MAX_ATOMS], a_float[MAX_ATOMS];
    uint32_t a_imm[MAX_ATOMS];
    int progs[MAX_PREDS];
  };
  __device__ void load(Shared& s) const {
    load_desc(desc.w, s.d);
    if (threadIdx.x == 0) {
      const long long* d = s.d;
      int na = 0, np = 0;
      for (int p = 0; p < static_cast<int>(d[H_NPREDS]); ++p) {
        const long long* o = d + D_OPS + d[D_PREDS + PRED_W * p];
        const int len = static_cast<int>(d[D_PREDS + PRED_W * p + 1]);
        const auto op = [o](int i) { return static_cast<int>(o[i] & 0xFF); };
        const auto atom = [&](int i) {  // ops i..i+2: column CMP literal
          return op(i) == OP_COL &&
                 ((op(i + 1) == OP_I32 && op(i + 2) == OP_CMP_I) ||
                  (op(i + 1) == OP_F32 && op(i + 2) == OP_CMP_F));
        };
        bool chain = len >= 3 && (len - 3) % 4 == 0 && atom(0) &&
                     na + 1 + (len - 3) / 4 <= MAX_ATOMS;
        for (int i = 3; chain && i < len; i += 4)
          chain = atom(i) && op(i + 3) == OP_AND;
        if (!chain) {
          s.progs[np++] = p;
          continue;
        }
        for (int i = 0; i < len; i += i == 0 ? 3 : 4) {
          s.a_slot[na] = static_cast<int>((o[i] >> 8) & 0xFFFFFF);
          s.a_imm[na] = static_cast<uint32_t>(static_cast<u64>(o[i + 1]) >> 32);
          s.a_code[na] = static_cast<int>((o[i + 2] >> 8) & 0xFFFFFF);
          s.a_float[na] = op(i + 2) == OP_CMP_F;
          ++na;
        }
      }
      s.n_atoms = na;
      s.n_progs = np;
    }
    __syncthreads();
  }
  // m[j] &= compare a holds at row j (its column valid there)
  __device__ static void atom_and(const Shared& s, int a,
                                  const uint32_t (&v)[R], uint32_t ok,
                                  bool (&m)[R]) {
    const uint32_t imm = s.a_imm[a];
    const int code = s.a_code[a];
#pragma unroll
    for (int j = 0; j < R; ++j)
      m[j] = m[j] && ((ok >> (8 * j)) & 0xFFu) &&
             (s.a_float[a] ? compare(__uint_as_float(v[j]),
                                     __uint_as_float(imm), code)
                           : compare(static_cast<int32_t>(v[j]),
                                     static_cast<int32_t>(imm), code));
  }
  template <int N>
  __device__ void rows(const Shared& s, long long row0, long long r1,
                       uint32_t sent, uint32_t (&h)[N], bool (&m)[N]) const {
    static_assert(N == R, "a lane's rows are one vector load");
    const long long* d = s.d;
    const int flags = static_cast<int>(d[H_FLAGS]);
    const bool in = row0 < r1;  // r1 and row0 are multiples of R
    uint32_t raw[R] = {0u, 0u, 0u, 0u};
    uint32_t rm = 0u;
    if (in) {
      rm = load_mask4(d[H_ROWMASK], row0);
      load_data4(d + D_COLS + COL_W * d[H_KEYSLOT], row0, raw);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) m[j] = (rm >> (8 * j)) & 0xFFu;
    // the first ATOMS_AHEAD compares' loads all go out before any is used
    uint32_t av[ATOMS_AHEAD][R], aok[ATOMS_AHEAD];
#pragma unroll
    for (int a = 0; a < ATOMS_AHEAD; ++a) {
      aok[a] = 0u;
      if (in && a < s.n_atoms) {
        const long long* c = d + D_COLS + COL_W * s.a_slot[a];
        load_data4(c, row0, av[a]);
        aok[a] = load_mask4(c[1], row0);
      }
    }
#pragma unroll
    for (int a = 0; a < ATOMS_AHEAD; ++a)
      if (a < s.n_atoms) atom_and(s, a, av[a], aok[a], m);
    for (int a = ATOMS_AHEAD; in && a < s.n_atoms; ++a) {
      const long long* c = d + D_COLS + COL_W * s.a_slot[a];
      uint32_t v[R];
      load_data4(c, row0, v);
      atom_and(s, a, v, load_mask4(c[1], row0), m);
    }
    for (int q = 0; in && q < s.n_progs; ++q)
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (m[j]) m[j] = pred_true(d, s.progs[q], row0 + j);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      uint32_t img;
      if (flags & F_FLOAT) {
        uint32_t kv = (flags & F_DESC) ? raw[j] : (raw[j] ^ 0x80000000u);
        if (kv == 0x80000000u) kv = 0u;  // -0.0 ties +0.0
        img = image(kv);
      } else {
        const int32_t iv = static_cast<int32_t>(raw[j]);
        img = static_cast<uint32_t>((flags & F_DESC) ? iv : ~iv) ^
              0x80000000u;
      }
      h[j] = m[j] ? img : sent;
    }
  }
};

// The group slots of chain_topn: present where the row count is positive
// (the loads of a lane's R slots issued together).
struct ChainFront {
  const long long* rowcount;
  const long long* src;
  long long stride, size;
  int desc;
  struct Shared {
    int unused;
  };
  __device__ void load(Shared&) const {}
  template <int N>
  __device__ void rows(const Shared&, long long row0, long long r1,
                       uint32_t sent, uint32_t (&h)[N], bool (&m)[N]) const {
    long long rc[N], sv[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long long s = row0 + j;
      rc[j] = s < r1 ? rowcount[s] : 0;
      sv[j] = s < r1 && src != nullptr ? src[s] : 0;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long long s = row0 + j;
      const int32_t v = src != nullptr
                            ? static_cast<int32_t>(sv[j])
                            : static_cast<int32_t>((s / stride) % size);
      m[j] = rc[j] > 0;
      h[j] = m[j] ? static_cast<uint32_t>(desc ? v : ~v) ^ 0x80000000u
                  : sent;
    }
  }
};

// ------------------------------------------------------------ block tools

__device__ __forceinline__ u64 make_key(uint32_t h, long long index) {
  return (static_cast<u64>(h) << 32) |
         static_cast<u64>(~static_cast<uint32_t>(index));
}

// Add `weight` rows to each lane's bin (weight 0: nothing): one shared
// atomic for the warp where its weighted lanes share a bin, else one a
// lane. Every lane of the warp calls it.
__device__ __forceinline__ void warp_hist(unsigned* s_hist, unsigned weight,
                                          unsigned bin) {
  const bool active = weight != 0u;
  const unsigned bal = __ballot_sync(FULL, active);
  if (!bal) return;
  const unsigned lo = __reduce_min_sync(FULL, active ? bin : ALL);
  const unsigned hi = __reduce_max_sync(FULL, active ? bin : 0u);
  if (lo == hi) {
    const unsigned sum = __reduce_add_sync(FULL, weight);
    if ((threadIdx.x & 31) == __ffs(bal) - 1) atomicAdd(&s_hist[bin], sum);
  } else if (active) {
    atomicAdd(&s_hist[bin], weight);
  }
}

// Count a lane's N rows (those flagged) into their bins, (h >> shift) &
// mask: where every
// lane's flagged rows share one bin (narrow or skewed keys), as one
// weighted warp_hist; else one shared atomic a row. Every lane of the
// warp calls it.
template <int N>
__device__ __forceinline__ void lane_hist(unsigned* s_hist,
                                          const bool (&f)[N],
                                          const uint32_t (&h)[N], int shift,
                                          unsigned mask) {
  unsigned first = 0, count = 0;
  bool one = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (!f[j]) continue;
    const unsigned bin = (h[j] >> shift) & mask;
    if (count == 0) first = bin;
    one = one && bin == first;
    ++count;
  }
  if (__all_sync(FULL, one)) {
    warp_hist(s_hist, count, first);
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (f[j]) atomicAdd(&s_hist[(h[j] >> shift) & mask], 1u);
}

// Inclusive sum of v over the block in thread order, and the block total.
// Every thread calls it; s_w holds 33 words and is free again on return.
__device__ unsigned block_scan(unsigned v, unsigned& total, unsigned* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_w[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const unsigned t = lane < nw ? s_w[lane] : 0u;
    unsigned u = t;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, u, o);
      if (lane >= o) u += y;
    }
    if (lane < nw) s_w[lane] = u - t;  // exclusive
    if (lane == 31) s_w[32] = u;
  }
  __syncthreads();
  const unsigned r = s_w[warp] + x;
  total = s_w[32];
  __syncthreads();
  return r;
}

// The ranks, in row order, of the flagged rows of a tile (warp w's lane
// l holds rows N·(32·w + l) + j) and their count, with one barrier: the
// warps' counts go to one of two halves of s_w (by `parity`, which the
// caller alternates), so the next tile need not wait for this one's
// readers. s_w holds 2 x 32 words.
template <int N>
__device__ __forceinline__ void tile_rank(const bool (&f)[N],
                                          unsigned (&rank)[N],
                                          unsigned& total, unsigned* s_w,
                                          int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned* c = s_w + 32 * parity;
  parity ^= 1;
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) mine += f[j];
  unsigned incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) c[warp] = incl;
  __syncthreads();
  unsigned before = 0, all = 0;
  for (int w = 0; w < nw; ++w) {
    const unsigned x = c[w];
    before += w < warp ? x : 0u;
    all += x;
  }
  total = all;
  unsigned r = before + incl - mine;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    rank[j] = r;
    r += f[j];
  }
}

template <bool GLOBAL>
__device__ __forceinline__ unsigned ld(const unsigned* p) {
  if constexpr (GLOBAL) return __ldcg(p);
  return *p;
}

// The highest bin b of hist[0, nbins) with sum(hist[b..]) >= k_rem (the
// bin of the k_rem-th largest); k_rem becomes k_rem - sum(hist[b+1..]).
// Every thread calls it and gets the same result; nbins is a multiple of
// the block size.
template <bool GLOBAL>
__device__ unsigned pick_bin(const unsigned* hist, int nbins,
                             unsigned& k_rem, unsigned* s_w) {
  __shared__ unsigned s_pick[2];
  const int per = nbins / blockDim.x;
  // thread t scans chunk u = nthreads-1-t, so the exclusive scan in thread
  // order is the count above chunk u
  const int u = blockDim.x - 1 - threadIdx.x;
  unsigned c = 0;
  for (int i = 0; i < per; ++i) c += ld<GLOBAL>(hist + u * per + i);
  unsigned total;
  const unsigned above = block_scan(c, total, s_w) - c;
  if (above < k_rem && k_rem <= above + c) {
    unsigned cum = above;
    for (int i = per - 1; i >= 0; --i) {
      const unsigned x = ld<GLOBAL>(hist + u * per + i);
      if (cum + x >= k_rem) {
        s_pick[0] = u * per + i;
        s_pick[1] = k_rem - cum;
        break;
      }
      cum += x;
    }
  }
  __syncthreads();
  const unsigned bin = s_pick[0];
  k_rem = s_pick[1];
  __syncthreads();
  return bin;
}

// Each block's quota of the rows equal to T, in block order: block b
// takes min(eq_b, max(0, r - sum(eq[0..b)))), eq_b = eq[b * stride].
// The last block of a pass calls it with every thread.
__device__ void set_quotas(const Work& w, const unsigned* eq, int stride,
                           unsigned r, unsigned* s_w) {
  unsigned carry = 0;
  for (int b0 = 0; b0 < w.nblk; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const unsigned e =
        b < w.nblk ? __ldcg(eq + static_cast<long long>(b) * stride) : 0u;
    unsigned total;
    const unsigned pre = carry + block_scan(e, total, s_w) - e;
    if (b < w.nblk)
      w.blk[b * BLK_W + B_QUOTA] = pre >= r ? 0u : min(e, r - pre);
    carry += total;
  }
}

// The last block of a pass to finish: true in every thread of it. Every
// thread calls it after its block's writes.
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// ---------------------------------------------------------------- passes

__global__ void init_kernel(unsigned* ctl) {
  for (int i = threadIdx.x; i < CTL_WORDS; i += blockDim.x)
    ctl[i] = i == C_LO ? ALL : 0u;
}

// A threshold for a warp's cnt >= k candidates that at least k of them
// reach: the floor of the 8-bit bin, below the bits they all share, that
// holds their k-th largest image. Two reads of the candidates, eight a
// lane in flight. Out of line: the scan loops keep their registers.
__device__ __noinline__ uint32_t warp_floor(const u64* sub, unsigned cnt,
                                            unsigned k, unsigned* hist) {
  constexpr int C = 8;
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the warp's candidate writes are visible to all its lanes
  unsigned lo = ALL, hi = 0;
  for (unsigned c0 = 0; c0 < cnt; c0 += 32 * C) {
    uint32_t e[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const unsigned i = c0 + 32 * j + lane;
      e[j] = i < cnt ? static_cast<uint32_t>(sub[i] >> 32) : 0u;
    }
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (c0 + 32 * j + lane < cnt) {
        lo = min(lo, e[j]);
        hi = max(hi, e[j]);
      }
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  const int top = lo == hi ? 0 : 32 - __clz(lo ^ hi);  // bits [0, top) vary
  const int sh = top > 8 ? top - 8 : 0;
  for (int i = lane; i < HIST8; i += 32) hist[i] = 0;
  __syncwarp();
  for (unsigned c0 = 0; c0 < cnt; c0 += 32 * C) {
    uint32_t e[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const unsigned i = c0 + 32 * j + lane;
      e[j] = i < cnt ? static_cast<uint32_t>(sub[i] >> 32) : 0u;
    }
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (c0 + 32 * j + lane < cnt) atomicAdd(&hist[(e[j] >> sh) & 0xFFu], 1u);
  }
  __syncwarp();
  unsigned above;
  const unsigned bin = warp_pick<8>(hist, k, above);
  const uint32_t high = sh + 8 >= 32 ? 0u : (lo >> (sh + 8)) << (sh + 8);
  __syncwarp();
  return high | (bin << sh);
}

// A warp's state of pass 0's candidates, in shared memory so the scan
// loop holds none of it: count, threshold, count that triggers a raise,
// and whether the warp gave up.
struct KeepState {
  unsigned cnt, thr, cap, over;
};

// Append the warp's rows of this tile whose flag bit is set (bit j of a
// lane's `flags`: its row first + j, image h[j]) to the warp's part of
// the slab, first raising the threshold where they would not fit. Out of
// line and rare: the scan loop calls it only where some row passes.
__device__ __noinline__ void keep_tile(KeepState* st, u64* sub,
                                       unsigned sub_n, unsigned k,
                                       unsigned* hist, long long first,
                                       uint32_t h0, uint32_t h1, uint32_t h2,
                                       uint32_t h3, unsigned flags) {
  const uint32_t h[R] = {h0, h1, h2, h3};
  bool keep[R];
  unsigned rank[R];
#pragma unroll
  for (int j = 0; j < R; ++j) keep[j] = (flags >> j) & 1u;
  unsigned cnt = st->cnt, total = warp_rank(keep, rank);
  if (cnt + total > st->cap) {
    if (cnt >= k) {
      const uint32_t thr = max(st->thr, warp_floor(sub, cnt, k, hist));
      cnt = warp_keep(sub, cnt, static_cast<u64>(thr) << 32);
#pragma unroll
      for (int j = 0; j < R; ++j) keep[j] = keep[j] && h[j] >= thr;
      total = warp_rank(keep, rank);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) {
        st->thr = thr;
        // ties can hold cnt up: the next raise waits until it doubles
        st->cap = min(sub_n, max(st->cap, 2 * cnt + 32 * R));
      }
    }
    if (cnt + total > sub_n) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) st->over = 1u;
      __syncwarp();
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (keep[j]) sub[cnt + rank[j]] = make_key(h[j], first + j);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) st->cnt = cnt + total;
  __syncwarp();
}

// Pass 0 over the input: the survivor count, the least and greatest
// survivor image, the histogram of bits 31-21 and, per block, the
// survivors and the rows at the sentinel. Each warp also keeps in its
// part of the block's slab every survivor whose image is at least its
// threshold (in no particular order); when the part holds `cap`, the
// threshold rises to the floor of the bin holding the k-th largest image
// there (never above T, the global k-th largest: the warp alone holds k
// rows at or above it) and the part keeps the rows at or above it. Where
// that frees no room (ties, or k near the part's size), the warp stops
// keeping, and the first step reads the input. No barrier in the loop.
// Four blocks an SM (64 registers a thread) keep enough loads in flight.
template <class F>
__global__ void __launch_bounds__(THREADS, 4)
    pass0_kernel(const __grid_constant__ F f, const __grid_constant__ Work w) {
  __shared__ typename F::Shared sh;
  __shared__ unsigned s_h[BINS];
  __shared__ unsigned s_k[WARPS][HIST8];
  __shared__ KeepState s_keep[WARPS];
  __shared__ unsigned s_scan[33];
  __shared__ unsigned s_red[4][WARPS];
  for (int i = threadIdx.x; i < BINS; i += THREADS) s_h[i] = 0;
  f.load(sh);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * w.rpb;
  const long long r1 = min(r0 + w.rpb, w.n);
  const unsigned sub_n = static_cast<unsigned>(w.slab / WARPS);
  u64* sub = w.cand + blockIdx.x * w.slab + warp * sub_n;
  const unsigned k = static_cast<unsigned>(w.k);
  // a warp raises its threshold when it holds cap candidates: few, so a
  // raise reads little, but room for k and a tile more
  KeepState* st = s_keep + warp;
  if (lane == 0) {
    // a warp raises its threshold when it holds cap candidates: few, so a
    // raise reads little, but room for k and a tile more
    st->cnt = st->thr = st->over = 0u;
    st->cap = min(sub_n, max(256u, 2 * k + 32 * R));
  }
  __syncwarp();
  unsigned surv = 0, eqs = 0, lo = ALL, hi = 0;
  for (long long base = r0 + warp * 32 * R; base < r1; base += TILE) {
    const long long first = base + R * lane;
    uint32_t h[R];
    bool m[R];
    f.template rows<R>(sh, first, r1, w.sent, h, m);
    const uint32_t thr = st->thr;
    unsigned flags = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (m[j]) {
        ++surv;
        lo = min(lo, h[j]);
        hi = max(hi, h[j]);
      }
      eqs += first + j < r1 && h[j] == w.sent;
      flags |= static_cast<unsigned>(m[j] && h[j] >= thr) << j;
    }
    lane_hist(s_h, m, h, SHIFT1, BINS - 1);
    if (__any_sync(FULL, flags != 0u) && !st->over)
      keep_tile(st, sub, sub_n, k, s_k[warp], first, h[0], h[1], h[2], h[3],
                flags);
  }
  surv = __reduce_add_sync(FULL, surv);
  eqs = __reduce_add_sync(FULL, eqs);
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (lane == 0) {
    s_red[0][warp] = surv;
    s_red[1][warp] = eqs;
    s_red[2][warp] = lo;
    s_red[3][warp] = hi;
    w.blk[blockIdx.x * BLK_W + B_CAND + warp] = st->over ? 0u : st->cnt;
    if (st->over) atomicOr(w.ctl + C_OVER, 1u);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < WARPS; ++i) {
      surv += s_red[0][i];
      eqs += s_red[1][i];
      lo = min(lo, s_red[2][i]);
      hi = max(hi, s_red[3][i]);
    }
    w.blk[blockIdx.x * BLK_W + B_SURV] = surv;
    w.blk[blockIdx.x * BLK_W + B_EQS] = eqs;
    if (surv) {
      atomicAdd(reinterpret_cast<u64*>(w.ctl + C_NSURV), u64{surv});
      atomicMin(w.ctl + C_LO, lo);
      atomicMax(w.ctl + C_HI, hi);
    }
  }
  for (int i = threadIdx.x; i < BINS; i += THREADS)
    if (s_h[i]) atomicAdd(w.ctl + C_HIST + i, s_h[i]);
  if (!last_block(w.ctl + C_TICKET)) return;

  // the first decision
  unsigned* ctl = w.ctl;
  const u64 S = __ldcg(reinterpret_cast<const u64*>(ctl + C_NSURV));
  const unsigned glo = __ldcg(ctl + C_LO), ghi = __ldcg(ctl + C_HI);
  if (S < k || glo == ghi) {
    // T is the sentinel (every row above it is taken) or the one value
    // of all survivors; TAKE reads the input
    unsigned above = 0, T = glo;
    const unsigned* eq = w.blk + B_SURV;
    if (S < k || glo == w.sent) {
      T = w.sent;
      eq = w.blk + B_EQS;
    }
    if (S < k) {
      unsigned at_sent = 0, total;
      for (int b0 = 0; b0 < w.nblk; b0 += THREADS) {
        const int b = b0 + threadIdx.x;
        const unsigned e = b < w.nblk ? __ldcg(eq + b * BLK_W) : 0u;
        block_scan(e, total, s_scan);
        at_sent += total;
      }
      above = static_cast<unsigned>(w.n) - at_sent;
    }
    set_quotas(w, eq, BLK_W, k - above, s_scan);
    if (threadIdx.x == 0) {
      ctl[C_MODE] = M_TAKE;
      ctl[C_SRC] = SRC_INPUT;
      ctl[C_PREFIX] = T;
      ctl[C_PREV] = ALL;
    }
  } else {
    // the first bucket: the bin of bits 31-21 that holds the k-th largest,
    // or, where every survivor shares those bits (q1's x: [0, 100,000)),
    // that one bin without a pick
    unsigned k_rem = k;
    const unsigned prefix =
        __clz(glo ^ ghi) < 32 - SHIFT1
            ? pick_bin<true>(ctl + C_HIST, BINS, k_rem, s_scan)
            : glo >> SHIFT1;
    const unsigned shift = SHIFT1;
    if (threadIdx.x == 0) {
      ctl[C_MODE] = M_HIST;
      ctl[C_SRC] = __ldcg(ctl + C_OVER) ? SRC_INPUT : SRC_CAND;
      ctl[C_SHIFT] = shift;
      ctl[C_PREFIX] = prefix;
      ctl[C_PREV] = ALL;
      ctl[C_KREM] = k_rem;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BINS; i += THREADS) ctl[C_HIST + i] = 0;
  if (threadIdx.x == 0) {
    ctl[C_OVER] = 0;
    ctl[C_TICKET] = 0;
  }
}

// A step of the selection. HIST (two launches, bits 20-10 then 9-0):
// the rows of the bucket [blo, bhi] stay
// candidates (in place in each warp's part, or from the input into it)
// and their next digit is histogrammed; rows above the bucket go to the
// selection. TAKE (1,024 threads a block): from the candidates, every row
// above T and every row equal to T, then the last block sorts them all
// (at most SORT_CAP keys, in dynamic shared memory) and writes the best
// k; from the input, the rows above T and each block's quota of the rows
// equal to it, tile by tile in index order. No barrier inside the loop
// but TAKE's ordered ranks.
template <class F, bool TAKE>
__global__ void __launch_bounds__(TAKE ? ONE_THREADS : THREADS, TAKE ? 1 : 4)
    step_kernel(const __grid_constant__ F f, const __grid_constant__ Work w) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ typename F::Shared sh;
  __shared__ unsigned s_hist[TAKE ? 1 : BINS];
  __shared__ unsigned s_w[64], s_scan[33];
  unsigned* ctl = w.ctl;
  if (__ldcg(ctl + C_MODE) != (TAKE ? M_TAKE : M_HIST)) return;
  const bool from_cand = __ldcg(ctl + C_SRC) == SRC_CAND;
  const unsigned shift = __ldcg(ctl + C_SHIFT);
  const unsigned prefix = __ldcg(ctl + C_PREFIX);
  const unsigned prev = __ldcg(ctl + C_PREV);
  const int nth = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // HIST: the bucket and its next digit (at nshift, nbits); TAKE: T
  const unsigned nshift = shift == SHIFT1 ? SHIFT2 : 0u;
  const unsigned nbits = shift - nshift;
  const unsigned blo = TAKE ? prefix : prefix << shift;
  const unsigned bhi = TAKE ? prefix : blo | ((1u << shift) - 1u);
  const bool last_digit = !TAKE && nshift == 0;
  if (!TAKE)
    for (int i = threadIdx.x; i < (1 << nbits); i += nth) s_hist[i] = 0;
  if (!from_cand) f.load(sh);
  __syncthreads();

  const unsigned sub_n = static_cast<unsigned>(w.slab / WARPS);
  // HIST: block b is the slab and input rows of block b; TAKE (one block
  // an SM) takes blocks b, b + grid, ... in turn
  int parity = 0;  // tile_rank's halves alternate across blocks too
  for (int b = blockIdx.x; b < w.nblk; b += gridDim.x) {
    u64* slab = w.cand + b * w.slab;
    if (from_cand) {
      // warp v of the block's parts, taken by warp v % (warps here)
      for (int v = warp; v < WARPS; v += nth / 32) {
        u64* sub = slab + v * sub_n;
        const unsigned cnt = __ldcg(w.blk + b * BLK_W + B_CAND + v);
        unsigned now = 0;
        for (unsigned i0 = 0; i0 < cnt; i0 += 32) {
          const unsigned i = i0 + lane;
          const u64 key = i < cnt ? sub[i] : 0ull;
          const uint32_t h = static_cast<uint32_t>(key >> 32);
          const bool above = i < cnt && h > bhi && h <= prev;
          const bool inb = i < cnt && h >= blo && h <= bhi;
          append(above || (TAKE && inb), key, ctl + C_NSEL, w.sel);
          if (TAKE) continue;
          // in place: a candidate moves only down
          const unsigned bal = __ballot_sync(FULL, inb);
          if (inb) sub[now + __popc(bal & lanes_below())] = key;
          now += __popc(bal);
          warp_hist(s_hist, inb ? 1u : 0u,
                    (h >> nshift) & ((1u << nbits) - 1u));
          __syncwarp();
        }
        if (!TAKE && lane == 0) w.blk[b * BLK_W + B_CAND + v] = now;
      }
    } else {
      const long long r0 = static_cast<long long>(b) * w.rpb;
      const long long r1 = min(r0 + w.rpb, w.n);
      const unsigned quota = TAKE ? __ldcg(w.blk + b * BLK_W + B_QUOTA) : 0u;
      u64* sub = slab + warp * sub_n;
      unsigned cnt = 0, seen = 0;
      bool over = false;
      for (long long base = r0; base < r1; base += nth * R) {
        // TAKE's quota needs index order, so its loop stays block-wide
        // with a barrier a tile; HIST's warps run on their own
        if (!TAKE && base + warp * 32 * R >= r1) break;
        const long long first = base + warp * 32 * R + R * lane;
        uint32_t h[R];
        bool m[R];
        f.template rows<R>(sh, first, r1, w.sent, h, m);
        bool above[R], inb[R];
  #pragma unroll
        for (int j = 0; j < R; ++j) {
          const bool in = first + j < r1;
          above[j] = in && h[j] > bhi && h[j] <= prev;
          inb[j] = in && h[j] >= blo && h[j] <= bhi;
        }
        if (TAKE) {
          unsigned rank[R], total;
          tile_rank(inb, rank, total, s_w, parity);
  #pragma unroll
          for (int j = 0; j < R; ++j)
            append(above[j] || (inb[j] && seen + rank[j] < quota),
                   make_key(h[j], first + j), ctl + C_NSEL, w.sel);
          seen += total;
          continue;
        }
        unsigned rank[R];
        const unsigned total = warp_rank(inb, rank);
        const bool room = !over && cnt + total <= sub_n;
  #pragma unroll
        for (int j = 0; j < R; ++j) {
          const u64 key = make_key(h[j], first + j);
          append(above[j], key, ctl + C_NSEL, w.sel);
          if (room && inb[j]) sub[cnt + rank[j]] = key;
        }
        lane_hist(s_hist, inb, h, nshift, (1u << nbits) - 1u);
        if (room)
          cnt += total;
        else
          over = true;
      }
      if (!TAKE && lane == 0) {
        w.blk[b * BLK_W + B_CAND + warp] = over ? 0u : cnt;
        if (over) atomicOr(ctl + C_OVER, 1u);
      }
    }
  }
  __syncthreads();
  if (!TAKE) {
    if (last_digit)
      for (int i = threadIdx.x; i < FINAL_BINS; i += nth)
        w.bhist[static_cast<long long>(blockIdx.x) * FINAL_BINS + i] =
            s_hist[i];
    for (int i = threadIdx.x; i < (1 << nbits); i += nth)
      if (s_hist[i]) atomicAdd(ctl + C_HIST + i, s_hist[i]);
  }
  if (!last_block(ctl + C_TICKET)) return;

  if (!TAKE) {
    unsigned k_rem = __ldcg(ctl + C_KREM);
    const unsigned d = pick_bin<true>(ctl + C_HIST, 1 << nbits, k_rem, s_scan);
    const unsigned T = (prefix << nbits) | d;
    bool input = __ldcg(ctl + C_OVER) != 0;
    if (last_digit) {
      // TAKE sorts the rows at or above T where they fit; else (ties) it
      // takes quotas from the input, as it does for a sentinel T (the
      // candidates hold survivors only)
      const unsigned e = __ldcg(ctl + C_HIST + d);
      const unsigned need = static_cast<unsigned>(w.k) - k_rem + e;
      const bool sent_t = T == w.sent && from_cand;
      if (sent_t || input || need > SORT_CAP) {
        input = true;
        if (sent_t)
          set_quotas(w, w.blk + B_EQS, BLK_W, k_rem, s_scan);
        else
          set_quotas(w, w.bhist + d, FINAL_BINS, k_rem, s_scan);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (1 << nbits); i += nth) ctl[C_HIST + i] = 0;
    if (threadIdx.x == 0) {
      ctl[C_MODE] = last_digit ? M_TAKE : M_HIST;
      ctl[C_SRC] = input ? SRC_INPUT : SRC_CAND;
      ctl[C_SHIFT] = nshift;
      ctl[C_PREFIX] = T;
      ctl[C_PREV] = bhi;
      ctl[C_KREM] = k_rem;
      ctl[C_OVER] = 0;
      ctl[C_TICKET] = 0;
    }
    return;
  }
  // TAKE: sort what was taken (exactly k keys from the input; from the
  // candidates, every row at or above T) and write the best k
  const unsigned count = __ldcg(ctl + C_NSEL);
  int npow2 = 1;
  while (npow2 < static_cast<int>(count)) npow2 <<= 1;
  u64* s_keys = reinterpret_cast<u64*>(dyn);
  for (int i = threadIdx.x; i < npow2; i += nth)
    s_keys[i] = i < static_cast<int>(count) ? ~__ldcg(w.sel + i)
                                            : sel::NO_KEY;
  __syncthreads();
  sel::block_sort(s_keys, npow2);
  for (int i = threadIdx.x; i < w.k; i += nth)
    w.out_idx[i] = static_cast<long long>(
        static_cast<uint32_t>(s_keys[i] & 0xFFFFFFFFull));
  if (threadIdx.x == 0) {
    *w.out_count = static_cast<long long>(
        __ldcg(reinterpret_cast<const u64*>(ctl + C_NSURV)));
    ctl[C_MODE] = M_DONE;
    ctl[C_TICKET] = 0;
  }
}

// ----------------------------------------------------------- chain_topn

// chain_topn's by-value parameter: the slots, k, and every stage-1
// output to gather (row_words 4-byte words a slot; its picked words start
// at word out_off[j] of the gather's flat index space).
struct ChainArgs {
  ChainFront f;
  long long G;
  int k, n_out;
  long long* out_idx;
  long long* out_count;
  const uint32_t* src_rows[MAX_OUT];
  uint32_t* dst_rows[MAX_OUT];
  long long row_words[MAX_OUT];
  long long out_off[MAX_OUT + 1];
};

// Every output's picked rows, as one flat range of words (so the loads of
// all outputs are in flight together): word q of output j is word q % rw
// of slot idx(q / rw)'s row.
template <class Idx>
__device__ void gather(const ChainArgs& a, Idx idx, long long first,
                       long long step) {
  int j = 0;
  for (long long e = first; e < a.out_off[a.n_out]; e += step) {
    while (e >= a.out_off[j + 1]) ++j;
    const long long rw = a.row_words[j], q = e - a.out_off[j];
    const long long i = q / rw, c = q - i * rw;
    a.dst_rows[j][q] = a.src_rows[j][idx(i) * rw + c];
  }
}

// The whole of chain_topn for G <= ONE_LIMIT slots, in one block. Dynamic
// shared memory: the sort's keys (8 x npow2(k)), then one u32 image a
// slot.
__global__ void __launch_bounds__(ONE_THREADS)
    chain_one_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ unsigned s_hist[BINS];
  __shared__ unsigned s_w[64], s_scan[33];
  __shared__ unsigned s_n[2];  // present slots, keys taken
  int npow2 = 1;
  while (npow2 < a.k) npow2 <<= 1;
  u64* s_keys = reinterpret_cast<u64*>(dyn);
  uint32_t* s_h = reinterpret_cast<uint32_t*>(s_keys + npow2);
  const int G = static_cast<int>(a.G), tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  ChainFront::Shared none;

  // the images (absent: int32 min's, 0), eight slots a lane in flight
  constexpr int N = 8;
  unsigned pres = 0, lo = ALL, hi = 0;
  for (int base = warp * 32 * N; base < G; base += ONE_THREADS * N) {
    const int first = base + N * lane;
    uint32_t h[N];
    bool m[N];
    a.f.rows<N>(none, first, G, 0u, h, m);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (first + j < G) s_h[first + j] = h[j];
      pres += m[j];
      if (m[j]) {
        lo = min(lo, h[j]);
        hi = max(hi, h[j]);
      }
    }
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (lane == 0) {
    s_w[warp] = lo;
    s_w[32 + warp] = hi;
  }
  unsigned total;
  block_scan(pres, total, s_scan);  // its barriers also publish s_w
  lo = ALL;
  hi = 0;
  for (int v = 0; v < ONE_THREADS / 32; ++v) {
    lo = min(lo, s_w[v]);
    hi = max(hi, s_w[32 + v]);
  }
  if (tid == 0) {
    s_n[0] = total;
    s_n[1] = 0;
  }
  __syncthreads();
  // with k present slots or more, T lies in [lo, hi] of the present
  // images: a digit they all share needs no histogram
  const bool narrow = total >= static_cast<unsigned>(a.k);

  // T, the k-th largest image, in three digits; r = k_rem
  unsigned prefix = 0, k_rem = static_cast<unsigned>(a.k);
  const int shifts[3] = {SHIFT1, SHIFT2, 0};
  int top = 32;
#pragma unroll
  for (int lv = 0; lv < 3; ++lv) {
    const int sh = shifts[lv], nb = top - sh;
    if (narrow && (lo >> sh) == (hi >> sh)) {
      prefix = (prefix << nb) | ((lo >> sh) & ((1u << nb) - 1u));
      top = sh;
      continue;
    }
    for (int i = tid; i < BINS; i += ONE_THREADS) s_hist[i] = 0;
    __syncthreads();
    for (int base = warp * 32; base < G; base += ONE_THREADS) {
      const int s = base + lane;
      const uint32_t h = s < G ? s_h[s] : 0u;
      const bool match = s < G && (top == 32 || (h >> top) == prefix);
      warp_hist(s_hist, match ? 1u : 0u, (h >> sh) & ((1u << nb) - 1u));
    }
    __syncthreads();
    prefix = (prefix << nb) | pick_bin<false>(s_hist, BINS, k_rem, s_scan);
    top = sh;
  }
  const uint32_t T = prefix;

  // every slot above T and the first k_rem equal to it, by index (a
  // lane's N consecutive slots a tile)
  unsigned seen = 0;
  int parity = 0;
  for (int base = 0; base < G; base += ONE_THREADS * N) {
    const int first = base + N * tid;
    uint32_t h[N];
    bool eq[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      h[j] = first + j < G ? s_h[first + j] : 0u;
      eq[j] = first + j < G && h[j] == T;
    }
    unsigned rank[N];
    tile_rank(eq, rank, total, s_w, parity);
#pragma unroll
    for (int j = 0; j < N; ++j)
      if ((first + j < G && h[j] > T) || (eq[j] && seen + rank[j] < k_rem))
        s_keys[atomicAdd(&s_n[1], 1u)] = ~make_key(h[j], first + j);
    seen += total;
  }
  __syncthreads();
  for (int i = a.k + tid; i < npow2; i += ONE_THREADS)
    s_keys[i] = sel::NO_KEY;
  __syncthreads();
  sel::block_sort(s_keys, npow2);
  for (int i = tid; i < a.k; i += ONE_THREADS)
    a.out_idx[i] = static_cast<long long>(
        static_cast<uint32_t>(s_keys[i] & 0xFFFFFFFFull));
  if (tid == 0) *a.out_count = s_n[0];
  gather(
      a,
      [&](long long i) {
        return static_cast<long long>(
            static_cast<uint32_t>(s_keys[i] & 0xFFFFFFFFull));
      },
      tid, ONE_THREADS);
}

// Above the cap: every output's picked rows, after the selection wrote
// out_idx.
__global__ void chain_gather_kernel(const __grid_constant__ ChainArgs a) {
  const long long* out = a.out_idx;
  gather(
      a, [out](long long i) { return out[i]; },
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
      static_cast<long long>(gridDim.x) * blockDim.x);
}

int npow2_of(long long k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

size_t one_smem(long long G, long long k) {
  return static_cast<size_t>(8 * npow2_of(k) + 4 * G);
}

// The five launches of the selection.
template <class F>
void select_passes(const F& f, const Work& w, const Plan& p,
                   cudaStream_t s) {
  const unsigned nb = static_cast<unsigned>(p.nblk);
  const size_t smem = SORT_CAP * sizeof(u64);
  init_kernel<<<1, 1024, 0, s>>>(w.ctl);
  pass0_kernel<F><<<nb, THREADS, 0, s>>>(f, w);
  step_kernel<F, false><<<nb, THREADS, 0, s>>>(f, w);
  step_kernel<F, false><<<nb, THREADS, 0, s>>>(f, w);
  step_kernel<F, true><<<nb < 132 ? nb : 132, ONE_THREADS, smem, s>>>(f, w);
}

}  // namespace

extern "C" {

// Opt the kernels into the shared memory they may use; the loader calls
// it once, when it loads the library.
int topn_load() {
  const int sort = SORT_CAP * static_cast<int>(sizeof(u64));
  cudaError_t e = cudaFuncSetAttribute(
      step_kernel<ScanFront, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, sort);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(step_kernel<ChainFront, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sort);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(chain_one_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(one_smem(ONE_LIMIT, MAX_K)));
  return static_cast<int>(e);
}

// Bytes of topn_scan's buffer for n rows and k: out_idx (k int64) at 0,
// the survivor count (int64) at 8k, then the scratch.
long long topn_bytes(long long n, long long k) { return plan_for(n, k).bytes; }

// topn_scan: the descriptor (DESC_WORDS int64 words on the host, passed
// by value) names the columns, predicates, key slot and flags; `n` rows,
// 1 <= k <= min(n, 8192), n < 2^32 - 1. Writes the k selected row
// indices, best first, and the survivor count to buf (topn_bytes(n, k)
// bytes).
int topn_scan(const void* desc, long long n, long long k, void* buf,
              long long buf_bytes, void* stream) {
  const Plan p = plan_for(n, k);
  if (k < 1 || k > MAX_K || k > n || buf_bytes < p.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  ScanFront f;
  f.desc = *static_cast<const Desc*>(desc);
  const bool is_float = f.desc.w[H_FLAGS] & F_FLOAT;
  // the sentinel's image: -inf, or int32 min
  const Work w = carve(buf, n, k, p, is_float ? IMG_NEG_INF : 0u);
  select_passes(f, w, p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of chain_topn's buffer before the picked rows: out_idx (k int64)
// at 0, the present count (int64) at 8k, then (above the cap) the
// selection's scratch.
long long chain_bytes(long long G, long long k, long long one_max) {
  if (G <= one_max && G <= ONE_LIMIT) return 8 * (k + 1);
  return plan_for(G, k).bytes;
}

// chain_topn: select k of the G group slots (sort value from `src`, an
// int64 count column, or from the slot's key digit when src is null),
// then gather the picked rows of n_out <= 64 stage-1 outputs: output j
// is src_ptrs[j] with row_words[j] 4-byte words a slot, written to
// dst_ptrs[j] (k rows); they travel in the kernel's parameter. buf holds
// chain_bytes(G, k, one_max) bytes. The arguments come packed in one
// host array of int64 words (one foreign call, few conversions):
// rowcount, src, G, stride, size, desc, k, buf, buf_bytes, n_out,
// one_max, then src_ptrs, row_words and dst_ptrs (n_out words each).
int chain_topn(const long long* args, void* stream) {
  const void* rowcount = reinterpret_cast<const void*>(args[0]);
  const void* src = reinterpret_cast<const void*>(args[1]);
  const long long G = args[2], stride = args[3], size = args[4];
  const int desc = static_cast<int>(args[5]);
  const long long k = args[6];
  void* buf = reinterpret_cast<void*>(args[7]);
  const long long buf_bytes = args[8];
  const int n_out = static_cast<int>(args[9]);
  const long long one_max = args[10];
  const long long* src_ptrs = args + 11;
  const long long* row_words = src_ptrs + n_out;
  const long long* dst_ptrs = row_words + n_out;
  if (k < 1 || k > MAX_K || k > G || n_out < 0 || n_out > MAX_OUT ||
      buf_bytes < chain_bytes(G, k, one_max))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ChainArgs a;
  a.f.rowcount = static_cast<const long long*>(rowcount);
  a.f.src = static_cast<const long long*>(src);
  a.f.stride = stride;
  a.f.size = size;
  a.f.desc = desc;
  a.G = G;
  a.k = static_cast<int>(k);
  a.n_out = n_out;
  a.out_idx = static_cast<long long*>(buf);
  a.out_count = a.out_idx + k;
  a.out_off[0] = 0;
  for (int j = 0; j < MAX_OUT; ++j) {
    const bool on = j < n_out;
    a.src_rows[j] = on ? reinterpret_cast<const uint32_t*>(
                             static_cast<uintptr_t>(src_ptrs[j]))
                       : nullptr;
    a.dst_rows[j] = on ? reinterpret_cast<uint32_t*>(
                             static_cast<uintptr_t>(dst_ptrs[j]))
                       : nullptr;
    a.row_words[j] = on ? row_words[j] : 0;
    a.out_off[j + 1] = a.out_off[j] + k * a.row_words[j];
  }
  if (G <= one_max && G <= ONE_LIMIT) {
    chain_one_kernel<<<1, ONE_THREADS, one_smem(G, k), s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const Plan p = plan_for(G, k);
  select_passes(a.f, carve(buf, G, k, p, 0u), p, s);
  if (n_out > 0) {
    long long blocks = (a.out_off[n_out] + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    chain_gather_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
