// The scan programs' split pass for Hopper (sm_90a), with a plain C
// interface.
//
// Built by ops/_build.py with nvcc into a shared library and loaded with
// ctypes; the entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The wrapper, the descriptor's header
// words and the plain PyTorch version live in ops/scan_kernels.py (keep
// the constants below in step with it).
//
// scan_eval
//    The reference has no kernel of its own here: XLA traces any
//    expression, however deep or wide, into the one program of K5/K6/K8
//    (serenedb_tpu/exec/device.py:60 `compile_expr`). The port's scan
//    kernels interpret programs on an 8-entry register stack over at most
//    16 input columns, so the planner (exec/device_split.py) splits a
//    statement past those caps across launches, and this kernel runs the
//    parts that feed the next launch. One call runs expr.cuh's
//    interpreter over rows [0, n) of up to 16 column tiles and writes one
//    of:
//    - MASK: the row mask ANDed with the conjunction of the predicate
//      programs, as a (R, 128) bool tile (a row survives where its
//      rowmask byte is set and every program is TRUE);
//    - DERIVE: one program's value as a column tile (int32, int8 or the
//      f32 bits) and its validity; the value of an invalid row is 0.
//      Later launches read it as an ordinary column slot, so it holds the
//      bits the in-kernel evaluation of the same sub-program gives.
//    One thread a row, grid-stride over at most MAX_GRID blocks (each
//    block copies the 3,840-byte descriptor, a kernel parameter, to its
//    shared memory once, so more blocks would read more descriptor than
//    column bytes).
//    Bound: bytes — each input tile and mask (and the row mask) read once,
//    the output tile(s) written once.

#include "expr.cuh"

namespace {

using namespace expr;

// scan_eval's header words (ops/scan_kernels.py); word 0 holds the column
// count and words 3 and 6 the predicate count and row mask (expr.cuh)
constexpr int H_MODE = 2, H_PROG = 4, H_PROG_N = 5, H_OUT = 7,
              H_OUT_MASK = 8, H_ROWS = 9, H_OUT_KIND = 10;
enum { MODE_MASK, MODE_DERIVE };
enum { OUT_I32, OUT_I8, OUT_F32 };

constexpr int THREADS = 256;
constexpr long long MAX_GRID = 1024;

__global__ void __launch_bounds__(THREADS)
    scan_eval_kernel(const __grid_constant__ Desc desc) {
  __shared__ long long d[DESC_WORDS];
  load_desc(desc.w, d);
  const long long n = d[H_ROWS];
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  uint8_t* out_mask = ptr<uint8_t>(d[H_OUT_MASK]);
  if (d[H_MODE] == MODE_MASK) {
    for (long long row = blockIdx.x * THREADS + threadIdx.x; row < n;
         row += step)
      out_mask[row] = row_mask(d, row, true) ? 1 : 0;
    return;
  }
  const int start = static_cast<int>(d[H_PROG]);
  const int count = static_cast<int>(d[H_PROG_N]);
  const int kind = static_cast<int>(d[H_OUT_KIND]);
  for (long long row = blockIdx.x * THREADS + threadIdx.x; row < n;
       row += step) {
    uint32_t v;
    bool ok;
    eval_expr(d, start, count, row, v, ok);
    if (!ok) v = 0u;
    if (kind == OUT_I8)
      ptr<int8_t>(d[H_OUT])[row] =
          static_cast<int8_t>(static_cast<uint8_t>(v & 0xFFu));
    else  // OUT_I32, OUT_F32: the 32-bit pattern as it is
      ptr<uint32_t>(d[H_OUT])[row] = v;
    out_mask[row] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// One pass over n rows: desc is the host's descriptor (DESC_WORDS int64
// words), passed by value.
int scan_eval(const void* desc, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long want = (n + THREADS - 1) / THREADS;
  scan_eval_kernel<<<static_cast<unsigned>(want < MAX_GRID ? want
                                                           : MAX_GRID),
                     THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const Desc*>(desc));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
