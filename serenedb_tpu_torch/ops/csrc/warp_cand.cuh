// Per-warp candidate tools for Hopper (sm_90a), shared by topn.cu
// (topn_scan's passes) and bm25.cu (topk_rows' pass 0 and TAKE).
//
// Both kernels select the k largest 64-bit keys (an order-preserving
// image above ~index) and keep, per warp, the keys at or above a
// threshold in the warp's part of a slab. These are the steps they share:
// ranking a lane's flagged keys among its warp's, appending flagged keys
// to a list, picking the bin that holds the k-th largest key from a
// histogram, and keeping a part's keys at or above a threshold.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage (an unnamed namespace), as select.cuh: each library
// that includes the header keeps its own copy.
namespace cand {
namespace {

typedef unsigned long long u64;

constexpr unsigned WARP_ALL = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Ranks of a lane's flagged keys among its warp's, lanes in order and
// each lane's N keys in order; returns the warp's count.
template <int N>
__device__ __forceinline__ unsigned warp_rank(const bool (&f)[N],
                                              unsigned (&rank)[N]) {
  const int lane = threadIdx.x & 31;
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) mine += f[j];
  unsigned incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(WARP_ALL, incl, o);
    if (lane >= o) incl += y;
  }
  unsigned r = incl - mine;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    rank[j] = r;
    r += f[j];
  }
  return __shfl_sync(WARP_ALL, incl, 31);
}

// Append each flagged lane's key to out at a slot taken from *count: one
// atomic for the warp. Every lane of the warp calls it.
__device__ __forceinline__ void append(bool f, u64 key, unsigned* count,
                                       u64* out) {
  const unsigned bal = __ballot_sync(WARP_ALL, f);
  if (!bal) return;
  const int leader = __ffs(bal) - 1;
  unsigned at = 0;
  if ((threadIdx.x & 31) == leader)
    at = atomicAdd(count, static_cast<unsigned>(__popc(bal)));
  at = __shfl_sync(WARP_ALL, at, leader);
  if (f) out[at + __popc(bal & lanes_below())] = key;
}

// The highest bin b of hist[0, 32 * PER) with sum(hist[b..]) >= rem (the
// bin of the rem-th largest key), and in `above` the keys of the bins
// above it. Lane l sums bins PER(31-l) .. PER(31-l)+PER-1, so lanes in
// order run from the top bins down. Every lane of the warp calls it and
// gets the same result; the histogram must be visible to every lane.
template <int PER>
__device__ __forceinline__ unsigned warp_pick(const unsigned* hist,
                                              unsigned rem,
                                              unsigned& above) {
  const int lane = threadIdx.x & 31;
  const int b0 = PER * (31 - lane);
  unsigned c = 0;
  for (int i = 0; i < PER; ++i) c += hist[b0 + i];
  unsigned incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(WARP_ALL, incl, o);
    if (lane >= o) incl += y;
  }
  const bool mine = incl - c < rem && rem <= incl;
  unsigned bin = 0, gt = 0;
  if (mine) {
    unsigned cum = incl - c;
    for (int i = PER - 1; i >= 0; --i) {
      const unsigned x = hist[b0 + i];
      if (cum + x >= rem) {
        bin = b0 + i;
        gt = cum;
        break;
      }
      cum += x;
    }
  }
  const int src = __ffs(__ballot_sync(WARP_ALL, mine)) - 1;
  above = __shfl_sync(WARP_ALL, gt, src);
  return __shfl_sync(WARP_ALL, bin, src);
}

// Keep a warp's cnt candidates that are at least thr, in place and in
// order (a candidate moves only down); returns their count. Four a lane
// in flight. Out of line: the scan loops that call it keep their
// registers.
__device__ __noinline__ unsigned warp_keep(u64* sub, unsigned cnt, u64 thr) {
  constexpr int C = 4;
  const int lane = threadIdx.x & 31;
  unsigned now = 0;
  for (unsigned c0 = 0; c0 < cnt; c0 += 32 * C) {
    u64 e[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const unsigned i = c0 + 32 * j + lane;
      e[j] = i < cnt ? sub[i] : 0ull;
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const bool stay = c0 + 32 * j + lane < cnt && e[j] >= thr;
      const unsigned bal = __ballot_sync(WARP_ALL, stay);
      if (stay) sub[now + __popc(bal & lanes_below())] = e[j];
      now += __popc(bal);
    }
  }
  __syncwarp();
  return now;
}

}  // namespace
}  // namespace cand
