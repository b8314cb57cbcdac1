// Device helpers shared by the PLOC kernels (ploc_nn.cu, ploc_round.cu,
// ploc_round_fused.cu, ploc_finish.cu).
//
// Cluster state is i32[8, *] lane-major: rows 0-5 the AABB (min xyz,
// -max xyz) as f32 bits, row 6 the Morton code (< 2^31), row 7 the node id.
// The arithmetic repeats the plain PyTorch versions in
// tpu_bvh_torch/ops/ploc_nn.py operation by operation (nvcc --fmad=false,
// and the _rn intrinsics say so again), so every output is bit-exact.

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace ploc {

constexpr float kBig = 3.0e38f;  // "no candidate" area
constexpr int kMaxR = 8;         // largest search radius: PLOC_RADIUS (types.py)

using tbvh::jmin;  // jnp.minimum's rule (common.cuh)

// surface area of the union of two packed boxes, in the order of
// tpu_bvh/ops/ploc.py:_area6: ex = -u3 - u0, ..., 2 * ((ex*ey + ex*ez) + ey*ez)
__device__ __forceinline__ float union_area(const float* a, const float* b) {
  float u[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) u[k] = jmin(a[k], b[k]);
  const float ex = __fsub_rn(-u[3], u[0]);
  const float ey = __fsub_rn(-u[4], u[1]);
  const float ez = __fsub_rn(-u[5], u[2]);
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(ex, ey), __fmul_rn(ex, ez)), __fmul_rn(ey, ez));
  return __fmul_rn(2.0f, s);
}

// HPLOC segment id: the code's prefix above `shift` bits; one segment at 32
__device__ __forceinline__ unsigned seg_of(int code, int shift) {
  return shift >= 32 ? 0u : ((unsigned)code >> shift);
}

// Nearest neighbour of lane l among the live lanes [0, nc) within +-R in
// the same segment: the lexicographic minimum of (union area, neighbour
// index), found in the order of the TPU kernel (ploc_nn.py:_nn_body):
// forward offsets 1..R with strict <, then backward offsets 1..R, where a
// tie goes to the smaller index. `box(j, k)` gives row k of lane j as a
// float, `seg(j)` its segment. Returns best_rel (the chosen offset, 0 if
// none), and sets fwd_rel (the best forward offset, 0 if none) and has_nn.
template <class Box, class Seg>
__device__ __forceinline__ int nearest(int l, int nc, int R, Box box, Seg seg, int* fwd_rel,
                                       bool* has_nn) {
  float own[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) own[k] = box(l, k);
  const unsigned sg = seg(l);
  const bool valid = l >= 0 && l < nc;
  float best = kBig;
  int rel = 0;
  for (int d = 1; d <= R; ++d) {
    const int j = l + d;
    float a = kBig;
    if (valid && j < nc && seg(j) == sg) {
      float nb[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) nb[k] = box(j, k);
      a = union_area(own, nb);
    }
    if (a < best) {
      best = a;
      rel = d;
    }
  }
  *fwd_rel = rel;
  for (int d = 1; d <= R; ++d) {
    const int j = l - d;
    float a = kBig;
    if (j >= 0 && l < nc && seg(j) == sg) {  // the pair (j, l) seen from j
      float nb[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) nb[k] = box(j, k);
      a = union_area(nb, own);
    }
    if (a < best || (a == best && -d < rel)) {
      best = a;
      rel = -d;
    }
  }
  *has_nn = best < kBig;
  return rel;
}

// Exclusive scan over the threads of a block of NT threads (NT a multiple
// of 32, at most 1024); `warp_sums` is NT / 32 ints of shared memory.
// Returns this thread's exclusive prefix and sets *total. Every thread of
// the block must call it.
template <int NT>
__device__ __forceinline__ int block_excl_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NT / 32) warp_sums[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[NT / 32 - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return before + x - v;
}

// Decoupled look-back over the blocks of a single-pass scan of two counts
// (merges, keeps) a block, shared by ploc_round_fused.cu (B6/B8) and
// ploc_round.cu (B9). A block's status is two 64-bit words, each
// (epoch << 34 | flag << 32 | count); the epoch is the wrapper's count of
// launches (30 bits, never 0), so a word of an earlier launch, or of the
// other kernel, never reads as current and no memset clears them.
constexpr unsigned kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ unsigned long long status_word(unsigned epoch, unsigned flag,
                                                          int count) {
  return ((unsigned long long)epoch << 34) | ((unsigned long long)flag << 32) | (unsigned)count;
}

__device__ __forceinline__ void publish(unsigned long long* status, int b, unsigned epoch,
                                        unsigned flag, int merges, int keeps) {
  volatile unsigned long long* st = status;
  st[2 * b] = status_word(epoch, flag, merges);
  __threadfence();  // the keep word never shows a flag before the merge word
  st[2 * b + 1] = status_word(epoch, flag, keeps);
}

// Run by all 32 lanes of warp 0 of block b, whose index came from a ticket
// in scan order (so every predecessor is running): publishes the block's
// aggregate, walks back over its predecessors' words 32 at a time, summing
// aggregates until it meets an inclusive prefix, and publishes its own
// inclusive prefix. Returns the exclusive prefixes in *pm, *pk on every
// lane.
__device__ __forceinline__ void look_back(unsigned long long* status, int b, unsigned epoch,
                                          int agg_m, int agg_k, int* pm, int* pk) {
  const int lane = threadIdx.x & 31;
  int em = 0, ek = 0;
  if (b == 0) {
    if (lane == 0) publish(status, 0, epoch, kInclusive, agg_m, agg_k);
  } else {
    if (lane == 0) publish(status, b, epoch, kAggregate, agg_m, agg_k);
    const volatile unsigned long long* st = status;
    for (int j = b - 1;; j -= 32) {
      const int p = j - lane;  // lane 0 is the nearest predecessor
      unsigned long long wm = 0, wk = 0;
      bool ready;
      do {
        if (p >= 0) {
          wm = st[2 * p];
          wk = st[2 * p + 1];
        }
        ready = p < 0 || ((wm >> 32) == (wk >> 32) && (unsigned)(wm >> 34) == epoch &&
                          ((wm >> 32) & 3) != 0);
      } while (!__all_sync(0xffffffffu, ready));
      const bool inc = p >= 0 && ((wm >> 32) & 3) == kInclusive;
      const unsigned incs = __ballot_sync(0xffffffffu, inc);
      const int stop = incs ? __ffs(incs) - 1 : 31;  // the nearest inclusive prefix
      int cm = (p >= 0 && lane <= stop) ? (int)(unsigned)wm : 0;
      int ck = (p >= 0 && lane <= stop) ? (int)(unsigned)wk : 0;
      for (int o = 16; o > 0; o >>= 1) {
        cm += __shfl_xor_sync(0xffffffffu, cm, o);
        ck += __shfl_xor_sync(0xffffffffu, ck, o);
      }
      em += cm;
      ek += ck;
      if (incs) break;  // block 0 is inclusive, so the walk ends
    }
    if (lane == 0) publish(status, b, epoch, kInclusive, em + agg_m, ek + agg_k);
  }
  *pm = em;
  *pk = ek;
}

}  // namespace ploc
