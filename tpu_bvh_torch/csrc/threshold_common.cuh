// The three-phase threshold scan of child_scan.cu (B15). B12-B14 and B1
// run the one-launch strict scan of psv_scan.cuh instead.
//
// Input: deltas d i32[m] with values in [0, 63]. For every row i and the
// query lane q = d[i] it finds
//   psv(i) = the last row j < i with hit(d[j], q), as 64 j + d[j] (-1 if none)
//   nsv(i) = the first row j > i with hit(d[j], q), as 64 j + d[j] (INT_MAX if none)
// where hit is d[j] < q (strict, the TPU kernels' mask) or d[j] <= q. The
// packed key grows with j, so "last" is a max and "first" a min, as in
// tpu_bvh/ops/pallas/threshold_core.py.
//
// The TPU carried a [V] row of running maxima from one grid step to the
// next in VMEM; Hopper's blocks run in no order, so the carry becomes a
// pass of its own:
//   1. thr_aggregate: per 1024-row block and threshold v, the last and
//      first row with hit(d, v). Each warp takes one __ballot_sync per
//      threshold (64 masks, lane t keeps those of v = t and t + 32), the
//      highest / lowest set bit gives the warp's answer, and 64 threads
//      combine the 32 warps from shared memory.
//   2. thr_carry (one block): per threshold, the exclusive max over the
//      blocks before and the exclusive min over the blocks after, in place.
//   3. thr_apply: the masks again; a row's answer is the nearest set bit
//      of its own lane's mask below / above it in the warp, else the
//      exclusive scan over the block's earlier / later warps, which starts
//      from the block's carry.
// Only compares and bit operations: every output is exact.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace thr {
namespace {

constexpr int kV = 64;          // threshold lanes
constexpr int kThreads = 1024;  // rows per block, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / kV;  // row groups of the carry pass
constexpr int kBig = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

template <bool kLe>
__device__ __forceinline__ bool hit(int d, int v) {
  return kLe ? d <= v : d < v;
}

// Bit r of the mask of threshold v is set where row r of this warp hits
// v; lane t returns the masks of v = t (lo) and v = t + 32 (hi).
template <bool kLe>
__device__ __forceinline__ void lane_masks(int d, unsigned* lo, unsigned* hi) {
  const int lane = threadIdx.x & 31;
  unsigned a = 0, b = 0;
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    const unsigned mk = __ballot_sync(kFull, hit<kLe>(d, v));
    if (lane == v) a = mk;
  }
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    const unsigned mk = __ballot_sync(kFull, hit<kLe>(d, v + 32));
    if (lane == v) b = mk;
  }
  *lo = a;
  *hi = b;
}

// This warp's answer at every threshold: P[warp][v] the packed key of its
// last hitting row (-1 if none), N[warp][v] of its first (kBig if none).
// `base` is the warp's first row.
__device__ __forceinline__ void warp_aggregates(int d, int base, unsigned lo, unsigned hi,
                                                int (*P)[kV], int (*N)[kV]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned mk = h ? hi : lo;
    const int last = mk ? 31 - __clz(mk) : -1;
    const int first = mk ? __ffs(mk) - 1 : -1;
    const int dl = __shfl_sync(kFull, d, last < 0 ? 0 : last);
    const int df = __shfl_sync(kFull, d, first < 0 ? 0 : first);
    P[warp][lane + 32 * h] = last < 0 ? -1 : 64 * (base + last) + dl;
    N[warp][lane + 32 * h] = first < 0 ? kBig : 64 * (base + first) + df;
  }
}

template <bool kLe>
__global__ void __launch_bounds__(kThreads)
    thr_aggregate(const int* __restrict__ d, int m, int* __restrict__ aggP,
                  int* __restrict__ aggN) {
  __shared__ int P[kWarps][kV], N[kWarps][kV];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int di = i < m ? d[i] : kV;  // a row past the end hits no threshold
  unsigned lo, hi;
  lane_masks<kLe>(di, &lo, &hi);
  warp_aggregates(di, blockIdx.x * kThreads + (threadIdx.x & ~31), lo, hi, P, N);
  __syncthreads();
  if (threadIdx.x < kV) {
    const int v = threadIdx.x;
    int p = -1, n = kBig;
    for (int w = 0; w < kWarps; ++w) {
      p = max(p, P[w][v]);
      n = min(n, N[w][v]);
    }
    aggP[blockIdx.x * kV + v] = p;
    aggN[blockIdx.x * kV + v] = n;
  }
}

// One block: thread (g, v) takes a contiguous run of blocks for threshold
// v, the groups' totals are combined in shared memory, then each run is
// rewritten as exclusive carries (max over earlier blocks, min over later).
__global__ void __launch_bounds__(kThreads)
    thr_carry(int* __restrict__ aggP, int* __restrict__ aggN, int nb) {
  __shared__ int gP[kGroups][kV], gN[kGroups][kV];
  const int v = threadIdx.x % kV, g = threadIdx.x / kV;
  const int chunk = (nb + kGroups - 1) / kGroups;
  const int b0 = min(g * chunk, nb), b1 = min(b0 + chunk, nb);
  int p = -1, n = kBig;
  for (int b = b0; b < b1; ++b) {
    p = max(p, aggP[b * kV + v]);
    n = min(n, aggN[b * kV + v]);
  }
  gP[g][v] = p;
  gN[g][v] = n;
  __syncthreads();
  p = -1;
  n = kBig;
  for (int h = 0; h < g; ++h) p = max(p, gP[h][v]);
  for (int h = g + 1; h < kGroups; ++h) n = min(n, gN[h][v]);
  for (int b = b0; b < b1; ++b) {
    const int t = aggP[b * kV + v];
    aggP[b * kV + v] = p;
    p = max(p, t);
  }
  for (int b = b1 - 1; b >= b0; --b) {
    const int t = aggN[b * kV + v];
    aggN[b * kV + v] = n;
    n = min(n, t);
  }
}

// psv may be null (not written)
template <bool kLe>
__global__ void __launch_bounds__(kThreads)
    thr_apply(const int* __restrict__ d, int m, const int* __restrict__ carryP,
              const int* __restrict__ carryN, int* __restrict__ psv, int* __restrict__ nsv) {
  __shared__ int P[kWarps][kV], N[kWarps][kV];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kThreads + warp * 32;
  const int di = i < m ? d[i] : kV;
  unsigned lo, hi;
  lane_masks<kLe>(di, &lo, &hi);
  warp_aggregates(di, base, lo, hi, P, N);
  __syncthreads();
  if (threadIdx.x < kV) {  // exclusive scans over the warps, from the block's carries
    const int v = threadIdx.x;
    int p = carryP[blockIdx.x * kV + v];
    for (int w = 0; w < kWarps; ++w) {
      const int t = P[w][v];
      P[w][v] = p;
      p = max(p, t);
    }
    int n = carryN[blockIdx.x * kV + v];
    for (int w = kWarps - 1; w >= 0; --w) {
      const int t = N[w][v];
      N[w][v] = n;
      n = min(n, t);
    }
  }
  __syncthreads();
  const int q = min(di, kV - 1);  // this row's query lane
  const unsigned a = __shfl_sync(kFull, lo, q & 31);
  const unsigned b = __shfl_sync(kFull, hi, q & 31);
  const unsigned mk = q < 32 ? a : b;
  const unsigned before = mk & ((1u << lane) - 1u);
  const unsigned after = mk & ~(kFull >> (31 - lane));
  const int jb = before ? 31 - __clz(before) : 0;
  const int ja = after ? __ffs(after) - 1 : 0;
  const int db = __shfl_sync(kFull, di, jb);
  const int da = __shfl_sync(kFull, di, ja);
  if (i >= m) return;
  const int p = before ? 64 * (base + jb) + db : P[warp][q];
  const int n = after ? 64 * (base + ja) + da : N[warp][q];
  if (psv) psv[i] = p;
  nsv[i] = n;
}

// The three launches on `stream`; agg holds 2 * ceil(m / 1024) * 64 ints.
template <bool kLe>
inline cudaError_t run(const int* d, int m, int* agg, int* psv, int* nsv, cudaStream_t stream) {
  const int nb = (m + kThreads - 1) / kThreads;
  int* aggP = agg;
  int* aggN = agg + (size_t)nb * kV;
  thr_aggregate<kLe><<<nb, kThreads, 0, stream>>>(d, m, aggP, aggN);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  thr_carry<<<1, kThreads, 0, stream>>>(aggP, aggN, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  thr_apply<kLe><<<nb, kThreads, 0, stream>>>(d, m, aggP, aggN, psv, nsv);
  return cudaGetLastError();
}

}  // namespace
}  // namespace thr
