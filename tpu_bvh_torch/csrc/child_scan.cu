// Child positions: the segmented argmin of (d << 22 | j) on each side of
// every row (B15).
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/threshold_core.py:
// child_positions_auto (_run_child; _child_kernel_lanes_fwd, _rev), which
// runs, per threshold v, a segmented running min of (d_j << 22 | j) over
// the candidates d_j > v, resetting at d_j <= v, and selects lane d_k
// exclusively before (left) and after (right) row k. Contract
// (tpu_bvh_torch/ops/threshold_core.py), for d i32[m] in [0, 63], m < 2^22:
//   left[k]  = argmin of (d_j, j) over j in (s_k, k), s_k = last j < k with d_j <= d_k;
//   right[k] = argmin of (d_j, j) over j in (k, e_k), e_k = first j > k with d_j <= d_k;
//   -1 where the window is empty.
//
// Bound on the card: bytes, 4 B read and 8 B written per row. A walk over
// the window would be quadratic (a lone 0 among larger values has a window
// of length m), and a range-min table costs log m passes. The design finds
// each child as the unique row that names its parent: with ns = next
// strictly smaller, pl = previous <=, nl = next <= (threshold_common.cuh),
//   left[k]  = the j with ns(j) = k and pl(j) = pl(k),
//   right[k] = the j with pl(j) = k and ns(j) = nl(k).
// (The window's minimum j*, the first of equal minima, has nothing smaller
// between it and k and nothing <= between s_k and it, which gives both
// equalities; any other j of the window has a smaller row between it and
// k, or between it and e_k, or an equal one before it.) So two threshold
// scans (strict, and <=), then one pass in which each row writes itself
// into at most two slots, each slot written by at most one row: no atomics,
// no order, exact. Seven launches and two memsets.

#include "threshold_common.cuh"

namespace {

__global__ void child_scatter(const int* __restrict__ ns, const int* __restrict__ pl,
                              const int* __restrict__ nl, int m, int* __restrict__ left,
                              int* __restrict__ right) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  // packed keys 64 pos + d compare like positions, sentinels included
  const int nsj = ns[j], plj = pl[j];
  if (nsj != thr::kBig && pl[nsj >> 6] == plj) left[nsj >> 6] = j;
  if (plj >= 0 && nl[plj >> 6] == nsj) right[plj >> 6] = j;
}

}  // namespace

// scratch holds 3 m ints (ns, pl, nl), agg 2 * ceil(m / 1024) * 64
extern "C" int tbvh_child_positions(const int* dlt, int m, int* agg, int* scratch, int* left,
                                    int* right, cudaStream_t stream) {
  int* ns = scratch;
  int* pl = scratch + m;
  int* nl = scratch + 2 * (size_t)m;
  cudaError_t err = cudaMemsetAsync(left, 0xFF, (size_t)m * sizeof(int), stream);  // -1
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(right, 0xFF, (size_t)m * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  err = thr::run<false>(dlt, m, agg, nullptr, ns, stream);
  if (err != cudaSuccess) return (int)err;
  err = thr::run<true>(dlt, m, agg, pl, nl, stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  child_scatter<<<(m + threads - 1) / threads, threads, 0, stream>>>(ns, pl, nl, m, left, right);
  return (int)cudaGetLastError();
}
