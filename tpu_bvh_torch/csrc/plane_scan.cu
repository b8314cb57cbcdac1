// Inclusive cummin / cummax of an i32[m, V] plane along its rows, forward
// or from the bottom (B11).
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/plane_scan.py:plane_scan
// (_scan_kernel), which walks 512-row chunks in order, scans each with
// sublane rolls and carries the last row in VMEM from one grid step to
// the next. Contract (tpu_bvh_torch/ops/plane_scan.py): out[r, c] = op of
// x[0..r, c] (forward) or x[r..m-1, c] (reverse), op = min or max.
//
// Bound on the card: bytes, the plane read once and written once (256 B
// each per row at V = 64). Columns are independent and a row is
// contiguous, so a warp takes 32 columns of one row (128-byte accesses)
// and each thread walks its column down a segment of 64 rows; the TPU's
// in-order carry becomes three launches, as blocks run in no order:
//   1. ps_aggregate: op over each 64-row segment, per column;
//   2. ps_carry (one block per 64 columns): per column, the exclusive op
//      over the segments before (after, in reverse) each segment;
//   3. ps_apply: each thread scans its segment from its carry and writes.
// The plane is read twice (passes 1 and 3) and written once. Only min and
// max: every output is exact.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;     // columns per block
constexpr int kGroups = 4;    // segments per block of passes 1 and 3
constexpr int kSeg = 64;      // rows per segment
constexpr int kCarryGroups = 16;

template <bool kMin>
__device__ __forceinline__ int ident() {
  return kMin ? INT_MAX : INT_MIN;
}

template <bool kMin>
__device__ __forceinline__ int op(int a, int b) {
  return kMin ? min(a, b) : max(a, b);
}

// segment s = blockIdx.x * kGroups + (threadIdx.x / kCols) covers rows
// [s * kSeg, (s + 1) * kSeg); column c = blockIdx.y * kCols + threadIdx.x % kCols
template <bool kMin>
__global__ void __launch_bounds__(kCols * kGroups)
    ps_aggregate(const int* __restrict__ x, int m, int V, int* __restrict__ agg) {
  const int c = blockIdx.y * kCols + threadIdx.x % kCols;
  const int s = blockIdx.x * kGroups + threadIdx.x / kCols;
  if (c >= V) return;
  const int r0 = s * kSeg, r1 = min(r0 + kSeg, m);
  int acc = ident<kMin>();
  for (int r = r0; r < r1; ++r) acc = op<kMin>(acc, x[(size_t)r * V + c]);
  agg[(size_t)s * V + c] = acc;
}

template <bool kMin, bool kRev>
__global__ void __launch_bounds__(kCols * kCarryGroups)
    ps_carry(const int* __restrict__ agg, int S, int V, int* __restrict__ carry) {
  __shared__ int tot[kCarryGroups][kCols];
  const int cl = threadIdx.x % kCols, g = threadIdx.x / kCols;
  const int c = blockIdx.x * kCols + cl;
  const int chunk = (S + kCarryGroups - 1) / kCarryGroups;
  const int s0 = min(g * chunk, S), s1 = min(s0 + chunk, S);
  int acc = ident<kMin>();
  if (c < V)
    for (int s = s0; s < s1; ++s) acc = op<kMin>(acc, agg[(size_t)s * V + c]);
  tot[g][cl] = acc;
  __syncthreads();
  if (c >= V) return;
  int run = ident<kMin>();
  if (!kRev) {
    for (int h = 0; h < g; ++h) run = op<kMin>(run, tot[h][cl]);
    for (int s = s0; s < s1; ++s) {
      carry[(size_t)s * V + c] = run;
      run = op<kMin>(run, agg[(size_t)s * V + c]);
    }
  } else {
    for (int h = g + 1; h < kCarryGroups; ++h) run = op<kMin>(run, tot[h][cl]);
    for (int s = s1 - 1; s >= s0; --s) {
      carry[(size_t)s * V + c] = run;
      run = op<kMin>(run, agg[(size_t)s * V + c]);
    }
  }
}

template <bool kMin, bool kRev>
__global__ void __launch_bounds__(kCols * kGroups)
    ps_apply(const int* __restrict__ x, int m, int V, const int* __restrict__ carry,
             int* __restrict__ out) {
  const int c = blockIdx.y * kCols + threadIdx.x % kCols;
  const int s = blockIdx.x * kGroups + threadIdx.x / kCols;
  if (c >= V) return;
  const int r0 = s * kSeg, r1 = min(r0 + kSeg, m);
  int run = carry[(size_t)s * V + c];
  if (!kRev) {
    for (int r = r0; r < r1; ++r) {
      run = op<kMin>(run, x[(size_t)r * V + c]);
      out[(size_t)r * V + c] = run;
    }
  } else {
    for (int r = r1 - 1; r >= r0; --r) {
      run = op<kMin>(run, x[(size_t)r * V + c]);
      out[(size_t)r * V + c] = run;
    }
  }
}

template <bool kMin, bool kRev>
cudaError_t run(const int* x, int m, int V, int* agg, int* carry, int* out,
                cudaStream_t stream) {
  const int nb = (m + kGroups * kSeg - 1) / (kGroups * kSeg);
  const int S = nb * kGroups;
  const int ct = (V + kCols - 1) / kCols;
  const dim3 grid(nb, ct);
  ps_aggregate<kMin><<<grid, kCols * kGroups, 0, stream>>>(x, m, V, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ps_carry<kMin, kRev><<<ct, kCols * kCarryGroups, 0, stream>>>(agg, S, V, carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ps_apply<kMin, kRev><<<grid, kCols * kGroups, 0, stream>>>(x, m, V, carry, out);
  return cudaGetLastError();
}

}  // namespace

// agg and carry hold ceil(m / 256) * 4 * V ints each
extern "C" int tbvh_plane_scan(const int* x, int m, int V, int is_min, int reverse, int* agg,
                               int* carry, int* out, cudaStream_t stream) {
  cudaError_t err;
  if (is_min)
    err = reverse ? run<true, true>(x, m, V, agg, carry, out, stream)
                  : run<true, false>(x, m, V, agg, carry, out, stream);
  else
    err = reverse ? run<false, true>(x, m, V, agg, carry, out, stream)
                  : run<false, false>(x, m, V, agg, carry, out, stream);
  return (int)err;
}
