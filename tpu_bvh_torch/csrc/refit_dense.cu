// Dense anchored-refit stencil: short-node unions, short flag, level-4 row.
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/refit_dense.py:
// refit_dense_pallas (_kernel), a blocked [8, 16K] stencil over VMEM with
// pltpu.roll neighbour views. Same contract: for boundary i with leaf
// range [first, last] (mat rows 6, 7),
//   acc[:, i] = min of leaf columns j in [first, last], i-R < j <= i+R
//   short[i]  = (i - first < R) && (last - i <= R)
//   t4[:, i]  = min of leaf columns [i, i+16), columns >= n as +3e38.
// Only min operations, so the result is bit-exact in any order.
//
// Design: one thread per boundary, six packed rows (min xyz, -max xyz)
// each. Neighbouring threads read neighbouring columns, so every load of
// the +-R window is coalesced and the overlap between threads is served
// from L1/L2. Bound on the card: bytes — each column is reused by ~2R+16
// threads, so the kernel is L1-bandwidth bound rather than DRAM bound;
// a shared-memory tile with a halo is the next step if it matters.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;

// min that propagates NaN like torch.minimum / jnp.minimum
__device__ __forceinline__ float nmin(float a, float b) { return (a != a || a < b) ? a : b; }

__global__ void refit_dense_kernel(const int* __restrict__ mat, int s, int n, int R,
                                   float* __restrict__ acc, unsigned char* __restrict__ short_flag,
                                   float* __restrict__ t4) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  const float* cols = reinterpret_cast<const float*>(mat);
  int first = mat[6 * s + i];
  int last = mat[7 * s + i];
  int la = last - i;   // forward budget
  int ab = i - first;  // backward budget
  int fwd = R > 15 ? R : 15;
  for (int c = 0; c < 6; ++c) {
    const float* row = cols + (size_t)c * s;
    float a = kBig;
    float t = i <= n - 1 ? row[i] : kBig;
    for (int d = 1; d <= fwd; ++d) {
      int j = i + d;
      float w = (j <= n - 1 && j < s) ? row[j] : kBig;
      if (d < 16) t = nmin(t, w);
      if (d <= R && d <= la) a = nmin(a, w);
    }
    for (int d = 0; d < R; ++d) {
      if (d > ab) break;
      int j = i - d;
      a = nmin(a, j >= 0 ? row[j] : kBig);
    }
    acc[(size_t)c * s + i] = a;
    t4[(size_t)c * s + i] = t;
  }
  short_flag[i] = (ab < R) && (la <= R);
}

}  // namespace

extern "C" int tbvh_refit_dense(const int* mat, int s, int n, int radius, float* acc,
                                unsigned char* short_flag, float* t4, cudaStream_t stream) {
  const int threads = 256;
  refit_dense_kernel<<<(s + threads - 1) / threads, threads, 0, stream>>>(
      mat, s, n, radius, acc, short_flag, t4);
  return (int)cudaGetLastError();
}
