// Dense anchored-refit stencil: short-node unions, short flag, level-4 row.
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/refit_dense.py:
// refit_dense_pallas (_kernel), a blocked [8, 16K] stencil over VMEM with
// pltpu.roll neighbour views. Same contract: for boundary i with leaf
// range [first, last],
//   acc[:, i] = min of leaf columns j in [first, last], i-R < j <= i+R,
//               columns j > n-1 read as +3e38 on the forward side
//   short[i]  = (i - first < R) && (last - i <= R)
//   t4[:, i]  = min of leaf columns [i, i+16), columns >= n as +3e38.
// Every min is jmin (common.cuh), jnp.minimum's rule, under which min is
// commutative, associative and idempotent bit for bit (one NaN pattern
// aside), so any order of the same operands gives the plain version's bits.
//
// Design: a block owns a tile of kTile columns. It stages the six packed
// rows (min xyz, -max xyz) of columns [t0 - R, t0 + kTile + max(R, 15))
// into shared memory with cp.async (+3e38 outside [0, s)); after that every
// window read is a shared-memory read. Each column's union is one
// contiguous range of staged columns, [i - kb + 1, i + kf] (kb backward
// columns, i included; kf forward ones, cut at column n - 1), and one more
// min with +3e38 (the plain version's start value, which also stands for
// the forward columns past n - 1); t4 is the range [i, min(i + 15, n - 1)],
// with +3e38 where the window passes n - 1. The ranges are answered from a
// sparse table built in place over the staged rows: at level k a row holds
// the min over [j, j + 2^k), and a range of length len takes level
// floor(log2(len)), two lookups. Levels run to floor(log2(2R)) (5 at R =
// 24), each with two block barriers. The outputs are stored coalesced: a
// thread owns columns t0 + tid + q * kThreads.
//
// Bound on the card: bytes. The function reads the six rows and first and
// last once (32 B a column) and writes acc, t4 and the flag (49 B a
// column); the halos add 2R + 15 columns a tile (about 6% at R = 24).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using tbvh::jmin;

constexpr float kBig = 3.0e38f;
constexpr int kTile = 1024;     // columns a block owns: refit_dense.TILE
constexpr int kMaxHalo = 128;   // largest radius: refit_dense.MAX_RADIUS
constexpr int kThreads = 512;
constexpr int kSpan = kTile + 2 * kMaxHalo;               // staged columns, at most
constexpr int kPer = kTile / kThreads;                    // columns a thread owns
constexpr int kStage = (kSpan + kThreads - 1) / kThreads;  // staged columns a thread folds
constexpr size_t kSmem = 6 * kSpan * sizeof(float);

__device__ __forceinline__ int floor_log2(int x) { return 31 - __clz(x); }

__global__ void __launch_bounds__(kThreads)
    refit_dense_tile(const float* __restrict__ cols, int s, const int* __restrict__ first,
                     const int* __restrict__ last, int m_fl, int n, int R,
                     float* __restrict__ acc, unsigned char* __restrict__ short_flag,
                     float* __restrict__ t4) {
  extern __shared__ float sm[];  // sm[c * kSpan + k]: row c of column lo0 + k
  const int t0 = blockIdx.x * kTile;
  const int lo0 = t0 - R;
  const int span = min(kTile, s - t0) + R + max(R, 15);
  for (int k = threadIdx.x; k < span; k += kThreads) {
    const int j = lo0 + k;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float* dst = sm + c * kSpan + k;
      if (j >= 0 && j < s)
        tbvh::cp_async4(dst, cols + (size_t)c * s + j);
      else
        *dst = kBig;
    }
  }

  // each owned column's two ranges (start in the staged window, length),
  // worked out while the copies are in flight
  int a_lo[kPer], a_len[kPer], t_len[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = t0 + threadIdx.x + q * kThreads;
    a_lo[q] = 0;
    a_len[q] = t_len[q] = 0;
    if (i >= s) continue;
    const int f = i < m_fl ? first[i] : n - 1;
    const int l = i < m_fl ? last[i] : n - 1;
    const int la = l - i, ab = i - f;
    const int kb = ab < 0 ? 0 : min(ab, R - 1) + 1;  // backward columns, i included
    const int kf = la < 1 ? 0 : min(la, R);            // forward columns
    a_lo[q] = i - kb + 1 - lo0;
    a_len[q] = kb + max(0, min(kf, n - 1 - i));        // forward ones cut at n - 1
    t_len[q] = max(0, min(15, n - 1 - i) + 1);         // t4 columns <= n - 1
    short_flag[i] = ab < R && la <= R;
  }

  float va[kPer][6], vt[kPer][6];
#pragma unroll
  for (int q = 0; q < kPer; ++q)
#pragma unroll
    for (int c = 0; c < 6; ++c) va[q][c] = vt[q][c] = kBig;
  tbvh::cp_async_wait_all();
  __syncthreads();

  const int top = floor_log2(2 * R);  // the longest range: R back, R forward
  for (int k = 0;; ++k) {
    const int h = 1 << k;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (a_len[q] > 0 && floor_log2(a_len[q]) == k) {
        const int a = a_lo[q], b = a_lo[q] + a_len[q] - h;
#pragma unroll
        for (int c = 0; c < 6; ++c) va[q][c] = jmin(sm[c * kSpan + a], sm[c * kSpan + b]);
      }
      if (t_len[q] > 0 && floor_log2(t_len[q]) == k) {
        const int tlo = threadIdx.x + q * kThreads + R;  // column i in the window
        const int b = tlo + t_len[q] - h;
#pragma unroll
        for (int c = 0; c < 6; ++c) vt[q][c] = jmin(sm[c * kSpan + tlo], sm[c * kSpan + b]);
      }
    }
    if (k == top) break;
    // the next level in place: read every fold, barrier, write, barrier
    float nxt[kStage][6];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int j = threadIdx.x + u * kThreads;
      if (j + h < span) {
#pragma unroll
        for (int c = 0; c < 6; ++c) nxt[u][c] = jmin(sm[c * kSpan + j], sm[c * kSpan + j + h]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int j = threadIdx.x + u * kThreads;
      if (j + h < span) {
#pragma unroll
        for (int c = 0; c < 6; ++c) sm[c * kSpan + j] = nxt[u][c];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = t0 + threadIdx.x + q * kThreads;
    if (i >= s) continue;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      acc[(size_t)c * s + i] = jmin(va[q][c], kBig);
      t4[(size_t)c * s + i] = t_len[q] < 16 ? jmin(vt[q][c], kBig) : vt[q][c];
    }
  }
}

}  // namespace

extern "C" int tbvh_refit_dense(const float* cols, int s, const int* first, const int* last,
                                int m_fl, int n, int radius, float* acc,
                                unsigned char* short_flag, float* t4, cudaStream_t stream) {
  if (radius < 1 || radius > kMaxHalo) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(refit_dense_tile,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  refit_dense_tile<<<(s + kTile - 1) / kTile, kThreads, kSmem, stream>>>(
      cols, s, first, last, m_fl, n, radius, acc, short_flag, t4);
  return (int)cudaGetLastError();
}
