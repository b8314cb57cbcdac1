// Batched build of tiny meshes: one BVH2 per mesh of 2..64 prims, one warp
// a mesh, the whole batch in one launch.
//
// Replaces no TPU kernel: the JAX package builds tiny meshes with the dense
// all-pairs form tpu_bvh/models/batched.py:_build_batched_small (XLA ops
// over [B, m, m] and [B, m, M] masks, no Pallas), its TPU form of the
// reference's whole-pipeline-in-one-block batched kernel
// (BatchedBuildKernel.h:218-312). Same contract, bit for bit; the plain
// version is ops/batched_build.py:batched_build_reference.
//
// Design: a warp owns a mesh, and lane l owns slots l and l + 32 (E = 1 slot
// a lane for M <= 32, 2 for M <= 64). A slot is a prim before the sort, a
// sorted leaf after it and a Morton boundary (an internal node) for the
// deltas.
//  1. The mesh's 36 M bytes are copied coalesced into shared memory; each
//     lane forms its prims' boxes (jmin / jmax over the three vertices, as
//     jnp.minimum / maximum) and the warp reduces the scene box as min_keys
//     (__reduce_min_sync).
//  2. Codes as morton30_cols computes them (IEEE division, no FMA), then a
//     bitonic network over the 64-bit keys (code << 6) | prim, padding slots
//     ~0: the keys are distinct, so the network's order is the stable sort
//     by code.
//  3. Deltas from the next slot's code (a shuffle), remapped to [0, 52] as
//     scan32.remap_deltas. Six ballots give the bit planes of the deltas as
//     64-bit masks over the boundaries; a comparator over the planes gives
//     each boundary the mask of smaller deltas, whose highest bit below it is
//     psv and lowest bit above it nsv. The children are bit-sliced argmins
//     over the planes: the lowest set bit of the survivors is the earliest
//     argmin.
//  4. Refit: an internal node takes the min of the min_keys of its leaves
//     [first, last] from shared memory (the key order is jmin's, so the min
//     of keys is exact in any order), and the key of 3e38 where the range is
//     not the whole mesh (JAX's masked min).
//  5. Each row of packed_t, left and right is written at lane-consecutive
//     addresses.
//
// Bound on the card: bytes. Per mesh it reads 36 M bytes and writes
// (6 + 2) * 4 * (2M - 1) + 4 bytes; everything between stays in registers
// and shared memory.

#include <climits>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using tbvh::jmax;
using tbvh::jmin;
using u64 = unsigned long long;

constexpr int kMaxPrims = 64;  // the largest capacity: batched_build.MAX_PRIMS
constexpr int kWarps = 4;      // meshes a block, one warp each
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.0e38f;

// aabb.min_key: an int whose order is jmin's (-0.0 < +0.0, NaN lowest)
__device__ __forceinline__ int min_key(float x) {
  const int b = __float_as_int(x);
  return x != x ? INT_MIN : b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_min_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// 10 -> 30 bit spread (morton._spread3; the products wrap at 32 bits)
__device__ __forceinline__ unsigned spread3(unsigned x) {
  x = (x * 0x00010001u) & 0xFF0000FFu;
  x = (x * 0x00000101u) & 0x0F00F00Fu;
  x = (x * 0x00000011u) & 0xC30C30C3u;
  x = (x * 0x00000005u) & 0x49249249u;
  return x;
}

// clip(p * 1024, 0, 1023) truncated, as morton30_cols
__device__ __forceinline__ unsigned quantize(float p) {
  return static_cast<unsigned>(fminf(fmaxf(p * 1024.0f, 0.0f), 1023.0f));
}

// the earliest argmin of the deltas over the boundaries in `c` (-1 if none):
// from the top bit plane down, keep the candidates whose bit is 0 where any is
__device__ __forceinline__ int argmin(u64 c, const u64 (&plane)[6]) {
#pragma unroll
  for (int bit = 5; bit >= 0; --bit) {
    const u64 z = c & ~plane[bit];
    c = z ? z : c;
  }
  return c ? __ffsll(static_cast<long long>(c)) - 1 : -1;
}

template <int E>
__global__ void __launch_bounds__(kWarps * 32)
    batched_build_warp(const float* __restrict__ tris, int B, int M, float* __restrict__ packed_t,
                       int* __restrict__ left, int* __restrict__ right, int* __restrict__ root) {
  constexpr int N = 32 * E;  // slots a warp
  __shared__ float s_tri[kWarps][9 * N];  // the mesh as loaded
  __shared__ float s_row[kWarps][6][N];   // leaf rows (min xyz, -max xyz) by prim
  __shared__ int s_key[kWarps][6][N];     // their min_keys by sorted leaf
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp; only warp-level syncs follow
  const int m = M - 1;
  const int W = 2 * M - 1;
  float* tri = s_tri[warp];
  const float* src = tris + static_cast<size_t>(b) * M * 9;
  for (int t = lane; t < 9 * M; t += 32) tri[t] = src[t];
  __syncwarp();

  // 1. prim boxes and the scene box
  float mn[E][3], mx[E][3];
  int kmn[3] = {INT_MAX, INT_MAX, INT_MAX}, kmx[3] = {INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = e * 32 + lane;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mn[e][a] = mx[e][a] = 0.0f;
      if (p < M) {
        const float v0 = tri[p * 9 + a], v1 = tri[p * 9 + 3 + a], v2 = tri[p * 9 + 6 + a];
        mn[e][a] = jmin(jmin(v0, v1), v2);
        mx[e][a] = jmax(jmax(v0, v1), v2);
        s_row[warp][a][p] = mn[e][a];
        s_row[warp][3 + a][p] = -mx[e][a];
        kmn[a] = min(kmn[a], min_key(mn[e][a]));
        kmx[a] = min(kmx[a], min_key(-mx[e][a]));
      }
    }
  }
  float smin[3], safe[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    smin[a] = from_min_key(__reduce_min_sync(kFull, kmn[a]));
    const float ext = -from_min_key(__reduce_min_sync(kFull, kmx[a])) - smin[a];
    safe[a] = ext > 0.0f ? ext : 1.0f;
  }

  // 2. codes and the sort
  u64 key[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = e * 32 + lane;
    unsigned q[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      q[a] = quantize(((mn[e][a] + mx[e][a]) * 0.5f - smin[a]) / safe[a]);
    const unsigned code = spread3(q[0]) * 4u + spread3(q[1]) * 2u + spread3(q[2]);
    key[e] = p < M ? (static_cast<u64>(code) << 6) | static_cast<u64>(p) : ~0ull;
  }
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // E == 2, k == 64: slot lane against slot lane + 32, ascending
        const u64 lo = key[0] < key[E - 1] ? key[0] : key[E - 1];
        key[E - 1] = key[0] < key[E - 1] ? key[E - 1] : key[0];
        key[0] = lo;
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = e * 32 + lane;
          const u64 other = __shfl_xor_sync(kFull, key[e], j);
          const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
          key[e] = (key[e] < other) == keep_min ? key[e] : other;
        }
      }
    }
  }

  // 3. sorted leaves, deltas, leaf ranges and children
  __syncwarp();  // s_row is complete
  float leaf[E][6];
  int prim[E], dlt[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = e * 32 + lane;
    prim[e] = static_cast<int>(key[e] & 63);
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      leaf[e][r] = 0.0f;
      if (k < M) {
        leaf[e][r] = s_row[warp][r][prim[e]];
        s_key[warp][r][k] = min_key(leaf[e][r]);
      }
    }
    const unsigned code = static_cast<unsigned>(key[e] >> 6);
    unsigned next = __shfl_down_sync(kFull, code, 1);
    if (e + 1 < E) {  // lane 31's neighbour is lane 0 of the next slot row
      const unsigned wrap = __shfl_sync(kFull, static_cast<unsigned>(key[E - 1] >> 6), 0);
      if (lane == 31) next = wrap;
    }
    const unsigned x = code ^ next;
    const int raw = x ? __clz(static_cast<int>(x)) : 32 + __clz(k ^ (k + 1));
    dlt[e] = raw <= 31 ? raw - 2 : raw - 11;
  }
  u64 plane[6];
#pragma unroll
  for (int bit = 0; bit < 6; ++bit) {
    plane[bit] = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool set = e * 32 + lane < m && ((dlt[e] >> bit) & 1);
      plane[bit] |= static_cast<u64>(__ballot_sync(kFull, set)) << (32 * e);
    }
  }
  const u64 valid = (1ull << m) - 1;  // m <= 63
  int first[E], last[E], lc[E], rc[E];
  unsigned root_bal[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    first[e] = last[e] = 0;
    lc[e] = rc[e] = -1;
    if (i < m) {
      u64 lt = 0, eq = valid;  // boundaries with a smaller delta / an equal one so far
#pragma unroll
      for (int bit = 5; bit >= 0; --bit) {
        if ((dlt[e] >> bit) & 1) {
          lt |= eq & ~plane[bit];
          eq &= plane[bit];
        } else {
          eq &= ~plane[bit];
        }
      }
      const u64 below = (1ull << i) - 1;     // boundaries j < i
      const u64 above = ~((2ull << i) - 1);  // boundaries j > i (i <= 62)
      const u64 before = lt & below, after = lt & above;
      first[e] = before ? 64 - __clzll(static_cast<long long>(before)) : 0;  // psv + 1
      last[e] = after ? __ffsll(static_cast<long long>(after)) - 1 : m;
      lc[e] = argmin(below & ~((1ull << first[e]) - 1), plane);  // psv < j < i
      rc[e] = argmin(above & ((1ull << last[e]) - 1), plane);    // i < j < last
    }
    root_bal[e] = __ballot_sync(kFull, i < m && first[e] == 0 && last[e] == m);
  }
  __syncwarp();  // s_key is complete

  // 4. refit and 5. the outputs
  float* out = packed_t + static_cast<size_t>(b) * 6 * W;
  int* lo = left + static_cast<size_t>(b) * W;
  int* ro = right + static_cast<size_t>(b) * W;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    if (i < m) {
      int acc[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) acc[r] = last[e] - first[e] + 1 < M ? min_key(kBig) : INT_MAX;
      for (int t = first[e]; t <= last[e]; ++t) {
#pragma unroll
        for (int r = 0; r < 6; ++r) acc[r] = min(acc[r], s_key[warp][r][t]);
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) out[r * W + i] = from_min_key(acc[r]);
      lo[i] = lc[e] >= 0 ? lc[e] : m + i;
      ro[i] = rc[e] >= 0 ? rc[e] : m + i + 1;
    }
    if (i < M) {
#pragma unroll
      for (int r = 0; r < 6; ++r) out[r * W + m + i] = leaf[e][r];
      lo[m + i] = prim[e];
      ro[m + i] = -1;
    }
  }
  if (lane == 0) {
    int r = 0;  // the first root, as JAX's argmax
#pragma unroll
    for (int e = E - 1; e >= 0; --e)
      if (root_bal[e]) r = e * 32 + __ffs(static_cast<int>(root_bal[e])) - 1;
    root[b] = r;
  }
}

}  // namespace

extern "C" int tbvh_batched_build(const float* tris, int B, int M, float* packed_t, int* left,
                                  int* right, int* root, cudaStream_t stream) {
  if (B < 1 || M < 2 || M > kMaxPrims) return (int)cudaErrorInvalidValue;
  const int grid = (B + kWarps - 1) / kWarps;
  if (M <= 32)
    batched_build_warp<1><<<grid, kWarps * 32, 0, stream>>>(tris, B, M, packed_t, left, right,
                                                             root);
  else
    batched_build_warp<2><<<grid, kWarps * 32, 0, stream>>>(tris, B, M, packed_t, left, right,
                                                             root);
  return (int)cudaGetLastError();
}
