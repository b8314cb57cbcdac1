// Device helpers of the two batched builds (batched_build.cu, one warp a
// mesh; batched_block.cu, one block a mesh): the min_key order of the
// boxes and the plain 30-bit Morton code of morton30_cols.

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace tbvh {

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

// morton30_cols of a prim box's centre in a scene box (smin, safe extent),
// with IEEE division (the library builds with --fmad=false)
__device__ __forceinline__ unsigned morton30(const float (&mn)[3], const float (&mx)[3],
                                             const float (&smin)[3], const float (&safe)[3]) {
  unsigned q[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) q[a] = quantize(((mn[a] + mx[a]) * 0.5f - smin[a]) / safe[a]);
  return spread3(q[0]) * 4u + spread3(q[1]) * 2u + spread3(q[2]);
}

// the delta of sorted boundary j from its codes (a tie: 32 + clz(j ^ (j + 1))),
// remapped to [0, 52] as scan32.remap_deltas
__device__ __forceinline__ int remapped_delta(unsigned code, unsigned next, int j) {
  const unsigned x = code ^ next;
  const int raw = x ? __clz(static_cast<int>(x)) : 32 + __clz(j ^ (j + 1));
  return raw <= 31 ? raw - 2 : raw - 11;
}

}  // namespace tbvh
