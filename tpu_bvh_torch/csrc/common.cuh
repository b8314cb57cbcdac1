// Device helpers shared by the kernels: the AABB min and max of jnp.minimum
// and jnp.maximum, and the asynchronous 4-byte copy that stages a tile into
// shared memory.

#pragma once

#include <cuda_runtime.h>

namespace tbvh {

// min as jnp.minimum computes it: NaN propagates (a's first) and -0.0 <
// +0.0 (equal values give the or of their bits), so the result does not
// depend on the order of finite arguments; written with selects only
__device__ __forceinline__ float jmin(float a, float b) {
  float r = a < b ? a : b;
  r = a == b ? __int_as_float(__float_as_int(a) | __float_as_int(b)) : r;
  r = b != b ? b : r;
  return a != a ? a : r;
}

// max as jnp.maximum computes it: +0.0 > -0.0 (equal values give the and
// of their bits), NaN propagates (a's first); aabb.fmax
__device__ __forceinline__ float jmax(float a, float b) {
  float r = a > b ? a : b;
  r = a == b ? __int_as_float(__float_as_int(a) & __float_as_int(b)) : r;
  r = b != b ? b : r;
  return a != a ? a : r;
}

// cp.async of one 4-byte word from global to shared memory (sm_80+);
// cp_async_wait_all() then a block barrier makes the tile visible
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace tbvh
