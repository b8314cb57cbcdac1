// Raster sweep: closest primary-ray hits over a per-tile treelet pair list.
//
// Replaces the TPU kernel tpu_bvh/ops/raster_tpu.py:_render_tpu_impl
// (_kernel), which walks (64x64 coarse tile, treelet) pairs front to back
// and sweeps each live 16x16 subtile as one [4, 6L] x [4, 256] MXU
// contraction with a bf16 hi/lo split.
//
// Design: one block per (coarse tile, subtile), 256 threads, one ray per
// thread, in plain f32. The block walks its tile's pairs in list order
// (front to back by conservative entry t). A pair is swept only when the
// subtile's cull bit is set and its entry bound p_tlb is below the
// subtile's running max hit t (block reduction after every sweep), exactly
// the TPU kernel's skip rule, so the per-ray sweep counts agree. A sweep
// stages the treelet's L prims (16 floats each: Möller cu, cv, cw, cden,
// t0, prim id bits) in shared memory and every thread tests all L:
//   ok = u*den > 0 && v*den > 0 && w*den > 0 && t*den > 0,  t = t_num * (1/den)
// keeping the smallest row on an exact t tie; across pairs a strict < keeps
// the earlier pair. Each block writes all its outputs, so tiles with no
// pairs read as misses. Sums are written as __fmul_rn/__fadd_rn (no FMA)
// and division is IEEE, so the result equals the plain PyTorch version
// bit for bit.
//
// Bound on the card: f32 instruction rate (26 flops per ray-prim test:
// 12 multiplies and 8 adds for the four dot products, 4 multiplies for the
// test, one division and one multiply for t; all operands from registers
// or a shared-memory broadcast); memory traffic is one treelet slab per
// sweep. Later work: tensor-core planes,
// several rays per thread, skipping dead pairs without a block barrier.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kSub = 16;         // subtiles per coarse tile
constexpr int kRays = 256;       // rays per subtile (16x16)
constexpr int kRpc = kSub * kRays;  // rays per coarse tile (64x64)

__device__ __forceinline__ float dot3(float a, float b, float c, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

struct Test {
  float un, vn, den, t;
};

// Möller test of one prim (4 float4: cu.xyz cv.x | cv.yz cw.xy | cw.z cden.xyz | t0 pid - -)
__device__ __forceinline__ Test moller(const float4* p, float dx, float dy, float dz) {
  float4 a = p[0], b = p[1], c = p[2], e = p[3];
  Test r;
  r.un = dot3(a.x, a.y, a.z, dx, dy, dz);
  r.vn = dot3(a.w, b.x, b.y, dx, dy, dz);
  float wn = dot3(b.z, b.w, c.x, dx, dy, dz);
  r.den = dot3(c.y, c.z, c.w, dx, dy, dz);
  float tn = e.x;
  bool ok = (r.un * r.den > 0.f) && (r.vn * r.den > 0.f) && (wn * r.den > 0.f) &&
            (tn * r.den > 0.f);
  float inv = 1.0f / (r.den != 0.f ? r.den : 1.0f);
  r.den = inv;  // callers want 1/den from here on
  r.t = ok ? tn * inv : kBig;
  return r;
}

__global__ void __launch_bounds__(kRays)
raster_sweep_kernel(const float* __restrict__ dirs, const float4* __restrict__ prims,
                    const int* __restrict__ p_tid, const float* __restrict__ p_tlb,
                    const int* __restrict__ p_bits, const int* __restrict__ t_start,
                    const int* __restrict__ t_end, int L, float* __restrict__ out_t,
                    int* __restrict__ out_p, float* __restrict__ out_u,
                    float* __restrict__ out_v, int* __restrict__ out_c) {
  extern __shared__ float4 slab[];  // [L * 4]
  __shared__ float s_tmax;
  __shared__ float s_red[kRays / 32];

  const int ct = blockIdx.x / kSub;
  const int s = blockIdx.x % kSub;
  const int r = threadIdx.x;
  const int q = s * kRays + r;  // ray within the coarse tile
  const float* d = dirs + (size_t)ct * 3 * kRpc;
  const float dx = d[q], dy = d[kRpc + q], dz = d[2 * kRpc + q];

  float best_t = kBig, best_u = 0.f, best_v = 0.f;
  int best_p = -1, count = 0;
  if (r == 0) s_tmax = kBig;
  __syncthreads();

  const int k1 = t_end[ct];
  for (int k = t_start[ct]; k < k1; ++k) {
    // block-uniform skip: cull bit, then occlusion by the subtile's max t
    if (!((p_bits[k] >> s) & 1)) continue;
    if (!(p_tlb[k] < s_tmax)) continue;
    count += L;
    const float4* src = prims + (size_t)p_tid[k] * L * 4;
    for (int e = r; e < L * 4; e += kRays) slab[e] = src[e];
    __syncthreads();

    float bt = kBig;
    int bl = 0;
    for (int l = 0; l < L; ++l) {
      float t = moller(slab + 4 * l, dx, dy, dz).t;
      if (t < bt) {  // strict: the smallest row wins an exact tie
        bt = t;
        bl = l;
      }
    }
    if (bt < best_t) {  // strict: the earlier pair wins an exact tie
      Test w = moller(slab + 4 * bl, dx, dy, dz);
      best_t = bt;
      best_u = w.un * w.den;
      best_v = w.vn * w.den;
      best_p = __float_as_int(slab[4 * bl + 3].y);
    }

    float mx = best_t;
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if ((r & 31) == 0) s_red[r >> 5] = mx;
    __syncthreads();
    if (r == 0) {
      float m2 = s_red[0];
      for (int w = 1; w < kRays / 32; ++w) m2 = fmaxf(m2, s_red[w]);
      s_tmax = m2;
    }
    __syncthreads();
  }

  const size_t o = (size_t)ct * kRpc + q;
  out_t[o] = best_t;
  out_p[o] = best_p;
  out_u[o] = best_u;
  out_v[o] = best_v;
  out_c[o] = count;
}

}  // namespace

extern "C" int tbvh_raster_sweep(const float* dirs, const float* prims, const int* p_tid,
                                 const float* p_tlb, const int* p_bits, const int* t_start,
                                 const int* t_end, int n_ct, int L, float* out_t, int* out_p,
                                 float* out_u, float* out_v, int* out_c, cudaStream_t stream) {
  size_t smem = (size_t)L * 16 * sizeof(float);
  raster_sweep_kernel<<<n_ct * kSub, kRays, smem, stream>>>(
      dirs, reinterpret_cast<const float4*>(prims), p_tid, p_tlb, p_bits, t_start, t_end, L,
      out_t, out_p, out_u, out_v, out_c);
  return (int)cudaGetLastError();
}
