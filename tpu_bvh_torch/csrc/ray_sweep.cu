// General-ray sweep: closest (or any) hits of arbitrary rays over a
// per-group treelet pair list, by Plücker dot products.
//
// Replaces the TPU kernel tpu_bvh/ops/ray_sweep.py:_trace_impl (_kernel),
// which walks (4096-ray group, treelet) pairs and sweeps each live
// 256-ray subgroup as one [10, 6L] x [10, 256] MXU contraction with a
// bf16 hi/lo split, against the feature rows F = [d, o x d, o, 1].
//
// Design: B4's (raster.cu). One block per (group, subgroup), 256 threads,
// one ray per thread, in plain f32. The block walks its group's pairs in
// list order. A pair is swept when the subgroup's cull bit is set and its
// entry bound p_tlb is below the subgroup's bound tmax_s, which starts at
// the subgroup's largest ray tmax and becomes max over rays of
// min(best t, ray tmax) after each sweep (a block reduction), exactly the
// TPU kernel's skip rule, so the per-ray sweep counts agree. A sweep
// stages the treelet's L prims (32 floats each: the nonzero coefficients
// of u, v, w, den and t, and the prim id bits) in shared memory, and each
// thread tests all L:
//   ok = u*den > 0 && v*den > 0 && w*den > 0 && t*den > 0,
//   t = t_num * (1/den), a hit when tmin < t < tmax,
// keeping the smallest row on an exact t tie; across pairs a strict <
// keeps the earlier pair. In occlusion mode any hit writes t = 0 and
// prim = 0 (no winner extraction), so a fully occluded subgroup's bound
// drops to 0 and its later pairs are skipped. Every block writes all its
// rays. Dot products are __fmul_rn/__fadd_rn left to right (no FMA) and
// division is IEEE, so the result equals the plain PyTorch version bit
// for bit.
//
// Bound on the card: f32 instruction rate. A ray-prim test is 24
// multiplies and 20 adds for the five dot products, 4 multiplies for the
// test, one division and one multiply for t: 50 flops, all from
// registers or a shared-memory broadcast; memory traffic is one treelet
// slab (L * 128 bytes) per sweep and 11 floats in, 5 words out per ray.
// Later work: several rays per thread, skipping a dead pair without a
// block barrier, tensor-core planes.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kSub = 16;             // subgroups per group
constexpr int kRays = 256;           // rays per subgroup
constexpr int kRpg = kSub * kRays;   // rays per group
constexpr int kPrimF4 = 8;           // float4 per prim (32 floats)

struct Ray {
  float d0, d1, d2, m0, m1, m2, o0, o1, o2, tmax, tmin;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// c0*d0 + c1*d1 + c2*d2 + c3*m0 + c4*m1 + c5*m2, left to right
__device__ __forceinline__ float dot6(float c0, float c1, float c2, float c3, float c4, float c5,
                                      const Ray& r) {
  float a = add(mul(c0, r.d0), mul(c1, r.d1));
  a = add(a, mul(c2, r.d2));
  a = add(a, mul(c3, r.m0));
  a = add(a, mul(c4, r.m1));
  return add(a, mul(c5, r.m2));
}

struct Test {
  float un, vn, inv, t;
};

// Plücker test of one prim (8 float4: u 0-5 | v 6-11 | w 12-17 | den 18-20 |
// t_num 21-23 and its constant 24 | prim id bits 25 | zeros).
__device__ __forceinline__ Test plucker(const float4* p, const Ray& r) {
  float4 a = p[0], b = p[1], c = p[2], e = p[3], g = p[4], h = p[5], k = p[6];
  Test out;
  out.un = dot6(a.x, a.y, a.z, a.w, b.x, b.y, r);
  out.vn = dot6(b.z, b.w, c.x, c.y, c.z, c.w, r);
  float wn = dot6(e.x, e.y, e.z, e.w, g.x, g.y, r);
  float den = add(add(mul(g.z, r.d0), mul(g.w, r.d1)), mul(h.x, r.d2));
  float tn = add(add(add(mul(h.y, r.o0), mul(h.z, r.o1)), mul(h.w, r.o2)), k.x);
  bool ok = (mul(out.un, den) > 0.f) && (mul(out.vn, den) > 0.f) && (mul(wn, den) > 0.f) &&
            (mul(tn, den) > 0.f);
  out.inv = 1.0f / (den != 0.f ? den : 1.0f);
  float t = ok ? mul(tn, out.inv) : kBig;
  out.t = (t > r.tmin && t < r.tmax) ? t : kBig;
  return out;
}

// max over the block of v; every thread gets the result
__device__ __forceinline__ float block_max(float v, float* s_red, float* s_out) {
  const int r = threadIdx.x;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((r & 31) == 0) s_red[r >> 5] = v;
  __syncthreads();
  if (r == 0) {
    float m = s_red[0];
    for (int w = 1; w < kRays / 32; ++w) m = fmaxf(m, s_red[w]);
    *s_out = m;
  }
  __syncthreads();
  return *s_out;
}

__global__ void __launch_bounds__(kRays)
ray_sweep_kernel(const float* __restrict__ feats, const float4* __restrict__ prims,
                 const int* __restrict__ p_tid, const float* __restrict__ p_tlb,
                 const int* __restrict__ p_bits, const int* __restrict__ t_start,
                 const int* __restrict__ t_end, int L, int occlusion,
                 float* __restrict__ out_t, int* __restrict__ out_p,
                 float* __restrict__ out_u, float* __restrict__ out_v,
                 int* __restrict__ out_c) {
  extern __shared__ float4 slab[];  // [L * 8]
  __shared__ float s_tmax;
  __shared__ float s_red[kRays / 32];

  const int g = blockIdx.x / kSub;
  const int s = blockIdx.x % kSub;
  const int q = s * kRays + threadIdx.x;  // ray within the group (sorted order)
  const float* f = feats + (size_t)g * 11 * kRpg + q;
  Ray ray;
  ray.d0 = f[0 * kRpg]; ray.d1 = f[1 * kRpg]; ray.d2 = f[2 * kRpg];
  ray.m0 = f[3 * kRpg]; ray.m1 = f[4 * kRpg]; ray.m2 = f[5 * kRpg];
  ray.o0 = f[6 * kRpg]; ray.o1 = f[7 * kRpg]; ray.o2 = f[8 * kRpg];
  ray.tmax = f[9 * kRpg]; ray.tmin = f[10 * kRpg];

  float best_t = kBig, best_u = 0.f, best_v = 0.f;
  int best_p = -1, count = 0;
  // the subgroup's bound starts at its farthest ray reach
  float tmax_s = block_max(ray.tmax, s_red, &s_tmax);

  const int k1 = t_end[g];
  for (int k = t_start[g]; k < k1; ++k) {
    // block-uniform skip: cull bit, then the subgroup's bound
    if (!((p_bits[k] >> s) & 1)) continue;
    if (!(p_tlb[k] < tmax_s)) continue;
    count += L;
    const float4* src = prims + (size_t)p_tid[k] * L * kPrimF4;
    for (int e = threadIdx.x; e < L * kPrimF4; e += kRays) slab[e] = src[e];
    __syncthreads();

    if (occlusion) {
      bool hit = false;
      for (int l = 0; l < L && !hit; ++l) hit = plucker(slab + kPrimF4 * l, ray).t < kBig;
      if (hit) {
        best_t = 0.f;
        best_p = 0;
      }
    } else {
      float bt = kBig;
      int bl = 0;
      for (int l = 0; l < L; ++l) {
        float t = plucker(slab + kPrimF4 * l, ray).t;
        if (t < bt) {  // strict: the smallest row wins an exact tie
          bt = t;
          bl = l;
        }
      }
      if (bt < best_t) {  // strict: the earlier pair wins an exact tie
        Test w = plucker(slab + kPrimF4 * bl, ray);
        best_t = bt;
        best_u = mul(w.un, w.inv);
        best_v = mul(w.vn, w.inv);
        best_p = __float_as_int(slab[kPrimF4 * bl + 6].y);
      }
    }
    // the barriers inside also keep the slab until every thread is done
    tmax_s = block_max(fminf(best_t, ray.tmax), s_red, &s_tmax);
  }

  const size_t o = (size_t)g * kRpg + q;
  out_t[o] = best_t;
  out_p[o] = best_p;
  out_u[o] = best_u;
  out_v[o] = best_v;
  out_c[o] = count;
}

}  // namespace

extern "C" int tbvh_ray_sweep(const float* feats, const float* prims, const int* p_tid,
                              const float* p_tlb, const int* p_bits, const int* t_start,
                              const int* t_end, int n_groups, int L, int occlusion,
                              float* out_t, int* out_p, float* out_u, float* out_v, int* out_c,
                              cudaStream_t stream) {
  size_t smem = (size_t)L * kPrimF4 * sizeof(float4);
  ray_sweep_kernel<<<n_groups * kSub, kRays, smem, stream>>>(
      feats, reinterpret_cast<const float4*>(prims), p_tid, p_tlb, p_bits, t_start, t_end, L,
      occlusion, out_t, out_p, out_u, out_v, out_c);
  return (int)cudaGetLastError();
}
