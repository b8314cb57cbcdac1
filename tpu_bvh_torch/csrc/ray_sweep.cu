// General-ray sweep: closest (or any) hits of arbitrary rays over a
// per-group treelet pair list, by Plücker dot products.
//
// Replaces the TPU kernel tpu_bvh/ops/ray_sweep.py:_trace_impl (_kernel),
// which walks (4096-ray group, treelet) pairs and sweeps each live
// 256-ray subgroup as one [10, 6L] x [10, 256] MXU contraction with a
// bf16 hi/lo split, against the feature rows F = [d, o x d, o, 1].
//
// The serial schedule (the plain version, ray_sweep_reference): subgroup s
// of group g walks the group's pairs in order and sweeps pair k when its
// cull bit s is set and p_tlb[k] < tmax_s; tmax_s starts at the largest
// ray tmax and is max over rays of min(best t, ray tmax) after each sweep.
// A sweep tests the subgroup's 256 rays against the treelet's L prims
// (32 floats each: the nonzero coefficients of u, v, w, den and t, and the
// prim id bits):
//   ok = u*den > 0 && v*den > 0 && w*den > 0 && t*den > 0,
//   t = t_num * (1/den), a hit when tmin < t < tmax,
// the smallest row winning an exact t tie within a pair and the earlier
// pair across pairs; occlusion mode writes t = 0 and prim = 0 on any hit.
//
// Why the pair list splits exactly. Within a group p_tlb does not fall
// (_compact_pairs sorts by entry bound; padding is BIG with no bits) and
// tmax_s does not rise, so the swept pairs are the pairs with bit s in
// [t_start, K), and every later pair is skipped. Per ray the test
// "p_tlb[k] >= min(tmax, best so far)" flips once, so K = max over rays of
// k_r, the first of these events: the first pair with p_tlb >= tmax; after
// the subgroup's first pair with its bit (once best starts at BIG), the
// first pair with p_tlb >= BIG; after each hit of value b at pair j (t, or
// 0 in occlusion mode), the first pair after j with p_tlb >= b. Events
// from any pair with the bit are upper bounds of k_r, so a block may stop
// at a pair once it is at or above max over rays of the events found so
// far, and every pair below K is swept by some block. The winner is the
// least key (t, pair k, row l) over the hits of pairs below K: the serial
// tie rule. A block may have swept pairs at or above K; a hit there has
// t >= p_tlb[k] >= the ray's final bound in exact arithmetic, so it cannot
// win, but rounding may let it, so the finish pass checks that the least
// key's pair lies below K and otherwise re-sweeps the subgroup serially
// over [t_start, K) (counted in stats[2]). In occlusion mode the key's t
// is 0, so the least key is the ray's first hit pair and needs no check.
//
// Design: three launches.
//   rs_init   one block per subgroup: each ray's first event from tmax and
//             BIG (binary search over p_tlb), key = all ones, the
//             subgroup's stop bound usub = max of those; one more block
//             plans the work: (subgroup, chunk of kChunk pair slots) items
//             in chunk-major order (every subgroup's chunk 0, then every
//             chunk 1, groups with more chunks first), as a level table.
//   rs_sweep  a persistent grid draws items from an atomic ticket. Per
//             pair with its bit and below the bound it stages the slab,
//             tests 256 rays x L prims in the written order (__fmul_rn /
//             __fadd_rn, IEEE division), keeps each ray's least key and
//             atomicMins its event (binary search over p_tlb), then
//             rereads the bound (block max over the subgroup's events).
//   rs_finish one block per subgroup: K, count = L x pairs with its bit in
//             [t_start, K), and t, prim, u, v of the winner recomputed by
//             one Plücker test in the same order, so every output equals
//             the plain version bit for bit.
// The 64-bit key is (order-preserving bits of t, k < 2^23, l < 512).
//
// Bound on the card: f32 instruction rate. A ray-prim test is 24
// multiplies and 20 adds for the five dot products, 4 multiplies for the
// test, one division and one multiply for t: 50 flops. Scratch: 12 B per
// ray (key, event), 4 B per subgroup, 8 B per group, 4 B per chunk level.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kSub = 16;             // subgroups per group
constexpr int kRays = 256;           // rays per subgroup
constexpr int kRpg = kSub * kRays;   // rays per group
constexpr int kPrimF4 = 8;           // float4 per prim (32 floats)
constexpr int kWarps = kRays / 32;
constexpr int kChunk = 8;            // pair slots per work item
constexpr int kSmSlots = 1024;       // per-SM counters in stats
constexpr int kStats = 4;            // stats words before the per-SM counters
constexpr uint64_t kNoKey = ~0ull;

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

__device__ __forceinline__ Ray load_ray(const float* feats, int g, int q) {
  const float* f = feats + (size_t)g * 11 * kRpg + q;
  Ray ray;
  ray.d0 = f[0 * kRpg]; ray.d1 = f[1 * kRpg]; ray.d2 = f[2 * kRpg];
  ray.m0 = f[3 * kRpg]; ray.m1 = f[4 * kRpg]; ray.m2 = f[5 * kRpg];
  ray.o0 = f[6 * kRpg]; ray.o1 = f[7 * kRpg]; ray.o2 = f[8 * kRpg];
  ray.tmax = f[9 * kRpg]; ray.tmin = f[10 * kRpg];
  return ray;
}

// first k in [lo, hi) with !(p_tlb[k] < v), else hi; the predicate does
// not flip back over a group's sorted entry bounds
__device__ __forceinline__ int first_not_below(const float* p_tlb, int lo, int hi, float v) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (p_tlb[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// (t, k, l) in one word whose unsigned order is the serial tie rule; -0.0
// and +0.0 compare equal there, so both map to +0.0
__device__ __forceinline__ uint64_t make_key(float t, int k, int l) {
  unsigned b = __float_as_uint(t == 0.f ? 0.f : t);
  b ^= (b >> 31) ? 0xffffffffu : 0x80000000u;
  return ((uint64_t)b << 32) | ((uint64_t)k << 9) | (uint64_t)l;
}
__device__ __forceinline__ int key_pair(uint64_t key) { return (int)((key >> 9) & 0x7fffff); }
__device__ __forceinline__ int key_row(uint64_t key) { return (int)(key & 511); }

// block-wide reductions over kRays threads; `red` holds kWarps ints and
// one more for the result; every thread gets it
template <bool kMax>
__device__ __forceinline__ int block_reduce(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const int w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? max(v, w) : v + w;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = red[0];
    for (int w = 1; w < kWarps; ++w) m = kMax ? max(m, red[w]) : m + red[w];
    red[kWarps] = m;
  }
  __syncthreads();
  return red[kWarps];
}

// exclusive scan over the block; sets *total (every thread)
__device__ __forceinline__ int block_excl_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = red[w];
      red[w] = s;
      s += c;
    }
    red[kWarps] = s;
  }
  __syncthreads();
  const int out = red[warp] + x - v;
  *total = red[kWarps];
  __syncthreads();
  return out;
}

__device__ __forceinline__ void stage(float4* slab, const float4* prims, int tid, int L) {
  const float4* src = prims + (size_t)tid * L * kPrimF4;
  for (int e = threadIdx.x; e < L * kPrimF4; e += kRays) slab[e] = src[e];
}

// Scratch (int words): ev [CT * 4096] | usub [CT * 16] | nch [CT] |
// order [CT] | ctl [4]: ticket, items, levels, - | off [levels + 1]
struct Scratch {
  int *ev, *usub, *nch, *order, *ctl, *off;
  __host__ __device__ Scratch(int* base, int n_ct) {
    ev = base;
    usub = ev + (size_t)n_ct * kRpg;
    nch = usub + n_ct * kSub;
    order = nch + n_ct;
    ctl = order + n_ct;
    off = ctl + 4;
  }
};

// the work plan (one block): chunks per group, groups by chunk count
// (descending, then index), and the item offset of every chunk level
__device__ void plan(const int* t_start, const int* t_end, int n_ct, Scratch sc,
                     long long* stats, int* red) {
  int m = 0;
  for (int g = threadIdx.x; g < n_ct; g += kRays) {
    const int len = t_end[g] - t_start[g];
    const int n = len > 0 ? (len + kChunk - 1) / kChunk : 0;
    sc.nch[g] = n;
    m = max(m, n);
  }
  const int levels = block_reduce<true>(m, red);  // its barriers publish nch
  for (int g = threadIdx.x; g < n_ct; g += kRays) {
    const int n = sc.nch[g];
    int r = 0;
    for (int h = 0; h < n_ct; ++h) {
      const int o = sc.nch[h];
      r += (o > n) || (o == n && h < g);
    }
    sc.order[r] = g;
  }
  for (int i = threadIdx.x; i < kStats + kSmSlots; i += kRays) stats[i] = 0;
  __syncthreads();
  int carry = 0;
  for (int c0 = 0; c0 < levels; c0 += kRays) {
    const int c = c0 + threadIdx.x;
    int n_c = 0;  // groups with more than c chunks: a prefix of `order`
    if (c < levels) {
      int lo = 0, hi = n_ct;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sc.nch[sc.order[mid]] > c) lo = mid + 1;
        else hi = mid;
      }
      n_c = lo;
    }
    int total;
    const int ex = block_excl_scan(kSub * n_c, red, &total);
    if (c < levels) sc.off[c] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) {
    sc.off[levels] = carry;
    sc.ctl[0] = 0;  // the ticket
    sc.ctl[1] = carry;
    sc.ctl[2] = levels;
  }
}

__global__ void __launch_bounds__(kRays)
rs_init(const float* __restrict__ feats, const float* __restrict__ p_tlb,
        const int* __restrict__ p_bits, const int* __restrict__ t_start,
        const int* __restrict__ t_end, int n_ct, unsigned long long* __restrict__ keys,
        int* __restrict__ scratch, long long* __restrict__ stats) {
  __shared__ int red[kWarps + 1];
  Scratch sc(scratch, n_ct);
  if (blockIdx.x == (unsigned)(n_ct * kSub)) {
    plan(t_start, t_end, n_ct, sc, stats, red);
    return;
  }
  const int g = blockIdx.x / kSub, s = blockIdx.x % kSub;
  const int q = s * kRays + threadIdx.x;
  const int ts = t_start[g], te = t_end[g];
  const float tmax = feats[((size_t)g * 11 + 9) * kRpg + q];
  int k0 = te;  // the subgroup's first pair with its bit
  for (int k = ts + threadIdx.x; k < te; k += kRays) {
    if ((p_bits[k] >> s) & 1) {
      k0 = k;
      break;
    }
  }
  k0 = -block_reduce<true>(-k0, red);
  int e = first_not_below(p_tlb, ts, te, tmax);
  if (k0 < te) e = min(e, first_not_below(p_tlb, k0 + 1, te, kBig));
  const size_t o = (size_t)g * kRpg + q;
  sc.ev[o] = e;
  keys[o] = kNoKey;
  const int u = block_reduce<true>(e, red);
  if (threadIdx.x == 0) sc.usub[blockIdx.x] = u;
}

__global__ void __launch_bounds__(kRays)
rs_sweep(const float* __restrict__ feats, const float4* __restrict__ prims,
         const int* __restrict__ p_tid, const float* __restrict__ p_tlb,
         const int* __restrict__ p_bits, const int* __restrict__ t_start,
         const int* __restrict__ t_end, int n_ct, int L, int occlusion,
         unsigned long long* __restrict__ keys, int* __restrict__ scratch,
         long long* __restrict__ stats) {
  extern __shared__ float4 slab[];  // [L * 8]
  __shared__ int red[kWarps + 3];   // reductions | item | bound
  Scratch sc(scratch, n_ct);
  volatile int* ev = sc.ev;
  const int n_items = sc.ctl[1], levels = sc.ctl[2];
  unsigned smid;
  asm("mov.u32 %0, %%smid;" : "=r"(smid));
  for (;;) {
    if (threadIdx.x == 0) red[kWarps + 1] = atomicAdd(&sc.ctl[0], 1);
    __syncthreads();
    const int item = red[kWarps + 1];
    if (item >= n_items) return;
    // decode: the level c with off[c] <= item < off[c + 1], then the group
    // and subgroup within it
    int lo = 0, hi = levels;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (sc.off[mid] <= item) lo = mid;
      else hi = mid;
    }
    const int idx = item - sc.off[lo];
    const int g = sc.order[idx / kSub], s = idx % kSub;
    const int sg = g * kSub + s;
    const int te = t_end[g];
    const int a = t_start[g] + lo * kChunk, b = min(a + kChunk, te);
    if (threadIdx.x == 0) red[kWarps + 2] = ((volatile int*)sc.usub)[sg];
    __syncthreads();
    int bound = red[kWarps + 2];  // block-uniform
    if (a >= bound) {
      __syncthreads();  // red is rewritten by the next draw
      continue;
    }
    const int q = s * kRays + threadIdx.x;
    const size_t o = (size_t)g * kRpg + q;
    const Ray ray = load_ray(feats, g, q);
    int my_ev = ev[o];
    uint64_t my_key = kNoKey;
    // occlusion: a ray whose first hit lies before this chunk is done (no
    // key reads as pair 2^23 - 1)
    bool active = !occlusion || key_pair(((volatile unsigned long long*)keys)[o]) >= a;
    int swept = 0;
    for (int k = a; k < b; ++k) {
      if (!((p_bits[k] >> s) & 1)) continue;
      if (k >= bound) break;
      stage(slab, prims, p_tid[k], L);
      __syncthreads();
      if (occlusion) {
        if (active) {
          bool hit = false;
          for (int l = 0; l < L && !hit; ++l) hit = plucker(slab + kPrimF4 * l, ray).t < kBig;
          if (hit) {
            my_key = make_key(0.f, k, 0);
            active = false;  // its later hits neither win nor bring an earlier event
            const int e = first_not_below(p_tlb, k + 1, te, 0.f);
            if (e < my_ev) {
              atomicMin((int*)sc.ev + o, e);
              my_ev = e;
            }
          }
        }
      } else {
        float bt = kBig;
        int bl = 0;
        for (int l = 0; l < L; ++l) {
          const float t = plucker(slab + kPrimF4 * l, ray).t;
          if (t < bt) {  // strict: the smallest row wins an exact tie
            bt = t;
            bl = l;
          }
        }
        if (bt < kBig) {
          const uint64_t key = make_key(bt, k, bl);
          if (key < my_key) my_key = key;
          const int e = first_not_below(p_tlb, k + 1, te, bt);
          if (e < my_ev) {
            atomicMin((int*)sc.ev + o, e);
            my_ev = e;
          }
        }
      }
      ++swept;
      // the barriers inside also keep the slab until every thread is done
      bound = min(bound, block_reduce<true>(min(my_ev, ev[o]), red));
    }
    if (my_key != kNoKey) atomicMin(keys + o, (unsigned long long)my_key);
    if (threadIdx.x == 0 && swept > 0) {
      atomicMin(sc.usub + sg, bound);
      atomicAdd((unsigned long long*)stats, (unsigned long long)swept * kRays * L);
      atomicAdd((unsigned long long*)stats + 1, (unsigned long long)swept);
      atomicAdd((unsigned long long*)stats + kStats + (smid & (kSmSlots - 1)),
                (unsigned long long)swept);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kRays)
rs_finish(const float* __restrict__ feats, const float4* __restrict__ prims,
          const int* __restrict__ p_tid, const int* __restrict__ p_bits,
          const int* __restrict__ t_start, int n_ct, int L, int occlusion,
          const unsigned long long* __restrict__ keys, int* __restrict__ scratch,
          long long* __restrict__ stats, float* __restrict__ out_t, int* __restrict__ out_p,
          float* __restrict__ out_u, float* __restrict__ out_v, int* __restrict__ out_c) {
  extern __shared__ float4 slab[];  // [L * 8], for a re-sweep only
  __shared__ int red[kWarps + 1];
  Scratch sc(scratch, n_ct);
  const int g = blockIdx.x / kSub, s = blockIdx.x % kSub;
  const int q = s * kRays + threadIdx.x;
  const size_t o = (size_t)g * kRpg + q;
  const int ts = t_start[g];
  const int K = block_reduce<true>(sc.ev[o], red);
  int n = 0;
  for (int k = ts + threadIdx.x; k < K; k += kRays) n += (p_bits[k] >> s) & 1;
  n = block_reduce<false>(n, red);
  const uint64_t key = keys[o];
  const bool hit = key != kNoKey && key_pair(key) < K;
  const bool stray = !occlusion && key != kNoKey && !hit;
  float best_t = kBig, best_u = 0.f, best_v = 0.f;
  int best_p = -1;
  const Ray ray = load_ray(feats, g, q);
  if (__syncthreads_or(stray)) {
    // a least key from a pair at or above K: sweep [t_start, K) serially
    for (int k = ts; k < K; ++k) {
      if (!((p_bits[k] >> s) & 1)) continue;
      stage(slab, prims, p_tid[k], L);
      __syncthreads();
      float bt = kBig;
      int bl = 0;
      for (int l = 0; l < L; ++l) {
        const float t = plucker(slab + kPrimF4 * l, ray).t;
        if (t < bt) {
          bt = t;
          bl = l;
        }
      }
      if (bt < best_t) {
        Test w = plucker(slab + kPrimF4 * bl, ray);
        best_t = bt;
        best_u = mul(w.un, w.inv);
        best_v = mul(w.vn, w.inv);
        best_p = __float_as_int(slab[kPrimF4 * bl + 6].y);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      atomicAdd((unsigned long long*)stats, (unsigned long long)n * kRays * L);
      atomicAdd((unsigned long long*)stats + 2, 1ull);
    }
  } else if (hit && occlusion) {
    best_t = 0.f;
    best_p = 0;
  } else if (hit) {
    const float4* p = prims + ((size_t)p_tid[key_pair(key)] * L + key_row(key)) * kPrimF4;
    Test w = plucker(p, ray);
    best_t = w.t;
    best_u = mul(w.un, w.inv);
    best_v = mul(w.vn, w.inv);
    best_p = __float_as_int(p[6].y);
  }
  out_t[o] = best_t;
  out_p[o] = best_p;
  out_u[o] = best_u;
  out_v[o] = best_v;
  out_c[o] = n * L;
}

}  // namespace

// scratch: CT * (4096 + 18) + 4 + levels + 1 ints, levels >= ceil(P / kChunk);
// keys: CT * 4096 u64; stats: kStats + kSmSlots i64 (tests run, pair
// sweeps, re-swept subgroups, -, then pair sweeps per SM)
extern "C" int tbvh_ray_sweep(const float* feats, const float* prims, const int* p_tid,
                              const float* p_tlb, const int* p_bits, const int* t_start,
                              const int* t_end, int n_groups, int P, int L, int occlusion,
                              float* out_t, int* out_p, float* out_u, float* out_v, int* out_c,
                              void* keys, int* scratch, long long* stats, cudaStream_t stream) {
  const float4* pr = reinterpret_cast<const float4*>(prims);
  unsigned long long* k64 = reinterpret_cast<unsigned long long*>(keys);
  const int n_sub = n_groups * kSub;
  const size_t smem = (size_t)L * kPrimF4 * sizeof(float4);
  rs_init<<<n_sub + 1, kRays, 0, stream>>>(feats, p_tlb, p_bits, t_start, t_end, n_groups, k64,
                                           scratch, stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rs_sweep, kRays, smem)) !=
      cudaSuccess)
    return (int)e;
  // at most sum over groups of ceil(len / kChunk) <= P / kChunk + CT items a subgroup
  const long long most = (long long)kSub * (P / kChunk + 1 + n_groups);
  const int grid = (int)(most < (long long)sms * per_sm ? most : (long long)sms * per_sm);
  rs_sweep<<<grid > 0 ? grid : 1, kRays, smem, stream>>>(feats, pr, p_tid, p_tlb, p_bits, t_start,
                                                        t_end, n_groups, L, occlusion, k64,
                                                        scratch, stats);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  rs_finish<<<n_sub, kRays, smem, stream>>>(feats, pr, p_tid, p_bits, t_start, n_groups, L,
                                            occlusion, k64, scratch, stats, out_t, out_p, out_u,
                                            out_v, out_c);
  return (int)cudaGetLastError();
}
