// Raster sweep: closest primary-ray hits over a per-tile treelet pair list,
// each tile's list split across the SMs.
//
// Replaces the TPU kernel tpu_bvh/ops/raster_tpu.py:_render_tpu_impl
// (_kernel), which walks (64x64 coarse tile, treelet) pairs front to back
// and sweeps each live 16x16 subtile as one [4, 6L] x [4, 256] MXU
// contraction with a bf16 hi/lo split.
//
// The serial schedule (the plain version, raster_sweep_reference): subtile
// s of tile ct walks the tile's pairs in order and sweeps pair k when its
// cull bit s is set and p_tlb[k] < tmax_s, where tmax_s starts at BIG and
// is the max over the subtile's rays of their best t after each sweep. A
// sweep tests the subtile's 256 rays against the treelet's L prims (16
// floats each: Möller cu, cv, cw, cden, t0, prim id bits):
//   ok = u*den > 0 && v*den > 0 && w*den > 0 && t*den > 0,  t = t_num * (1/den),
// the smallest row winning an exact t tie within a pair and the earlier
// pair across pairs.
//
// Why the pair list splits exactly (the argument of csrc/ray_sweep.cu,
// simpler here: primary rays have no tmin or tmax). Within a tile p_tlb
// does not fall (_compact_pairs sorts by entry bound; padding is BIG with
// no bits) and tmax_s does not rise, so the swept pairs are the pairs with
// bit s in [t_start, K), and every later pair is skipped. Per ray the test
// "p_tlb[k] >= best so far" flips once, so K = max over rays of k_r, the
// first of these events: the first pair with p_tlb >= BIG; after each hit
// of value b at pair j, the first pair after j with p_tlb >= b. Events
// from any pair with the bit are upper bounds of k_r, so a block may stop
// at a pair once it is at or above the max over rays of the events found
// so far, and every pair below K is swept by some block. The winner is the
// least key (t, pair k, row l) over the hits of pairs below K: the serial
// tie rule. A hit at a pair at or above K has t >= p_tlb[k] >= the ray's
// final bound in exact arithmetic, so it cannot win, but rounding may let
// it, so the finish pass checks that the least key's pair lies below K and
// otherwise re-sweeps the subtile serially over [t_start, K) (counted in
// stats[2]).
//
// Design: three launches.
//   rt_init   one block per tile: every ray's first event e0 (the first
//             pair with p_tlb >= BIG), the subtiles' stop bounds, and, for
//             the subtiles with a pair below e0 (the others are never
//             swept), event = e0 and key = all ones per ray; one more
//             block plans the work: (subtile, chunk of kChunk pair slots)
//             items in chunk-major order (every subtile's chunk 0, then
//             every chunk 1, tiles with more chunks first), as a level
//             table.
//   rt_sweep  a persistent grid draws items from an atomic ticket. It
//             walks the item's pairs with the subtile's bit below the
//             bound, with two slabs in shared memory: while the block tests
//             one pair's treelet, cp.async brings the next pair's (the
//             level table and the tile's entry bounds are in shared memory
//             too, so a dead item costs a ticket and a few loads). It tests
//             256 rays x L prims in the written order (__fmul_rn /
//             __fadd_rn; the IEEE division only where the test holds: a
//             miss is BIG whatever 1/den is; a warp whose rays all fail
//             the u edge, or the u and v edges, skips the rest of the
//             test), keeps each ray's least key,
//             atomicMins its event (binary search over p_tlb), and rereads
//             the bound (block max over the subtile's events).
//   rt_finish one warp per subtile, every tile (tiles without pairs too,
//             so every output is written): K, count = L x pairs with the
//             bit in [t_start, K), and t, prim, u, v of the winner
//             recomputed by one Möller test in the same order, so every
//             output equals the plain version bit for bit.
// The 64-bit key is (order-preserving bits of t, k < 2^22, l < 1024).
//
// Bound on the card: f32 instruction rate (26 flops per ray-prim test:
// 12 multiplies and 8 adds for the four dot products, 4 multiplies for the
// test, one division and one multiply for t; all operands from registers
// or a shared-memory broadcast). Scratch: 12 B per ray (key, event; written
// only for the subtiles that are swept), 8 B per subtile, 12 B per tile,
// 12 B per chunk level.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kSub = 16;            // subtiles per coarse tile
constexpr int kRays = 256;          // rays per subtile (16x16)
constexpr int kRpc = kSub * kRays;  // rays per coarse tile (64x64)
constexpr int kPrimF4 = 4;          // float4 per prim (16 floats)
constexpr int kWarps = kRays / 32;
constexpr int kSmSlots = 1024;      // per-SM counters in stats
constexpr int kStats = 4;           // stats words before the per-SM counters
constexpr uint64_t kNoKey = ~0ull;
constexpr int kOffSmem = 2048;  // level-table entries a sweep block keeps in shared memory
constexpr int kTlbSmem = 1024;  // entry bounds of an item's tile kept in shared memory
// pair slots per work item (4 and 8 timed slower on the H100, PERF.md); raster_gpu.CHUNK
constexpr int kChunk = 2;

__device__ __forceinline__ float dot3(float a, float b, float c, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

struct Test {
  float un, vn, inv, t;
};

// Möller test of one prim (4 float4: cu.xyz cv.x | cv.yz cw.xy | cw.z cden.xyz | t0 pid - -)
__device__ __forceinline__ Test moller(const float4* p, float dx, float dy, float dz) {
  const float4 a = p[0], b = p[1], c = p[2], e = p[3];
  Test r;
  r.un = dot3(a.x, a.y, a.z, dx, dy, dz);
  r.vn = dot3(a.w, b.x, b.y, dx, dy, dz);
  const float wn = dot3(b.z, b.w, c.x, dx, dy, dz);
  const float den = dot3(c.y, c.z, c.w, dx, dy, dz);
  const float tn = e.x;
  const bool ok = (__fmul_rn(r.un, den) > 0.f) && (__fmul_rn(r.vn, den) > 0.f) &&
                  (__fmul_rn(wn, den) > 0.f) && (__fmul_rn(tn, den) > 0.f);
  r.inv = 1.0f / (den != 0.f ? den : 1.0f);
  r.t = ok ? __fmul_rn(tn, r.inv) : kBig;
  return r;
}

// the t of moller() for a whole warp (all 32 lanes present), with the
// division only where the test holds (ok implies den != 0, so 1/den is the
// same there); where no ray of the warp passes the u edge, or the u and v
// edges, the rest is skipped, as every ray's t is BIG then anyway
__device__ __forceinline__ float moller_t(const float4* p, float dx, float dy, float dz) {
  const unsigned full = 0xffffffffu;
  const float4 a = p[0], c = p[2];
  const float un = dot3(a.x, a.y, a.z, dx, dy, dz);
  const float den = dot3(c.y, c.z, c.w, dx, dy, dz);
  const bool pu = __fmul_rn(un, den) > 0.f;
  if (!__any_sync(full, pu)) return kBig;
  const float4 b = p[1], e = p[3];
  const float vn = dot3(a.w, b.x, b.y, dx, dy, dz);
  const bool pv = pu && __fmul_rn(vn, den) > 0.f;
  if (!__any_sync(full, pv)) return kBig;
  const float wn = dot3(b.z, b.w, c.x, dx, dy, dz);
  if (!(pv && __fmul_rn(wn, den) > 0.f && __fmul_rn(e.x, den) > 0.f)) return kBig;
  return __fmul_rn(e.x, 1.0f / den);
}

// first k in [lo, hi) with !(tlb[k - off] < v), else hi; the predicate
// does not flip back over a tile's sorted entry bounds
__device__ __forceinline__ int first_not_below(const float* tlb, int off, int lo, int hi,
                                               float v) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (tlb[mid - off] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// (t, k, l) in one word whose unsigned order is the serial tie rule; -0.0
// and +0.0 compare equal there, so both map to +0.0
__device__ __forceinline__ uint64_t make_key(float t, int k, int l) {
  unsigned b = __float_as_uint(t == 0.f ? 0.f : t);
  b ^= (b >> 31) ? 0xffffffffu : 0x80000000u;
  return ((uint64_t)b << 32) | ((uint64_t)k << 10) | (uint64_t)l;
}
__device__ __forceinline__ int key_pair(uint64_t key) { return (int)((key >> 10) & 0x3fffff); }
__device__ __forceinline__ int key_row(uint64_t key) { return (int)(key & 1023); }

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

// a treelet's slab (L prims, 64 B each) into shared memory, as one
// cp.async group per thread (16 B a copy, L2 only)
__device__ __forceinline__ void stage_async(float4* slab, const float4* prims, int tid, int L) {
  const float4* src = prims + (size_t)tid * L * kPrimF4;
  for (int e = threadIdx.x; e < L * kPrimF4; e += kRays) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(slab + e);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(__cvta_generic_to_global(src + e)));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Scratch (int words), lv = P / kChunk + 2 >= levels + 1: ev [CT * 4096] |
// usub [CT * 16] | state [CT * 16] | e0 [CT] | nch [CT] | order [CT] |
// ctl [4]: ticket, items, levels, - | off [lv] | hist [lv] | gt [lv].
// Only the subtiles with a pair below e0 (state 1) are swept, and only
// their rays have per-ray words (ev, and their keys); state 0 marks the
// others, whose outputs are misses.
struct Scratch {
  int *ev, *usub, *state, *e0, *nch, *order, *ctl, *off, *hist, *gt;
  __host__ __device__ Scratch(int* base, int n_ct, int lv) {
    ev = base;
    usub = ev + (size_t)n_ct * kRpc;
    state = usub + n_ct * kSub;
    e0 = state + n_ct * kSub;
    nch = e0 + n_ct;
    order = nch + n_ct;
    ctl = order + n_ct;
    off = ctl + 4;
    hist = off + lv;
    gt = hist + lv;
  }
};

// the work plan (one block): chunks per tile; the tiles ordered by chunk
// count, more chunks first (a counting sort: the order among tiles with
// equal counts is the atomics', and any such order is a valid plan); the
// item offset of every chunk level. Level c holds 16 items (one per
// subtile) for each of the gt[c] tiles with more than c chunks, which are
// order[0, gt[c]).
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
  for (int v = threadIdx.x; v <= levels; v += kRays) sc.hist[v] = 0;
  for (int i = threadIdx.x; i < kStats + kSmSlots; i += kRays) stats[i] = 0;
  __syncthreads();
  for (int g = threadIdx.x; g < n_ct; g += kRays) atomicAdd(&sc.hist[sc.nch[g]], 1);
  __syncthreads();
  int carry = 0;  // gt[v]: tiles with more than v chunks, a suffix sum of hist
  for (int top = levels; top >= 0; top -= kRays) {
    const int v = top - (int)threadIdx.x;
    int total;
    const int ex = block_excl_scan(v >= 0 ? sc.hist[v] : 0, red, &total);
    if (v >= 0) sc.gt[v] = carry + ex;
    carry += total;
  }
  for (int v = threadIdx.x; v <= levels; v += kRays) sc.hist[v] = 0;  // now the cursors
  __syncthreads();
  for (int g = threadIdx.x; g < n_ct; g += kRays) {
    const int n = sc.nch[g];
    sc.order[sc.gt[n] + atomicAdd(&sc.hist[n], 1)] = g;
  }
  carry = 0;
  for (int c0 = 0; c0 < levels; c0 += kRays) {
    const int c = c0 + threadIdx.x;
    int total;
    const int ex = block_excl_scan(c < levels ? kSub * sc.gt[c] : 0, red, &total);
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
rt_init(const float* __restrict__ p_tlb, const int* __restrict__ p_bits,
        const int* __restrict__ t_start,
        const int* __restrict__ t_end, int n_ct, int lv,
        unsigned long long* __restrict__ keys, int* __restrict__ scratch,
        long long* __restrict__ stats) {
  __shared__ int red[kWarps + 1];
  Scratch sc(scratch, n_ct, lv);
  if (blockIdx.x == (unsigned)n_ct) {
    plan(t_start, t_end, n_ct, sc, stats, red);
    return;
  }
  // one block per tile: every ray's first event, the first pair with
  // p_tlb >= BIG, found 256 pairs at a time, as each subtile's stop bound
  const int g = blockIdx.x;
  const int ts = t_start[g], te = t_end[g];
  int e = te;
  for (int k0 = ts; k0 < te; k0 += kRays) {
    const int k = k0 + threadIdx.x;
    const bool big = k < te && !(p_tlb[k] < kBig);
    if (__syncthreads_or(big)) {
      e = -block_reduce<true>(big ? -k : -te, red);
      break;
    }
  }
  // the subtiles that will be swept: those with a pair below e0
  int bits = 0;
  for (int k = ts + threadIdx.x; k < e; k += kRays) bits |= p_bits[k];
  for (int w = 16; w > 0; w >>= 1) bits |= __shfl_xor_sync(0xffffffffu, bits, w);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = bits;
  __syncthreads();
  bits = 0;
  for (int w = 0; w < kWarps; ++w) bits |= red[w];
  for (int q = threadIdx.x; q < kRpc; q += kRays) {
    if ((bits >> (q / kRays)) & 1) {
      sc.ev[(size_t)g * kRpc + q] = e;
      keys[(size_t)g * kRpc + q] = kNoKey;
    }
  }
  if (threadIdx.x < kSub) {
    sc.usub[g * kSub + threadIdx.x] = e;
    sc.state[g * kSub + threadIdx.x] = (bits >> threadIdx.x) & 1;
  }
  if (threadIdx.x == 0) sc.e0[g] = e;
}

__global__ void __launch_bounds__(kRays)
rt_sweep(const float* __restrict__ dirs, const float4* __restrict__ prims,
         const int* __restrict__ p_tid, const float* __restrict__ p_tlb,
         const int* __restrict__ p_bits, const int* __restrict__ t_start,
         const int* __restrict__ t_end, int n_ct, int L, int lv,
         unsigned long long* __restrict__ keys, int* __restrict__ scratch,
         long long* __restrict__ stats) {
  // two slabs of L * 4 float4, then the level table, then the entry
  // bounds of the item's tile
  extern __shared__ float4 slabs[];
  __shared__ int red[kWarps + 3];  // reductions | item | bound
  const int slab_f4 = L * kPrimF4;
  int* s_off = reinterpret_cast<int*>(slabs + 2 * slab_f4);
  float* s_tlb = reinterpret_cast<float*>(s_off + kOffSmem);
  Scratch sc(scratch, n_ct, lv);
  volatile int* ev = sc.ev;
  const int n_items = sc.ctl[1], levels = sc.ctl[2];
  const int* off = sc.off;
  if (levels < kOffSmem) {
    for (int c = threadIdx.x; c <= levels; c += kRays) s_off[c] = sc.off[c];
    off = s_off;
  }
  unsigned smid;
  asm("mov.u32 %0, %%smid;" : "=r"(smid));
  for (;;) {
    if (threadIdx.x == 0) red[kWarps + 1] = atomicAdd(&sc.ctl[0], 1);
    __syncthreads();  // also publishes s_off
    const int item = red[kWarps + 1];
    if (item >= n_items) return;
    // decode: the level c with off[c] <= item < off[c + 1], then the tile
    // and subtile within it
    int lo = 0, hi = levels;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (off[mid] <= item) lo = mid;
      else hi = mid;
    }
    const int idx = item - off[lo];
    const int g = sc.order[idx / kSub], s = idx % kSub;
    const int sg = g * kSub + s;
    const int ts = t_start[g], te = t_end[g];
    const int a = ts + lo * kChunk, b = min(a + kChunk, te);
    if (threadIdx.x == 0) red[kWarps + 2] = ((volatile int*)sc.usub)[sg];
    __syncthreads();
    int bound = red[kWarps + 2];  // block-uniform
    if (a >= bound) {
      __syncthreads();  // red is rewritten by the next draw
      continue;
    }
    // the tile's entry bounds, for the event searches (in shared memory
    // when they fit; the first barrier below publishes them)
    const bool win = te - ts <= kTlbSmem;
    if (win)
      for (int k = ts + threadIdx.x; k < te; k += kRays) s_tlb[k - ts] = p_tlb[k];
    const float* tlb = win ? s_tlb : p_tlb;
    const int toff = win ? ts : 0;
    const int q = s * kRays + threadIdx.x;
    const size_t o = (size_t)g * kRpc + q;
    const float* d = dirs + (size_t)g * 3 * kRpc;
    const float dx = d[q], dy = d[kRpc + q], dz = d[2 * kRpc + q];
    uint64_t my_key = kNoKey;
    int swept = 0, buf = 0;
    auto next = [&](int k) {  // the first pair in [k, b) with bit s, else b
      while (k < b && !((p_bits[k] >> s) & 1)) ++k;
      return k;
    };
    int k = next(a);
    // a pair with the bit below the bound: the subtile has per-ray words
    int my_ev = k < b && k < bound ? ev[o] : 0;
    if (k < b && k < bound) stage_async(slabs, prims, p_tid[k], L);
    while (k < b && k < bound) {
      const int kn = next(k + 1);
      const bool ahead = kn < b && kn < bound;
      if (ahead) stage_async(slabs + (buf ^ 1) * slab_f4, prims, p_tid[kn], L);
      if (ahead) wait_async<1>();
      else wait_async<0>();
      __syncthreads();
      const float4* slab = slabs + buf * slab_f4;
      float bt = kBig;
      int bl = 0;
#pragma unroll 4
      for (int l = 0; l < L; ++l) {
        const float t = moller_t(slab + kPrimF4 * l, dx, dy, dz);
        if (t < bt) {  // strict: the smallest row wins an exact tie
          bt = t;
          bl = l;
        }
      }
      if (bt < kBig) {
        const uint64_t key = make_key(bt, k, bl);
        if (key < my_key) my_key = key;
        const int e = first_not_below(tlb, toff, k + 1, te, bt);
        if (e < my_ev) {
          atomicMin((int*)sc.ev + o, e);
          my_ev = e;
        }
      }
      ++swept;
      // the barriers inside also keep this slab until every thread is done
      bound = min(bound, block_reduce<true>(min(my_ev, ev[o]), red));
      k = kn;
      buf ^= 1;
    }
    wait_async<0>();  // a slab brought ahead of a pair past the bound
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

// one warp per subtile (kRays / 32 rays a lane), no block barrier: the
// finish is a few dependent loads a ray, so it is latency that counts
constexpr int kFinWarps = 8;             // subtiles per finish block
constexpr int kPerLane = kRays / 32;     // rays a lane

__global__ void __launch_bounds__(kFinWarps * 32)
rt_finish(const float* __restrict__ dirs, const float4* __restrict__ prims,
          const int* __restrict__ p_tid, const int* __restrict__ p_bits,
          const int* __restrict__ t_start, int n_ct, int L, int lv,
          const unsigned long long* __restrict__ keys, int* __restrict__ scratch,
          long long* __restrict__ stats, float* __restrict__ out_t, int* __restrict__ out_p,
          float* __restrict__ out_u, float* __restrict__ out_v, int* __restrict__ out_c) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int sg = blockIdx.x * kFinWarps + (threadIdx.x >> 5);
  if (sg >= n_ct * kSub) return;
  Scratch sc(scratch, n_ct, lv);
  const int g = sg / kSub, s = sg % kSub;
  const int ts = t_start[g];
  const size_t o0 = (size_t)g * kRpc + s * kRays + lane;  // ray j of the lane at o0 + 32 j
  const float* d = dirs + (size_t)g * 3 * kRpc + s * kRays + lane;
  uint64_t key[kPerLane];
  // a subtile without a pair with its bit below e0, the first event of all
  // its rays, is not swept
  const bool swept = sc.state[sg] != 0;
  int K = swept ? 0 : sc.e0[g];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    key[j] = swept ? keys[o0 + 32 * j] : kNoKey;
    if (swept) K = max(K, sc.ev[o0 + 32 * j]);
  }
  if (swept)
    for (int w = 16; w > 0; w >>= 1) K = max(K, __shfl_xor_sync(full, K, w));
  int n = 0;
  for (int k = ts + lane; k < K; k += 32) n += (p_bits[k] >> s) & 1;
  for (int w = 16; w > 0; w >>= 1) n += __shfl_xor_sync(full, n, w);
  bool stray = false;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) stray |= key[j] != kNoKey && key_pair(key[j]) >= K;
  if (__any_sync(full, stray)) {
    // a least key from a pair at or above K: sweep [t_start, K) serially,
    // from device memory (this path is rare)
    for (int j = 0; j < kPerLane; ++j) {
      const float dx = d[32 * j], dy = d[kRpc + 32 * j], dz = d[2 * kRpc + 32 * j];
      float best_t = kBig, best_u = 0.f, best_v = 0.f;
      int best_p = -1;
      for (int k = ts; k < K; ++k) {
        if (!((p_bits[k] >> s) & 1)) continue;
        const float4* slab = prims + (size_t)p_tid[k] * L * kPrimF4;
        float bt = kBig;
        int bl = 0;
        for (int l = 0; l < L; ++l) {
          const float t = moller_t(slab + kPrimF4 * l, dx, dy, dz);
          if (t < bt) {
            bt = t;
            bl = l;
          }
        }
        if (bt < best_t) {
          const Test w = moller(slab + kPrimF4 * bl, dx, dy, dz);
          best_t = bt;
          best_u = __fmul_rn(w.un, w.inv);
          best_v = __fmul_rn(w.vn, w.inv);
          best_p = __float_as_int(slab[kPrimF4 * bl + 3].y);
        }
      }
      const size_t o = o0 + 32 * j;
      out_t[o] = best_t;
      out_p[o] = best_p;
      out_u[o] = best_u;
      out_v[o] = best_v;
      out_c[o] = n * L;
    }
    if (lane == 0) {
      atomicAdd((unsigned long long*)stats, (unsigned long long)n * kRays * L);
      atomicAdd((unsigned long long*)stats + 2, 1ull);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    float best_t = kBig, best_u = 0.f, best_v = 0.f;
    int best_p = -1;
    if (key[j] != kNoKey) {  // its pair lies below K: the winner
      const float4* p =
          prims + ((size_t)p_tid[key_pair(key[j])] * L + key_row(key[j])) * kPrimF4;
      const Test w = moller(p, d[32 * j], d[kRpc + 32 * j], d[2 * kRpc + 32 * j]);
      best_t = w.t;
      best_u = __fmul_rn(w.un, w.inv);
      best_v = __fmul_rn(w.vn, w.inv);
      best_p = __float_as_int(p[3].y);
    }
    const size_t o = o0 + 32 * j;
    out_t[o] = best_t;
    out_p[o] = best_p;
    out_u[o] = best_u;
    out_v[o] = best_v;
    out_c[o] = n * L;
  }
}

}  // namespace

// scratch: CT * (4096 + 18) + 4 + 3 * lv ints, lv = P / kChunk + 2; keys:
// CT * 4096 u64; stats: kStats + kSmSlots i64 (tests run, pair sweeps,
// re-swept subtiles, -, then pair sweeps per SM)
extern "C" int tbvh_raster_sweep(const float* dirs, const float* prims, const int* p_tid,
                                 const float* p_tlb, const int* p_bits, const int* t_start,
                                 const int* t_end, int n_ct, int P, int L,
                                 float* out_t, int* out_p, float* out_u, float* out_v, int* out_c,
                                 void* keys, int* scratch, long long* stats,
                                 cudaStream_t stream) {
  const float4* pr = reinterpret_cast<const float4*>(prims);
  unsigned long long* k64 = reinterpret_cast<unsigned long long*>(keys);
  const int n_sub = n_ct * kSub;
  const int lv = P / kChunk + 2;
  const size_t slab = (size_t)L * kPrimF4 * sizeof(float4);
  const size_t sweep_smem = 2 * slab + kOffSmem * sizeof(int) + kTlbSmem * sizeof(float);
  rt_init<<<n_ct + 1, kRays, 0, stream>>>(p_tlb, p_bits, t_start, t_end, n_ct, lv, k64,
                                          scratch, stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t opt_in = 48 * 1024 - 256;  // past this (with the static part), opt in
  if (sweep_smem > opt_in &&
      (e = cudaFuncSetAttribute(rt_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sweep_smem)) != cudaSuccess)
    return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rt_sweep, kRays,
                                                         sweep_smem)) != cudaSuccess)
    return (int)e;
  // at most sum over tiles of ceil(len / kChunk) <= P / kChunk + CT items a subtile
  const long long most = (long long)kSub * (P / kChunk + 1 + n_ct);
  const int grid = (int)(most < (long long)sms * per_sm ? most : (long long)sms * per_sm);
  rt_sweep<<<grid > 0 ? grid : 1, kRays, sweep_smem, stream>>>(
      dirs, pr, p_tid, p_tlb, p_bits, t_start, t_end, n_ct, L, lv, k64, scratch, stats);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  rt_finish<<<(n_sub + kFinWarps - 1) / kFinWarps, kFinWarps * 32, 0, stream>>>(
      dirs, pr, p_tid, p_bits, t_start, n_ct, L, lv, k64, scratch, stats, out_t, out_p, out_u,
      out_v, out_c);
  return (int)cudaGetLastError();
}
