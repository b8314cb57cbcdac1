// Batched build of mid-size meshes: one BVH2 per mesh of 65..1024 prims,
// one block a mesh, the whole batch in one launch.
//
// Replaces no TPU kernel: past 64 prims the JAX package builds each mesh
// with jax.vmap(lbvh.build_single_pass(use_extended=False))
// (tpu_bvh/models/batched.py:59-61, XLA ops, no Pallas), its TPU form of
// the reference's whole-pipeline-in-one-block batched kernel
// (BatchedBuildKernel.h:218-312: block AABB reduce, shared-memory Morton,
// block sort, Apetrei build-and-fit). Same contract, bit for bit; the
// plain version is ops/batched_block.py:batched_block_reference.
//
// Design: a block of T threads (the power of two from 128 to 1024 that
// holds the mesh) owns a mesh; thread t owns prim t, then sorted leaf t,
// then boundary (internal node) t.
//  1. The mesh's 36 M bytes are copied coalesced into shared memory; each
//     thread boxes its prim (jmin / jmax over the three vertices) and the
//     scene box is a block reduction of min_keys (__reduce_min_sync in each
//     warp, then over the warps).
//  2. Codes as morton30_cols computes them (IEEE division, no FMA), then a
//     bitonic network over the 64-bit keys (code << 10) | prim, padding ~0:
//     the keys are distinct, so the network's order is the stable sort by
//     code. Stages with a partner in the warp are shuffles; the others
//     exchange through a double-buffered array in shared memory, one
//     barrier a stage. Each thread then re-boxes its sorted leaf's prim
//     from the staged mesh, writes the leaf's rows, and forms its boundary's
//     delta from the next sorted code, remapped to [0, 52].
//  3. A sparse table of the u16 keys (delta << 10) | j over the boundaries
//     (log2 T levels). A binary descent over it finds psv and nsv (the
//     nearest boundary on each side with a strictly smaller delta): first =
//     psv + 1, last = nsv. The children are the range minima over (psv, i)
//     and (i, nsv), two table reads each; the earliest argmin falls out of
//     j in the low bits. Each node scatters itself as its children's parent.
//  4. Refit bottom-up (the reference's build-and-fit): each leaf's thread
//     climbs; at a parent the first thread to arrive (an atomicAdd on the
//     parent's count in shared memory) stops, the second takes the min of
//     the children's exact min_keys (exact in any order) and climbs on.
//  5. Internal rows are written at coalesced addresses, each taken down to
//     3e38 where JAX's single-pass refit at radius 16 fills with 3e38 (its
//     stencil for short nodes; its two-level table for a long node with no
//     whole block of 16 leaves inside; neither when the mesh's long nodes
//     exceed the budget and it takes the exact full table).
//
// Shared memory, 88 T bytes: phases 1-2 hold the mesh (36 T) and the sort
// buffers (16 T) in a region that phase 3 reuses for the table (2 log2 T
// x T) and phase 4 for the internal nodes' keys (24 T); the leaves' keys
// (24 T), the counts (4 T), parents and children (8 T) stay.
//
// Bound on the card: bytes. Per mesh it reads 36 M bytes and writes
// (6 + 2) * 4 * (2M - 1) + 4 bytes; everything between stays on chip.

#include <climits>

#include <cuda_runtime.h>

#include "batched_common.cuh"
#include "common.cuh"

namespace {

using tbvh::from_min_key;
using tbvh::jmax;
using tbvh::jmin;
using tbvh::min_key;
using u64 = unsigned long long;

constexpr int kMinPrims = 65;    // batched_block.MIN_PRIMS: the warp kernel takes up to 64
constexpr int kMaxPrims = 1024;  // batched_block.MAX_PRIMS
constexpr int kRadius = 16;      // batched_block.RADIUS: JAX's refit radius
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.0e38f;

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x >> 1); }

constexpr size_t smem_bytes(int T) { return static_cast<size_t>(88) * T; }

// kClock: thread 0 stamps clock64 after each phase into clk (compiled out of
// the launches that take no clock record)
template <int T, bool kClock>
__global__ void __launch_bounds__(T)
    batched_block(const float* __restrict__ tris, int M, float* __restrict__ packed_t,
                  int* __restrict__ left, int* __restrict__ right, int* __restrict__ root,
                  long long* __restrict__ clk) {
  constexpr int kLog = log2i(T);
  constexpr int kWarps = T / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* s_key = reinterpret_cast<u64*>(smem);                          // [2][T], phases 1-2
  float* s_tri = reinterpret_cast<float*>(smem + 16 * T);             // [9 M], phases 1-2
  unsigned short* s_tab = reinterpret_cast<unsigned short*>(smem);    // [kLog][T], phase 3
  int* s_int = reinterpret_cast<int*>(smem);                          // [6][T], phases 4-5
  int* s_leaf = reinterpret_cast<int*>(smem + 52 * T);                // [6][T]
  int* s_cnt = s_leaf + 6 * T;                                        // [T]
  short* s_par = reinterpret_cast<short*>(s_cnt + T);                 // [2T]: node -> parent
  short* s_kid = s_par + 2 * T;                                       // [2][T]: left, right
  __shared__ int s_red[kWarps][6];
  __shared__ int s_scene[6];
  __shared__ int s_root;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const int m = M - 1;
  const int W = 2 * M - 1;
  long long* stamp = kClock ? clk + 6 * static_cast<size_t>(b) : nullptr;
  if (stamp && t == 0) stamp[0] = clock64();

  // 1. the mesh, the prim boxes and the scene box
  const float* src = tris + static_cast<size_t>(b) * M * 9;
  for (int x = t; x < 9 * M; x += T) s_tri[x] = src[x];
  s_par[t] = -1;  // the root keeps -1
  s_par[T + t] = -1;
  s_cnt[t] = 0;
  if (t == 0) s_root = INT_MAX;
  __syncthreads();
  float mn[3] = {0.0f, 0.0f, 0.0f}, mx[3] = {0.0f, 0.0f, 0.0f};
  int kb[6] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX};
  if (t < M) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v0 = s_tri[t * 9 + a], v1 = s_tri[t * 9 + 3 + a], v2 = s_tri[t * 9 + 6 + a];
      mn[a] = jmin(jmin(v0, v1), v2);
      mx[a] = jmax(jmax(v0, v1), v2);
      kb[a] = min_key(mn[a]);
      kb[3 + a] = min_key(-mx[a]);
    }
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const int v = __reduce_min_sync(kFull, kb[r]);
    if (lane == 0) s_red[warp][r] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const int v = __reduce_min_sync(kFull, lane < kWarps ? s_red[lane][r] : INT_MAX);
      if (lane == 0) s_scene[r] = v;
    }
  }
  __syncthreads();
  if (stamp && t == 0) stamp[1] = clock64();

  // 2. codes, the sort, the sorted leaves and the deltas
  float smin[3], safe[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    smin[a] = from_min_key(s_scene[a]);
    const float ext = -from_min_key(s_scene[3 + a]) - smin[a];
    safe[a] = ext > 0.0f ? ext : 1.0f;
  }
  u64 key = ~0ull;
  if (t < M)
    key = (static_cast<u64>(tbvh::morton30(mn, mx, smin, safe)) << 10) | static_cast<u64>(t);
  int buf = 0;
#pragma unroll
  for (int k = 2; k <= T; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      u64 other;
      if (j >= 32) {  // the partner is in another warp
        s_key[buf * T + t] = key;
        __syncthreads();
        other = s_key[buf * T + (t ^ j)];
        buf ^= 1;
      } else {
        other = __shfl_xor_sync(kFull, key, j);
      }
      const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
      key = (key < other) == keep_min ? key : other;
    }
  }
  s_key[buf * T + t] = key;
  __syncthreads();
  float* out = packed_t + static_cast<size_t>(b) * 6 * W;
  int* lo = left + static_cast<size_t>(b) * W;
  int* ro = right + static_cast<size_t>(b) * W;
  int d = 0;
  if (t < M) {
    const int prim = static_cast<int>(key & 1023);
    float row[6];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v0 = s_tri[prim * 9 + a], v1 = s_tri[prim * 9 + 3 + a];
      const float v2 = s_tri[prim * 9 + 6 + a];
      row[a] = jmin(jmin(v0, v1), v2);
      row[3 + a] = -jmax(jmax(v0, v1), v2);
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      s_leaf[r * T + t] = min_key(row[r]);
      out[r * W + m + t] = row[r];
    }
    lo[m + t] = prim;
    ro[m + t] = -1;
    if (t < m)
      d = tbvh::remapped_delta(static_cast<unsigned>(key >> 10),
                               static_cast<unsigned>(s_key[buf * T + t + 1] >> 10), t);
  }
  __syncthreads();  // the mesh and the sort buffers are dead
  if (stamp && t == 0) stamp[2] = clock64();

  // 3. the sparse table, psv / nsv, the children and the parents
  if (t < m) s_tab[t] = static_cast<unsigned short>((d << 10) | t);
#pragma unroll
  for (int k = 1; k < kLog; ++k) {
    __syncthreads();
    if (t + (1 << k) <= m) {
      const unsigned short a = s_tab[(k - 1) * T + t], c = s_tab[(k - 1) * T + t + (1 << (k - 1))];
      s_tab[k * T + t] = a < c ? a : c;
    }
  }
  __syncthreads();
  bool clamp = false;
  bool is_long = false;
  if (t < m) {
    const unsigned thr = static_cast<unsigned>(d) << 10;  // a window min >= thr: no smaller delta
    int first = t;  // the left end of the windows passed
#pragma unroll
    for (int k = kLog - 1; k >= 0; --k) {
      const int q = first - (1 << k);
      if (q >= 0 && s_tab[k * T + q] >= thr) first = q;
    }
    int last = t + 1;  // the first boundary not passed: nsv, or m where none
#pragma unroll
    for (int k = kLog - 1; k >= 0; --k)
      if (last + (1 << k) <= m && s_tab[k * T + last] >= thr) last += 1 << k;
    auto argmin = [&](int a, int z) {  // the earliest argmin of the deltas over [a, z]
      const int k = 31 - __clz(z - a + 1);
      const unsigned short u = s_tab[k * T + a], v = s_tab[k * T + z - (1 << k) + 1];
      return (u < v ? u : v) & 1023;
    };
    const int lnode = first <= t - 1 ? argmin(first, t - 1) : m + t;
    const int rnode = t + 1 <= last - 1 ? argmin(t + 1, last - 1) : m + t + 1;
    lo[t] = lnode;
    ro[t] = rnode;
    s_kid[t] = static_cast<short>(lnode);
    s_kid[T + t] = static_cast<short>(rnode);
    s_par[lnode] = static_cast<short>(t);
    s_par[rnode] = static_cast<short>(t);
    if (first == 0 && last == m) atomicMin(&s_root, t);
    is_long = !(t - first < kRadius && last - t <= kRadius);
    const bool has_mid = ((last + 1) >> 4) - 1 >= ((first + 15) >> 4);
    clamp = !is_long || !has_mid;
  }
  const int n_long = __syncthreads_count(is_long);  // and the table is dead
  const int cap = min(m, max(64, (4 * m) / (3 * kRadius)));
  clamp = clamp && !(cap < m && n_long > cap);  // else the mesh takes the exact full table
  if (stamp && t == 0) stamp[3] = clock64();

  // 4. refit: each leaf's thread climbs while it is the second at a parent
  if (t < M) {
    int v[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) v[r] = s_leaf[r * T + t];
    int x = m + t;
    for (int step = 0; step < M; ++step) {  // at most the tree's height
      const int p = s_par[x];
      if (p < 0) break;  // x is the root
      __threadfence_block();  // x's keys before the count
      if (atomicAdd(&s_cnt[p], 1) == 0) break;  // the sibling's thread goes on
      __threadfence_block();
      const int sib = s_kid[p] == x ? s_kid[T + p] : s_kid[p];
      const volatile int* vi = s_int;
#pragma unroll
      for (int r = 0; r < 6; ++r)
        v[r] = min(v[r], sib >= m ? s_leaf[r * T + sib - m] : vi[r * T + sib]);
#pragma unroll
      for (int r = 0; r < 6; ++r) s_int[r * T + p] = v[r];
      x = p;
    }
  }
  __syncthreads();
  if (stamp && t == 0) stamp[4] = clock64();

  // 5. the internal rows and the root
  if (t < m) {
    const int big = min_key(kBig);
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const int k = s_int[r * T + t];
      out[r * W + t] = from_min_key(clamp ? min(k, big) : k);
    }
  }
  if (t == 0) root[b] = s_root == INT_MAX ? 0 : s_root;  // the first root, as JAX's argmax
  if (stamp) {
    __syncthreads();
    if (t == 0) stamp[5] = clock64();
  }
}

template <int T, bool kClock>
int launch_as(const float* tris, int B, int M, float* packed_t, int* left, int* right, int* root,
              long long* clk, cudaStream_t stream) {
  // above 48 KB of shared memory; the opt-in holds for the current device
  // only, so it is made on every launch
  constexpr size_t bytes = smem_bytes(T);
  const cudaError_t e = cudaFuncSetAttribute(batched_block<T, kClock>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  batched_block<T, kClock><<<B, T, bytes, stream>>>(tris, M, packed_t, left, right, root, clk);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int launch(const float* tris, int B, int M, float* packed_t, int* left, int* right, int* root,
           long long* clk, cudaStream_t stream) {
  return clk ? launch_as<T, true>(tris, B, M, packed_t, left, right, root, clk, stream)
             : launch_as<T, false>(tris, B, M, packed_t, left, right, root, clk, stream);
}

}  // namespace

// tris f32[B, M, 3, 3]; packed_t f32[B, 6, 2M - 1]; left, right i32[B, 2M - 1];
// root i32[B]; clk i64[B, 6] (the phase clocks) or null
extern "C" int tbvh_batched_block(const float* tris, int B, int M, float* packed_t, int* left,
                                  int* right, int* root, long long* clk, cudaStream_t stream) {
  if (B < 1 || M < kMinPrims || M > kMaxPrims) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 128) return launch<128>(tris, B, M, packed_t, left, right, root, clk, stream);
  if (M <= 256) return launch<256>(tris, B, M, packed_t, left, right, root, clk, stream);
  if (M <= 512) return launch<512>(tris, B, M, packed_t, left, right, root, clk, stream);
  return launch<1024>(tris, B, M, packed_t, left, right, root, clk, stream);
}
