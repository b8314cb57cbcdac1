// Wavefront BVH2 traversal: the closest hit of every ray, on persistent
// lanes that fetch their rays.
//
// Replaces no TPU kernel: tpu_bvh/ops/traverse.py (traverse_bvh2 :134,
// traverse_packed :271, the restart-trail engine :437) is XLA ops inside
// lax.while_loop, with no pl.pallas_call. Same contract, bit for bit in
// prim, t, u, v and the leaf-visit counts; the plain versions are
// ops/traverse.py:traverse_bvh2_reference and traverse_packed_reference.
//
// Design: the reference's per-thread shaders (TraversalKernel.h:28-451) on
// a schedule for the H100.
//  * One kernel template over the node layout (the Bvh2's packed_t, left,
//    right and the triangles; or pack_bvh2's i32[M, 16] rows, read as
//    16-byte words) and over the loop shape: ifif, while-while,
//    speculative (node steps while any lane of the warp sits at an internal
//    node: the __any vote) and the restart trail. Each shape gives a ray the
//    steps the JAX schedulers give it, so the hits, counts and step counters
//    are the same; the shapes differ in how the warp diverges.
//    traverse_packed is the packed layout under ifif.
//  * Persistent lanes that fetch their rays (after Aila & Laine, HPG 2009):
//    the grid is the blocks the card holds resident (the occupancy query;
//    a card that holds none raises): of kBlock threads while the rays
//    outnumber the lanes, else at most one a kSmallBlock rays, which
//    spreads them over the SMs more evenly. A lane starts on its own
//    thread's ray (a block on neighbouring rays, which share rows in its
//    SM's L1) and takes its next ray from its block's pool in shared
//    memory (one shared atomic) the moment its own ends, with no vote of
//    its warp: under ifif, while-while and the restart trail the lanes of a
//    warp run free, so a lane that waits for its row does not hold the
//    others back. The lane that finds the block's chunk spent fetches the
//    next kFetch rays with one global atomicAdd. Under the speculative
//    shape every lane takes its next ray where the warp's outer vote ends,
//    so each vote spans one set of rays, as before. A new ray resets every
//    piece of per-ray state: node, stack top, hit, count, the trail words.
//    Rays past n are never taken. (A refill by warp vote, a ballot ranking
//    the free lanes at the top of every pass, was slower than one thread a
//    ray: it makes every step wait for the warp's slowest lane; PERF.md
//    section 6.)
//  * The stack walk: 48 ints in local memory, slot 0 the INVALID sentinel
//    and top starting at 1; near child first (t0n < t1n picks the left),
//    the far one pushed; the slabs tested in object space against the
//    current hit.t (the reference's mixed-space clamp), the triangles in
//    world space with u, v, w, t > 0 and t < hit.t.
//  * A ray that wants to push onto a full stack leaves the stack walk,
//    resets its hit and count and walks again from the root through the
//    restart trail, in the same thread: the JAX engines throw the
//    overflowed ray's stack result away the same way (traverse.py:198-213).
//  * The restart trail keeps native 64-bit trail, level and popLevel words.
//  * Arithmetic in the plain version's order and form (--fmad=false, IEEE
//    division): 3-term sums ((p0 + 0) + p1) + p2, cross products as written,
//    1 / denom then a product, jmin / jmax for every slab min and max (NaN
//    propagates, so a NaN slab is a miss).
//  * The rays are read in place at their row strides (a camera's origin is
//    one row expanded: stride 0), the transform from its three vectors.
//  * Device counters (u64[kStats], cleared by one memset before the launch):
//    node steps, leaf steps (both walks), overflowed rays, warp steps (a
//    group of lanes that runs a node or leaf step together counts once, so
//    lane steps / (32 x warp steps) is the SIMD efficiency) and the ray
//    counter. Each is summed over the warp (__reduce_add_sync), then over
//    the block in shared memory, and added once a block. Given a byte map
//    (`touched`, one byte a node, cleared by a memset; null in a normal
//    call), every step also marks the node it stands on, so the caller can
//    count the distinct rows the walk needed.
//
// Bound on the card: bytes, each needed row read once. A node step at x
// needs 56 B (the two child boxes, left and right), a leaf step 40 B (the
// triangle and its prim), on either layout; a ray reads 24 B and writes
// 20 B. Rows that many rays step on are fetched again from the caches, so
// the steps' own traffic (64 B a step on the packed rows) is far above the
// bound. The arithmetic is about 48 flops a node step (two slabs) and 203
// a leaf step (three vertex transforms, the triangle test), below the
// bytes at 67 TFLOP/s. The walk is latency-bound in practice: each step
// waits for its row; the persistent grid keeps the SMs' warp slots full
// while rays remain.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using tbvh::jmax;
using tbvh::jmin;
using u64 = unsigned long long;

constexpr int kStackDepth = 48;  // traverse.STACK_DEPTH
constexpr int kInvalid = -1;
constexpr int kBlock = 256;       // traverse.BLOCK: threads a block while rays outnumber lanes
constexpr int kSmallBlock = 128;  // traverse.SMALL_BLOCK: threads a block otherwise
constexpr int kBlocksPerSm = 3;   // blocks of kBlock an SM must hold: at most 85 registers
constexpr int kFetch = 64;   // traverse.FETCH: rays a block takes from the counter at once
constexpr int kCounters = 4;  // node steps, leaf steps, overflowed rays, warp steps
constexpr int kStats = 5;     // traverse.STATS: the counters, then the ray counter
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFltMax = 3.402823466e38f;
constexpr u64 kTopBit = 1ull << 63;

enum Shape { kIfIf = 0, kWhileWhile = 1, kSpeculative = 2, kRestart = 3 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }

// jnp.cross's components
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// jnp.sum(a * b, axis=-1) in the plain version's order: from +0.0 (three
// products of -0.0 sum to +0.0), left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const V3 p = mul(a, b);
  return ((p.x + 0.0f) + p.y) + p.z;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

struct Transform {
  V3 tl, sc, qv;
  float qw;
};

// aabb.qt_rotate: t = 2 (qv x p); p + qw t + qv x t
__device__ __forceinline__ V3 qt_rotate(V3 qv, float qw, V3 p) {
  const V3 t = scale(2.0f, cross(qv, p));
  return add(add(p, scale(qw, t)), cross(qv, t));
}

// aabb.transform_point: object to world
__device__ __forceinline__ V3 to_world(const Transform& tr, V3 p) {
  return add(qt_rotate(tr.qv, tr.qw, mul(tr.sc, p)), tr.tl);
}

// aabb.inv_transform_point: world to object, about `tl`
__device__ __forceinline__ V3 to_object(const Transform& tr, V3 p, V3 tl) {
  const V3 q = qt_rotate({-tr.qv.x, -tr.qv.y, -tr.qv.z}, tr.qw, sub(p, tl));
  return {q.x / tr.sc.x, q.y / tr.sc.y, q.z / tr.sc.z};
}

// aabb.slab_intersect: a hit iff t_near <= t_far
__device__ __forceinline__ bool slab(V3 mn, V3 mx, V3 o, V3 inv, float max_t, float& t_near) {
  const V3 df = mul(sub(mx, o), inv);
  const V3 dn = mul(sub(mn, o), inv);
  float t_far = jmin(jmin(jmax(df.x, dn.x), jmax(df.y, dn.y)), jmax(df.z, dn.z));
  t_near = jmax(jmax(jmin(df.x, dn.x), jmin(df.y, dn.y)), jmin(df.z, dn.z));
  t_far = jmin(max_t, t_far);
  t_near = jmax(0.0f, t_near);
  return t_near <= t_far;
}

struct Hit {
  int prim;
  float t, u, v;
};

// aabb.intersect_triangle on world-space vertices, then the closest-hit update
__device__ __forceinline__ void test_triangle(V3 v0, V3 v1, V3 v2, int prim, V3 org, V3 dir,
                                              Hit& hit) {
  const V3 pos0 = sub(v0, org), pos1 = sub(v1, org), pos2 = sub(v2, org);
  const V3 edge0 = sub(v2, v0), edge1 = sub(v0, v1), edge2 = sub(v1, v2);
  const V3 normal = cross(edge1, edge0);
  const float u = dot(cross(add(pos0, pos2), edge0), dir);
  const float v = dot(cross(add(pos1, pos0), edge1), dir);
  const float w = dot(cross(add(pos2, pos1), edge2), dir);
  const float t = dot(pos0, normal) * 2.0f;
  const float denom = dot(normal, dir) * 2.0f;
  const float inv = 1.0f / denom;
  const float ui = u * inv, vi = v * inv, wi = w * inv, ti = t * inv;
  if (ui > 0.0f && vi > 0.0f && wi > 0.0f && ti > 0.0f && ti < hit.t) hit = {prim, ti, ui, vi};
}

// The Bvh2 as the builders leave it: packed_t f32[6, M] (min xyz, -max xyz),
// left, right i32[M], tris f32[N, 3, 3]
struct Bvh2Nodes {
  const float* __restrict__ pk;
  const int* __restrict__ left;
  const int* __restrict__ right;
  const float* __restrict__ tris;
  int m, n_tris;

  __device__ __forceinline__ void box(int c, V3& mn, V3& mx) const {
    mn = {pk[c], pk[m + c], pk[2 * m + c]};
    mx = {-pk[3 * m + c], -pk[4 * m + c], -pk[5 * m + c]};
  }

  __device__ __forceinline__ void node(int x, int& l, int& r, V3& mnl, V3& mxl, V3& mnr,
                                       V3& mxr) const {
    x = clampi(x, 0, m - 1);
    l = left[x];
    r = right[x];
    box(clampi(l, 0, m - 1), mnl, mxl);
    box(clampi(r, 0, m - 1), mnr, mxr);
  }

  __device__ __forceinline__ void leaf(int x, int& prim, V3& a, V3& b, V3& c) const {
    prim = left[clampi(x, 0, m - 1)];
    const float* t = tris + 9 * static_cast<size_t>(clampi(prim, 0, n_tris - 1));
    a = {t[0], t[1], t[2]};
    b = {t[3], t[4], t[5]};
    c = {t[6], t[7], t[8]};
  }
};

// pack_bvh2's rows, four 16-byte words a node
struct PackedNodes {
  const int4* __restrict__ rows;
  int m;

  __device__ __forceinline__ void node(int x, int& l, int& r, V3& mnl, V3& mxl, V3& mnr,
                                       V3& mxr) const {
    const int4* p = rows + 4 * static_cast<size_t>(clampi(x, 0, m - 1));
    const int4 q0 = p[0], q1 = p[1], q2 = p[2], q3 = p[3];
    mnl = {__int_as_float(q0.x), __int_as_float(q0.y), __int_as_float(q0.z)};
    mxl = {__int_as_float(q0.w), __int_as_float(q1.x), __int_as_float(q1.y)};
    mnr = {__int_as_float(q1.z), __int_as_float(q1.w), __int_as_float(q2.x)};
    mxr = {__int_as_float(q2.y), __int_as_float(q2.z), __int_as_float(q2.w)};
    l = q3.x;
    r = q3.y;
  }

  __device__ __forceinline__ void leaf(int x, int& prim, V3& a, V3& b, V3& c) const {
    const int4* p = rows + 4 * static_cast<size_t>(clampi(x, 0, m - 1));
    const int4 q0 = p[0], q1 = p[1], q2 = p[2];
    a = {__int_as_float(q0.x), __int_as_float(q0.y), __int_as_float(q0.z)};
    b = {__int_as_float(q0.w), __int_as_float(q1.x), __int_as_float(q1.y)};
    c = {__int_as_float(q1.z), __int_as_float(q1.w), __int_as_float(q2.x)};
    prim = q2.y;
  }
};

// true in one lane of each group of lanes that runs this step together
__device__ __forceinline__ bool step_leader() {
  return static_cast<int>(threadIdx.x & 31) == __ffs(__activemask()) - 1;
}

// Where the rays are: rows of 3 floats at a row stride (0: one row for all)
struct RayRows {
  const float* __restrict__ origin;
  const float* __restrict__ direction;
  int origin_stride, direction_stride;
};

struct Outputs {
  int* __restrict__ prim;
  float* __restrict__ t;
  float* __restrict__ u;
  float* __restrict__ v;
  int* __restrict__ count;
};

// The restart trail's walk state
struct Trail {
  int node;
  u64 trail, level, pop_level;
};

// One lane's ray, its two walks and the lane's step counters
template <class Nodes>
struct Ray {
  Nodes nodes;
  Transform tr;
  int n_internal, root;
  unsigned char* touched;  // a byte a node, marked at every step; or null
  V3 org, dir;     // world space: the triangle test
  V3 t_org, t_inv;  // object space: the slabs
  Hit hit;
  int count;
  unsigned node_steps, leaf_steps, warp_steps;  // over the lane's rays

  // ray i's origin and direction, a fresh hit and count
  __device__ __forceinline__ void start(const RayRows& in, int i) {
    const float* o = in.origin + static_cast<size_t>(in.origin_stride) * i;
    const float* d = in.direction + static_cast<size_t>(in.direction_stride) * i;
    org = {o[0], o[1], o[2]};
    dir = {d[0], d[1], d[2]};
    t_org = to_object(tr, org, tr.tl);
    const V3 td = to_object(tr, dir, {0.0f, 0.0f, 0.0f});
    t_inv = {1.0f / td.x, 1.0f / td.y, 1.0f / td.z};
    hit = {kInvalid, kFltMax, 0.0f, 0.0f};
    count = 0;
  }

  __device__ __forceinline__ void finish(const Outputs& out, int i) const {
    out.prim[i] = hit.prim;
    out.t[i] = hit.t;
    out.u[i] = hit.u;
    out.v[i] = hit.v;
    out.count[i] = count;
  }

  __device__ __forceinline__ void touch(int x) {
    if (touched) touched[clampi(x, 0, nodes.m - 1)] = 1;
  }

  __device__ __forceinline__ void leaf_test(int x) {
    touch(x);
    int prim;
    V3 a, b, c;
    nodes.leaf(x, prim, a, b, c);
    test_triangle(to_world(tr, a), to_world(tr, b), to_world(tr, c), prim, org, dir, hit);
    ++count;
    ++leaf_steps;
    if (step_leader()) ++warp_steps;
  }

  // the children of internal node x: (hit_l, hit_r, near first)
  __device__ __forceinline__ void children(int x, bool& hl, bool& hr, int& near, int& far,
                                           int& l, int& r) {
    V3 mnl, mxl, mnr, mxr;
    touch(x);
    nodes.node(x, l, r, mnl, mxl, mnr, mxr);
    float t0n, t1n;
    hl = slab(mnl, mxl, t_org, t_inv, hit.t, t0n);
    hr = slab(mnr, mxr, t_org, t_inv, hit.t, t1n);
    near = t0n < t1n ? l : r;
    far = t0n < t1n ? r : l;
    ++node_steps;
    if (step_leader()) ++warp_steps;
  }

  // stack walk node step; false when the ray wants to push onto a full stack
  __device__ __forceinline__ bool node_step(int& node, int* stack, int& top) {
    bool hl, hr;
    int near, far, l, r;
    children(node, hl, hr, near, far, l, r);
    if (hl && hr) {
      if (top >= kStackDepth) return false;
      stack[top++] = far;
      node = near;
    } else if (hl || hr) {
      node = hl ? l : r;
    } else {
      top = top > 0 ? top - 1 : 0;
      node = stack[top];
    }
    return true;
  }

  __device__ __forceinline__ void leaf_step(int& node, const int* stack, int& top) {
    leaf_test(node);
    top = top > 0 ? top - 1 : 0;
    node = stack[top];
  }

  __device__ __forceinline__ Trail trail_start() const { return {root, kTopBit, kTopBit, 0}; }

  // one step of TraversalKernel.h:28-146 as traverse.py's restart-trail
  // engine has it; true when the walk is done
  __device__ __forceinline__ bool trail_step(Trail& w) {
    bool need_pop = true;
    if (w.node >= n_internal) {
      leaf_test(w.node);
    } else {
      bool hl, hr;
      int near, far, l, r;
      children(w.node, hl, hr, near, far, l, r);
      if (hl && hr) {
        w.level >>= 1;
        w.node = (w.trail & w.level) ? far : near;
        need_pop = false;
      } else if (hl || hr) {
        w.level >>= 1;
        if (w.level != w.pop_level) {
          w.trail |= w.level;
          w.node = hr ? r : l;
          need_pop = false;
        }
      }
    }
    if (need_pop) {  // climb the trail; restart from the root unless it is spent
      w.trail = (w.trail & (0ull - w.level)) + w.level;
      const u64 temp = w.trail >> 1;
      const u64 next = ((temp - 1) ^ temp) + 1;
      if (!(w.trail & kTopBit)) return true;
      w.pop_level = next;
      w.level = kTopBit;
      w.node = root;
    }
    return false;
  }

  // after a stack overflow: the whole walk again without a stack, from a
  // fresh hit
  __device__ void restart() {
    hit = {kInvalid, kFltMax, 0.0f, 0.0f};
    count = 0;
    Trail w = trail_start();
    while (!trail_step(w)) {
    }
  }
};

// Where a lane's rays come from, in a grid of blocks of kThreads. Its first
// ray is its own thread's (ray blockIdx * kThreads + threadIdx, so a block
// starts on kThreads neighbouring rays, whose walks share rows in its SM's
// L1); the rays past the grid's lanes are handed out from
// the global counter, kFetch at a time, through one shared word of the
// block: the first ray of the block's chunk (high half) and how many of its
// kFetch rays have been taken (low half). A lane takes its next ray with one
// shared atomic when its own ends, without waiting for its warp; the lane
// that finds the chunk spent fetches the next one with one global
// atomicAdd, while the lanes that come meanwhile wait for it.
template <int kThreads>
struct Pool {
  u64* word;     // in shared memory
  u64* counter;  // the global ray counter: rays past the grid's lanes taken
  int n;

  __device__ __forceinline__ int first() const {
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    return i < n ? static_cast<int>(i) : -1;
  }

  // the lane's next ray, or -1 when the rays are spent
  __device__ __forceinline__ int take() const {
    const long long lanes = static_cast<long long>(gridDim.x) * kThreads;
    while (true) {
      const u64 w = atomicAdd(word, 1ull);
      const long long base = lanes + static_cast<long long>(w >> 32);
      const long long k = static_cast<long long>(w & 0xffffffffull);
      if (base >= n) return -1;  // the counter is past n
      if (k < kFetch) return base + k < n ? static_cast<int>(base + k) : -1;
      if (k == kFetch) {  // this lane fetches the next chunk
        const u64 next = atomicAdd(counter, static_cast<u64>(kFetch));
        const u64 spent = static_cast<u64>(n - (lanes < n ? lanes : n));
        atomicExch(word, (next < spent ? next : spent) << 32);
      } else {
        __nanosleep(32);  // another lane is fetching
      }
    }
  }
};

template <class Nodes, int kShape, int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == kBlock ? kBlocksPerSm : 1)
    traverse_kernel(Nodes nodes, int n_internal, const int* __restrict__ root_p, RayRows in,
                    int n, const float* __restrict__ tl, const float* __restrict__ sc,
                    const float* __restrict__ q, Outputs out, u64* __restrict__ stats,
                    unsigned char* touched) {
  __shared__ u64 block_stats[kCounters];
  __shared__ u64 pool_word;
  if (threadIdx.x < kCounters) block_stats[threadIdx.x] = 0;
  if (threadIdx.x == 0) pool_word = kFetch;  // a spent chunk: the first taker fetches
  __syncthreads();
  const Transform tr = {{tl[0], tl[1], tl[2]}, {sc[0], sc[1], sc[2]}, {q[0], q[1], q[2]}, q[3]};
  Ray<Nodes> ray{nodes, tr, n_internal, *root_p, touched};
  ray.node_steps = 0;
  ray.leaf_steps = 0;
  ray.warp_steps = 0;
  const Pool<kThreads> pool{&pool_word, stats + kCounters, n};
  unsigned overflows = 0;
  if constexpr (kShape == kRestart) {
    for (int i = pool.first(); i >= 0; i = pool.take()) {  // a ray, then the lane's next
      ray.start(in, i);
      Trail walk = ray.trail_start();
      while (!ray.trail_step(walk)) {
      }
      ray.finish(out, i);
    }
  } else if constexpr (kShape == kSpeculative) {  // every lane takes part in both votes
    int stack[kStackDepth];
    stack[0] = kInvalid;
    for (bool fresh = true;; fresh = false) {
      const int i = fresh ? pool.first() : pool.take();  // where the outer vote ended
      if (!__any_sync(kFull, i >= 0)) break;
      if (i >= 0) ray.start(in, i);
      int node = i >= 0 ? ray.root : kInvalid;
      int top = 1;
      bool overflow = false;
      while (__any_sync(kFull, node != kInvalid)) {
        while (__any_sync(kFull, node != kInvalid && node < n_internal)) {
          if (node != kInvalid && node < n_internal && !ray.node_step(node, stack, top)) {
            overflow = true;
            node = kInvalid;
          }
        }
        if (node != kInvalid && node >= n_internal) ray.leaf_step(node, stack, top);
      }
      if (overflow) {
        ray.restart();
        ++overflows;
      }
      if (i >= 0) ray.finish(out, i);
    }
  } else {  // kIfIf, kWhileWhile: a lane takes its next ray when its own ends
    int stack[kStackDepth];
    stack[0] = kInvalid;
    for (int i = pool.first(); i >= 0; i = pool.take()) {
      ray.start(in, i);
      int node = ray.root, top = 1;
      bool overflow = false;
      if constexpr (kShape == kIfIf) {
        while (node != kInvalid) {
          if (node < n_internal && !ray.node_step(node, stack, top)) {
            overflow = true;
            break;
          }
          if (node != kInvalid && node >= n_internal) ray.leaf_step(node, stack, top);
        }
      } else {
        while (node != kInvalid && !overflow) {
          while (node != kInvalid && node < n_internal) {
            if (!ray.node_step(node, stack, top)) {
              overflow = true;
              break;
            }
          }
          while (!overflow && node != kInvalid && node >= n_internal)
            ray.leaf_step(node, stack, top);
        }
      }
      if (overflow) {  // walk again without a stack, from a fresh hit
        ray.restart();
        ++overflows;
      }
      ray.finish(out, i);
    }
  }
  const unsigned sums[kCounters] = {
      __reduce_add_sync(kFull, ray.node_steps), __reduce_add_sync(kFull, ray.leaf_steps),
      __reduce_add_sync(kFull, overflows), __reduce_add_sync(kFull, ray.warp_steps)};
  if ((threadIdx.x & 31) == 0) {
    for (int c = 0; c < kCounters; ++c)
      if (sums[c]) atomicAdd(&block_stats[c], static_cast<u64>(sums[c]));
  }
  __syncthreads();
  if (threadIdx.x < kCounters && block_stats[threadIdx.x])
    atomicAdd(&stats[threadIdx.x], block_stats[threadIdx.x]);
}

// Blocks of one kernel the card holds resident, by device: asked once
template <class Nodes, int kShape, int kThreads>
cudaError_t resident_blocks(int& blocks) {
  static int known[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (known[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, traverse_kernel<Nodes, kShape, kThreads>, kThreads, 0)) != cudaSuccess)
      return e;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;  // the card holds none
    known[dev] = sms * per_sm;
  }
  blocks = known[dev];
  return cudaSuccess;
}

// The counters' memset and one launch. While the rays outnumber the lanes
// the card holds in blocks of kBlock, every SM stays full and the larger
// blocks keep more neighbouring rays on one SM; with fewer rays, blocks of
// kSmallBlock spread them over the SMs more evenly.
template <class Nodes, int kShape>
int launch(const Nodes& nodes, int n_internal, const int* root, const RayRows& in, int n,
           const float* tl, const float* sc, const float* q, const Outputs& out, u64* stats,
           unsigned char* touched, cudaStream_t stream) {
  int big = 0, small = 0;
  cudaError_t e = resident_blocks<Nodes, kShape, kBlock>(big);
  if (e != cudaSuccess) return (int)e;
  if (static_cast<long long>(big) * kBlock >= n &&
      (e = resident_blocks<Nodes, kShape, kSmallBlock>(small)) != cudaSuccess)
    return (int)e;
  if ((e = cudaMemsetAsync(stats, 0, kStats * sizeof(u64), stream)) != cudaSuccess) return (int)e;
  if (touched && (e = cudaMemsetAsync(touched, 0, static_cast<size_t>(nodes.m), stream)) !=
                     cudaSuccess)
    return (int)e;
  if (small == 0) {
    traverse_kernel<Nodes, kShape, kBlock><<<big, kBlock, 0, stream>>>(
        nodes, n_internal, root, in, n, tl, sc, q, out, stats, touched);
  } else {
    const int wanted = (n + kSmallBlock - 1) / kSmallBlock;  // no more lanes than rays
    traverse_kernel<Nodes, kShape, kSmallBlock><<<wanted < small ? wanted : small, kSmallBlock, 0,
                                                  stream>>>(nodes, n_internal, root, in, n, tl,
                                                            sc, q, out, stats, touched);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// traverse_bvh2 over the Bvh2 SoA; shape: 0 ifif, 1 while-while, 2
// speculative, 3 restart trail. origin and direction are rows of 3 floats
// at the given row strides (in floats); the transform is translation[3],
// scale[3], quat[4]; stats is u64[kStats], touched u8[m] or null (both
// cleared here)
extern "C" int tbvh_traverse_bvh2(int shape, const float* packed_t, const int* left,
                                  const int* right, int m, int n_internal, const int* root,
                                  const float* tris, int n_tris, const float* origin,
                                  int origin_stride, const float* direction,
                                  int direction_stride, int n, const float* translation,
                                  const float* scale, const float* quat, int* prim, float* t,
                                  float* u, float* v, int* count, u64* stats,
                                  unsigned char* touched, cudaStream_t stream) {
  if (n < 1 || m < 1 || n_tris < 1) return (int)cudaErrorInvalidValue;
  const Bvh2Nodes nodes{packed_t, left, right, tris, m, n_tris};
  const RayRows in{origin, direction, origin_stride, direction_stride};
  const Outputs out{prim, t, u, v, count};
  switch (shape) {
    case kIfIf:
      return launch<Bvh2Nodes, kIfIf>(nodes, n_internal, root, in, n, translation, scale, quat,
                                      out, stats, touched, stream);
    case kWhileWhile:
      return launch<Bvh2Nodes, kWhileWhile>(nodes, n_internal, root, in, n, translation, scale,
                                            quat, out, stats, touched, stream);
    case kSpeculative:
      return launch<Bvh2Nodes, kSpeculative>(nodes, n_internal, root, in, n, translation, scale,
                                             quat, out, stats, touched, stream);
    case kRestart:
      return launch<Bvh2Nodes, kRestart>(nodes, n_internal, root, in, n, translation, scale,
                                         quat, out, stats, touched, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// traverse_packed: pack_bvh2's rows (16-byte aligned) under ifif
extern "C" int tbvh_traverse_packed(const int* rows, int m, int n_internal, const int* root,
                                    const float* origin, int origin_stride,
                                    const float* direction, int direction_stride, int n,
                                    const float* translation, const float* scale,
                                    const float* quat, int* prim, float* t, float* u, float* v,
                                    int* count, u64* stats, unsigned char* touched,
                                    cudaStream_t stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const PackedNodes nodes{reinterpret_cast<const int4*>(rows), m};
  const RayRows in{origin, direction, origin_stride, direction_stride};
  return launch<PackedNodes, kIfIf>(nodes, n_internal, root, in, n, translation, scale, quat,
                                    Outputs{prim, t, u, v, count}, stats, touched, stream);
}
