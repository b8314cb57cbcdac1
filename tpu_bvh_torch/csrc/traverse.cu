// Wavefront BVH2 traversal: the closest hit of every ray, one thread a ray.
//
// Replaces no TPU kernel: tpu_bvh/ops/traverse.py (traverse_bvh2 :134,
// traverse_packed :271, the restart-trail engine :437) is XLA ops inside
// lax.while_loop, with no pl.pallas_call. Same contract, bit for bit in
// prim, t, u, v and the leaf-visit counts; the plain versions are
// ops/traverse.py:traverse_bvh2_reference and traverse_packed_reference.
//
// Design: the reference's per-thread shaders (TraversalKernel.h:28-451).
//  * One kernel template over the node layout (the Bvh2's packed_t, left,
//    right and the triangles; or pack_bvh2's i32[M, 16] rows, read as
//    16-byte words) and over the loop shape: ifif, while-while,
//    speculative (node steps while any lane of the warp sits at an internal
//    node: the __any vote) and the restart trail. Each shape gives a ray the
//    steps the JAX schedulers give it, so the hits and counts are the same;
//    the shapes differ in how the warp diverges. traverse_packed is the
//    packed layout under ifif.
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
//  * Device counters: node steps, leaf steps (both walks) and overflowed
//    rays, summed over each warp and added once a warp. Given a byte map
//    (`touched`, one byte a node; null in a normal call), every step also
//    marks the node it stands on, so the caller can count the distinct
//    rows the walk needed.
//
// Bound on the card: bytes, each needed row read once. A node step at x
// needs 56 B (the two child boxes, left and right), a leaf step 40 B (the
// triangle and its prim), on either layout; a ray reads 24 B and writes
// 20 B. Rows that many rays step on are fetched again from the caches, so
// the steps' own traffic (64 B a step on the packed rows) is far above the
// bound. The arithmetic is about 48 flops a node step (two slabs) and 203
// a leaf step (three vertex transforms, the triangle test), below the
// bytes at 67 TFLOP/s. The walk is latency-bound in practice: each step
// waits for its row.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using tbvh::jmax;
using tbvh::jmin;
using u64 = unsigned long long;

constexpr int kStackDepth = 48;  // traverse.STACK_DEPTH
constexpr int kInvalid = -1;
constexpr int kBlock = 128;
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

// One ray's state and its two walks
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
  unsigned node_steps, leaf_steps;

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

  // TraversalKernel.h:28-146 as traverse.py's restart-trail engine has it
  __device__ void restart_trail() {
    int node = root;
    u64 trail = kTopBit, level = kTopBit, pop_level = 0;
    while (true) {
      bool need_pop = true;
      if (node >= n_internal) {
        leaf_test(node);
      } else {
        bool hl, hr;
        int near, far, l, r;
        children(node, hl, hr, near, far, l, r);
        if (hl && hr) {
          level >>= 1;
          node = (trail & level) ? far : near;
          need_pop = false;
        } else if (hl || hr) {
          level >>= 1;
          if (level != pop_level) {
            trail |= level;
            node = hr ? r : l;
            need_pop = false;
          }
        }
      }
      if (need_pop) {  // climb the trail; restart from the root unless it is spent
        trail = (trail & (0ull - level)) + level;
        const u64 temp = trail >> 1;
        const u64 next = ((temp - 1) ^ temp) + 1;
        if (!(trail & kTopBit)) break;
        pop_level = next;
        level = kTopBit;
        node = root;
      }
    }
  }
};

template <class Nodes, int kShape>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(Nodes nodes, int n_internal, const int* __restrict__ root_p,
                    const float* __restrict__ origin, const float* __restrict__ direction, int n,
                    const float* __restrict__ tr_p, int* __restrict__ out_prim,
                    float* __restrict__ out_t, float* __restrict__ out_u,
                    float* __restrict__ out_v, int* __restrict__ out_count,
                    u64* __restrict__ stats, unsigned char* touched) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = i < n;
  const Transform tr = {{tr_p[0], tr_p[1], tr_p[2]}, {tr_p[3], tr_p[4], tr_p[5]},
                        {tr_p[6], tr_p[7], tr_p[8]}, tr_p[9]};
  Ray<Nodes> ray{nodes, tr, n_internal, *root_p, touched};
  ray.hit = {kInvalid, kFltMax, 0.0f, 0.0f};
  ray.count = 0;
  ray.node_steps = 0;
  ray.leaf_steps = 0;
  if (valid) {
    const float* o = origin + 3 * static_cast<size_t>(i);
    const float* d = direction + 3 * static_cast<size_t>(i);
    ray.org = {o[0], o[1], o[2]};
    ray.dir = {d[0], d[1], d[2]};
    ray.t_org = to_object(tr, ray.org, tr.tl);
    const V3 td = to_object(tr, ray.dir, {0.0f, 0.0f, 0.0f});
    ray.t_inv = {1.0f / td.x, 1.0f / td.y, 1.0f / td.z};
  }
  bool overflow = false;
  if constexpr (kShape == kRestart) {
    if (valid) ray.restart_trail();
  } else {
    int stack[kStackDepth];
    stack[0] = kInvalid;
    int top = 1;
    int node = valid ? ray.root : kInvalid;
    if constexpr (kShape == kIfIf) {
      while (node != kInvalid) {
        if (node < n_internal && !ray.node_step(node, stack, top)) {
          overflow = true;
          break;
        }
        if (node != kInvalid && node >= n_internal) ray.leaf_step(node, stack, top);
      }
    } else if constexpr (kShape == kWhileWhile) {
      while (node != kInvalid && !overflow) {
        while (node != kInvalid && node < n_internal) {
          if (!ray.node_step(node, stack, top)) {
            overflow = true;
            break;
          }
        }
        while (!overflow && node != kInvalid && node >= n_internal) ray.leaf_step(node, stack, top);
      }
    } else {  // kSpeculative: every lane takes part in both votes
      while (__any_sync(kFull, node != kInvalid)) {
        while (__any_sync(kFull, node != kInvalid && node < n_internal)) {
          if (node != kInvalid && node < n_internal && !ray.node_step(node, stack, top)) {
            overflow = true;
            node = kInvalid;
          }
        }
        if (node != kInvalid && node >= n_internal) ray.leaf_step(node, stack, top);
      }
    }
    if (overflow) {  // walk again without a stack, from a fresh hit
      ray.hit = {kInvalid, kFltMax, 0.0f, 0.0f};
      ray.count = 0;
      ray.restart_trail();
    }
  }
  if (valid) {
    out_prim[i] = ray.hit.prim;
    out_t[i] = ray.hit.t;
    out_u[i] = ray.hit.u;
    out_v[i] = ray.hit.v;
    out_count[i] = ray.count;
  }
  const unsigned ns = __reduce_add_sync(kFull, ray.node_steps);
  const unsigned ls = __reduce_add_sync(kFull, ray.leaf_steps);
  const unsigned ov = __reduce_add_sync(kFull, overflow ? 1u : 0u);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&stats[0], static_cast<u64>(ns));
    atomicAdd(&stats[1], static_cast<u64>(ls));
    if (ov) atomicAdd(&stats[2], static_cast<u64>(ov));
  }
}

template <class Nodes, int kShape>
int launch(const Nodes& nodes, int n_internal, const int* root, const float* origin,
           const float* direction, int n, const float* tr, int* prim, float* t, float* u,
           float* v, int* count, u64* stats, unsigned char* touched, cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  traverse_kernel<Nodes, kShape><<<grid, kBlock, 0, stream>>>(
      nodes, n_internal, root, origin, direction, n, tr, prim, t, u, v, count, stats, touched);
  return (int)cudaGetLastError();
}

}  // namespace

// traverse_bvh2 over the Bvh2 SoA; shape: 0 ifif, 1 while-while, 2
// speculative, 3 restart trail
extern "C" int tbvh_traverse_bvh2(int shape, const float* packed_t, const int* left,
                                  const int* right, int m, int n_internal, const int* root,
                                  const float* tris, int n_tris, const float* origin,
                                  const float* direction, int n, const float* tr, int* prim,
                                  float* t, float* u, float* v, int* count, u64* stats,
                                  unsigned char* touched, cudaStream_t stream) {
  if (n < 1 || m < 1 || n_tris < 1) return (int)cudaErrorInvalidValue;
  const Bvh2Nodes nodes{packed_t, left, right, tris, m, n_tris};
  switch (shape) {
    case kIfIf:
      return launch<Bvh2Nodes, kIfIf>(nodes, n_internal, root, origin, direction, n, tr, prim, t,
                                      u, v, count, stats, touched, stream);
    case kWhileWhile:
      return launch<Bvh2Nodes, kWhileWhile>(nodes, n_internal, root, origin, direction, n, tr,
                                            prim, t, u, v, count, stats, touched, stream);
    case kSpeculative:
      return launch<Bvh2Nodes, kSpeculative>(nodes, n_internal, root, origin, direction, n, tr,
                                             prim, t, u, v, count, stats, touched, stream);
    case kRestart:
      return launch<Bvh2Nodes, kRestart>(nodes, n_internal, root, origin, direction, n, tr, prim,
                                         t, u, v, count, stats, touched, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// traverse_packed: pack_bvh2's rows (16-byte aligned) under ifif
extern "C" int tbvh_traverse_packed(const int* rows, int m, int n_internal, const int* root,
                                    const float* origin, const float* direction, int n,
                                    const float* tr, int* prim, float* t, float* u, float* v,
                                    int* count, u64* stats, unsigned char* touched,
                                    cudaStream_t stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const PackedNodes nodes{reinterpret_cast<const int4*>(rows), m};
  return launch<PackedNodes, kIfIf>(nodes, n_internal, root, origin, direction, n, tr, prim, t, u,
                                    v, count, stats, touched, stream);
}
