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
//     [first, last] (the key order is jmin's, so the min of keys is exact
//     in any order). A walk over the range costs the root's lane 6 M loads;
//     past kWalkMax prims (at two slots a lane) two tables built by shuffles
//     over the dead room of the mesh take its place: each sorted
//     leaf's min from the start of its block of 8 and to its end, and a min
//     table over the blocks. A range across blocks is the suffix of its
//     first, the prefix of its last and two windows over the blocks between
//     (at most 24 loads a row); a range inside one block a walk of at most 8
//     leaves. The tables cost a fixed number of shuffles a slot, the walk
//     grows with M: on the H100 the walk won at one slot a lane and at 36
//     and 40 prims, the tables at 48 (by 1%), 56 and 64 (device time on
//     4096 meshes, profile_slice's batched_* calls). Each box
//     is taken down to 3e38 where the range is not the whole mesh (JAX's
//     masked min).
//  5. Each row of packed_t, left and right is written at lane-consecutive
//     addresses.
//
// Bound on the card: bytes. Per mesh it reads 36 M bytes and writes
// (6 + 2) * 4 * (2M - 1) + 4 bytes; everything between stays in registers
// and shared memory.

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

constexpr int kMaxPrims = 64;  // the largest capacity: batched_build.MAX_PRIMS
constexpr int kWalkMax = 48;   // two slots a lane: the walk up to here, the tables past it
constexpr int kWarps = 4;      // meshes a block, one warp each
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.0e38f;

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

// One warp's shared memory: the sorted leaves' keys, and the mesh and its
// leaf rows (steps 1-3), whose room the refit's tables take (step 4)
template <int N>
struct WarpSmem {
  int key[6][N];  // min_keys by sorted leaf
  union {
    struct {
      float tri[9 * N];  // the mesh as loaded
      float row[6][N];   // leaf rows (min xyz, -max xyz) by prim
    } in;
    struct {
      int pre[6][N];         // a sorted leaf's min over its block of 8, from the block's start
      int suf[6][N];         // and to the block's end
      int blk[3][6][N / 8];  // windows of 1, 2 and 4 blocks
    } fit;
  } u;
};

// kClock: lane 0 stamps clock64 after each phase into clk (compiled out of
// the launches that take no clock record)
template <int E, bool kClock>
__global__ void __launch_bounds__(kWarps * 32)
    batched_build_warp(const float* __restrict__ tris, int B, int M, float* __restrict__ packed_t,
                       int* __restrict__ left, int* __restrict__ right, int* __restrict__ root,
                       long long* __restrict__ clk) {
  constexpr int N = 32 * E;  // slots a warp
  constexpr int NB = N / 8;  // blocks of 8 sorted leaves
  __shared__ WarpSmem<N> s_warp[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp; only warp-level syncs follow
  const int m = M - 1;
  const int W = 2 * M - 1;
  long long* stamp = kClock && lane == 0 ? clk + 6 * static_cast<size_t>(b) : nullptr;
  if (stamp) stamp[0] = clock64();
  WarpSmem<N>& sm = s_warp[warp];
  float* tri = sm.u.in.tri;
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
        sm.u.in.row[a][p] = mn[e][a];
        sm.u.in.row[3 + a][p] = -mx[e][a];
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
  if (stamp) stamp[1] = clock64();

  // 2. codes and the sort
  u64 key[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = e * 32 + lane;
    const unsigned code = tbvh::morton30(mn[e], mx[e], smin, safe);
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

  if (stamp) stamp[2] = clock64();

  // 3. sorted leaves, deltas, leaf ranges and children
  __syncwarp();  // the leaf rows are complete
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
        leaf[e][r] = sm.u.in.row[r][prim[e]];
        sm.key[r][k] = min_key(leaf[e][r]);
      }
    }
    const unsigned code = static_cast<unsigned>(key[e] >> 6);
    unsigned next = __shfl_down_sync(kFull, code, 1);
    if (e + 1 < E) {  // lane 31's neighbour is lane 0 of the next slot row
      const unsigned wrap = __shfl_sync(kFull, static_cast<unsigned>(key[E - 1] >> 6), 0);
      if (lane == 31) next = wrap;
    }
    dlt[e] = tbvh::remapped_delta(code, next, k);
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
  __syncwarp();  // the keys are complete, the mesh and the leaf rows dead
  if (stamp) stamp[3] = clock64();

  // 4. refit
  int acc[E][6];
  if (E == 1 || M <= kWalkMax) {  // short meshes: a walk over each node's leaves
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = e * 32 + lane;
      if (i < m) {
#pragma unroll
        for (int r = 0; r < 6; ++r) acc[e][r] = INT_MAX;
        for (int t = first[e]; t <= last[e]; ++t) {
#pragma unroll
          for (int r = 0; r < 6; ++r) acc[e][r] = min(acc[e][r], sm.key[r][t]);
        }
      }
    }
  } else {
    // the in-block prefix and suffix mins of the sorted leaves' keys (three
    // shuffles each within groups of 8 lanes) and a min table over the
    // blocks; a range across blocks is the suffix of its first block, the
    // prefix of its last and two windows over the blocks between, a range
    // inside one block a walk of at most 8 keys
    const int sub = lane & 7;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = e * 32 + lane;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        int p = k < M ? min_key(leaf[e][r]) : INT_MAX, q = p;
#pragma unroll
        for (int d = 1; d < 8; d <<= 1) {
          const int up = __shfl_up_sync(kFull, p, d, 8), dn = __shfl_down_sync(kFull, q, d, 8);
          if (sub >= d) p = min(p, up);
          if (sub + d < 8) q = min(q, dn);
        }
        sm.u.fit.pre[r][k] = p;
        sm.u.fit.suf[r][k] = q;
        if (sub == 0) sm.u.fit.blk[0][r][k >> 3] = q;
      }
    }
#pragma unroll
    for (int lvl = 1; lvl < 3; ++lvl) {
      __syncwarp();
      for (int c = lane; c < 6 * NB; c += 32) {
        const int r = c / NB, x = c % NB;
        if (x + (1 << lvl) <= NB)
          sm.u.fit.blk[lvl][r][x] =
              min(sm.u.fit.blk[lvl - 1][r][x], sm.u.fit.blk[lvl - 1][r][x + (1 << (lvl - 1))]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = e * 32 + lane;
      if (i < m) {
        const int f = first[e], l = last[e], bf = f >> 3, bl = l >> 3;
        if (bf == bl) {
#pragma unroll
          for (int r = 0; r < 6; ++r) acc[e][r] = INT_MAX;
          for (int t = f; t <= l; ++t) {
#pragma unroll
            for (int r = 0; r < 6; ++r) acc[e][r] = min(acc[e][r], sm.key[r][t]);
          }
        } else {
#pragma unroll
          for (int r = 0; r < 6; ++r) acc[e][r] = min(sm.u.fit.suf[r][f], sm.u.fit.pre[r][l]);
          if (bl - bf >= 2) {  // the blocks between: two windows of 2^k blocks
            const int a = bf + 1, z = bl - 1, k = 31 - __clz(z - a + 1);
#pragma unroll
            for (int r = 0; r < 6; ++r)
              acc[e][r] = min(acc[e][r], min(sm.u.fit.blk[k][r][a],
                                             sm.u.fit.blk[k][r][z - (1 << k) + 1]));
          }
        }
      }
    }
  }
  __syncwarp();
  if (stamp) stamp[4] = clock64();

  // 5. the outputs
  float* out = packed_t + static_cast<size_t>(b) * 6 * W;
  int* lo = left + static_cast<size_t>(b) * W;
  int* ro = right + static_cast<size_t>(b) * W;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    if (i < m) {
      const int fill = last[e] - first[e] + 1 < M ? min_key(kBig) : INT_MAX;
#pragma unroll
      for (int r = 0; r < 6; ++r) out[r * W + i] = from_min_key(min(acc[e][r], fill));
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
  if (stamp) stamp[5] = clock64();
}

template <int E>
void launch(const float* tris, int B, int M, float* packed_t, int* left, int* right, int* root,
            long long* clk, cudaStream_t stream) {
  const int grid = (B + kWarps - 1) / kWarps;
  if (clk)
    batched_build_warp<E, true><<<grid, kWarps * 32, 0, stream>>>(tris, B, M, packed_t, left,
                                                                   right, root, clk);
  else
    batched_build_warp<E, false><<<grid, kWarps * 32, 0, stream>>>(tris, B, M, packed_t, left,
                                                                    right, root, clk);
}

}  // namespace

// tris f32[B, M, 3, 3]; packed_t f32[B, 6, 2M - 1]; left, right i32[B, 2M - 1];
// root i32[B]; clk i64[B, 6] (lane 0's phase clocks, a row a mesh) or null
extern "C" int tbvh_batched_build(const float* tris, int B, int M, float* packed_t,
                                  int* left, int* right, int* root, long long* clk,
                                  cudaStream_t stream) {
  if (B < 1 || M < 2 || M > kMaxPrims) return (int)cudaErrorInvalidValue;
  if (M <= 32)
    launch<1>(tris, B, M, packed_t, left, right, root, clk, stream);
  else
    launch<2>(tris, B, M, packed_t, left, right, root, clk, stream);
  return (int)cudaGetLastError();
}
