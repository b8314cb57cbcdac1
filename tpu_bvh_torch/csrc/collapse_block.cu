// Short-node phases of the fast BVH2 -> BVH4 collapse (single-pass LBVH).
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/collapse_block.py:
// collapse_block_pallas (_kernel). Same contract (layouts in
// tpu_bvh_torch/ops/collapse_block.py): for every lane i (boundary i,
// which also carries leaf i) it computes, for short nodes, the two
// largest-area-child expansions, the WIDE/E1/E2 state, the ownership
// claims and the slot AABBs, and passes the coarse rows through.
//
// Why the TPU kernel looks the way it does: a random gather there costs
// about 1.9 ms per full-array access, so it turns every pointer chase into
// strip-folded shift sweeps over VMEM blocks with a 256-lane halo. All of
// that reach is local: a short node's children, its short ancestors and
// the claims' chain hops lie within S_LEN + 2 lanes of it.
//
// Design: one launch. A block owns kTile lanes [t0, t0 + kTile) and stages
// the 8 meta rows of lanes [t0 - kHalo, t0 + kTile + kHalo) into shared
// memory with cp.async. Then, with a block barrier between phases:
//   A: for every staged lane, the expansion simulation (first max wins,
//      area > 0 strictly, areas compared as i32 bits); its e1, e2 and
//      e2_full (e2 at short lanes, the coarse e2 of meta row 4 elsewhere)
//      stay in shared memory;
//   B: for every staged internal lane, its step (its 3-state transition
//      table, from its parent's e1, e2 and its grandparent's e2_full, or
//      its terminal state where it is seeded); then, after a barrier, a
//      walk up its parent chain to the seeded terminal (a coarse node or a
//      child of one, or the root), composing the steps, one shared load a
//      hop; its state and packed claim row (claim | tag) stay in shared
//      memory. A short node's chain has at most S_LEN + 2 hops; a longer
//      one sets kErrChain;
//   C, D: for the block's own lanes, the claims (the first WIDE or seed
//      terminal among parent, grandparent, great-grandparent, walked only
//      as far as that first hit, so no read goes past a terminal), the
//      expansion's slot ids again, the slot AABBs loaded from node8 or
//      leaf8 at the slot ids, the coarse pass-through, and the outputs,
//      stored coalesced.
// Reads outside the staged window: the inputs (meta, node8, leaf8, carr)
// are read from global memory where a lane is not staged, which is always
// right; a computed row at a seeded or coarse lane depends only on that
// lane's meta and is computed in place. Any other read that leaves the
// window (a short lane's phase-A row, an unseeded lane's state) marks the
// walk that needed it unresolved; an output that depends on an unresolved
// value sets kErrWindow, and the wrapper raises. The kernel never
// truncates and never reads an unwritten shared slot.
// Everything is integer work, so the result equals the plain PyTorch
// version bit for bit.
//
// Bound on the card: bytes. What the function needs per lane: the 8 meta
// words, carr row 5 and 40 output words; carr's other 29 used rows only
// at the coarse wide lanes (a few percent), and 6 AABB words of node8 or
// leaf8 per slot of a short wide lane (their rows 6-7 are zero padding,
// copied through as the TPU kernel does). The halos add 2 kHalo lanes of
// meta a tile (25% at kTile 1024).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kSLen = 33;
constexpr int kWide = 0, kE1 = 1, kE2 = 2, kUnk = 3;
constexpr int kIdentity = 0 | (1 << 2) | (2 << 4);  // the table (0, 1, 2)
constexpr int kTile = 1024;   // lanes a block owns: collapse_block.TILE
constexpr int kHalo = 128;    // staged lanes on either side: collapse_block.HALO
constexpr int kThreads = 512;
constexpr int kSpan = kTile + 2 * kHalo;
// shared rows (each kSpan long): 0-7 meta, then phase A's and B's rows
constexpr int kRowE1 = 8, kRowE2 = 9, kRowE2f = 10, kRowStep = 11, kRowState = 12, kRowPk = 13;
constexpr int kRows = 14;
constexpr size_t kSmem = (size_t)kRows * kSpan * sizeof(int);
// states that phase B could not resolve: a read left the window, or the
// chain is longer than a short node's (the error flag is set for it)
constexpr int kOutside = -2, kBadChain = -3;
// error flag bits (collapse_block.ERR_CHAIN, ERR_WINDOW)
constexpr int kErrChain = 1;
constexpr int kErrWindow = 2;

__device__ __forceinline__ int apply_tbl(int tbl, int s) { return (tbl >> (2 * s)) & 3; }

__device__ __forceinline__ int dec(int pk) { return pk >= 0 ? (pk >> 2) - 1 : -1; }

struct Block {
  const int* __restrict__ meta;
  int W, m, w0, lo, hi;  // staged lanes [lo, hi) = [w0, w0 + kSpan) within [0, W)
  int* sm;

  __device__ bool staged(int t) const { return t >= lo && t < hi; }
  __device__ int& at(int r, int t) const { return sm[r * kSpan + (t - w0)]; }
  // input row r at lane t in [0, W): shared memory if staged, else global
  __device__ int in(int r, int t) const { return staged(t) ? at(r, t) : meta[(size_t)r * W + t]; }
  __device__ int pull(int r, int t) const { return (t >= 0 && t < m) ? in(r, t) : -1; }
  __device__ bool is_short(int z) const { return z < m && in(5, z) == 1; }
  __device__ int e2in(int z) const { return (in(4, z) & ((1 << 23) - 1)) - 1; }
  __device__ bool seeded(int t) const { return (in(4, t) >> 23) <= 2 || in(3, t) < 0; }
};

struct Expansion {
  int s0, s1, s2, s3, count, e1, e2;  // the four slot ids, their count, e1, e2

  __device__ int sid(int k) const { return k == 0 ? s0 : (k == 1 ? s1 : (k == 2 ? s2 : s3)); }
};

// the two largest-area-child expansions of lane z (only short lanes
// expand), written with selects so that nothing leaves the registers
__device__ Expansion expand(const Block& b, int z) {
  Expansion x = {b.in(1, z), b.in(2, z), -1, -1, 2, -1, -1};
  if (!b.is_short(z)) return x;
  const int m = b.m;
  auto acode = [&](int t) { return (t >= 0 && t < m) ? b.in(0, t) : -1; };
  int a0 = acode(x.s0), a1 = acode(x.s1), a2 = -1;
  int l0 = b.pull(1, x.s0), l1 = b.pull(1, x.s1), l2 = -1;
  int r0 = b.pull(2, x.s0), r1 = b.pull(2, x.s1), r2 = -1;
  // step 1: the first max wins ties, area > 0 strictly
  const bool pos1 = a1 > a0;
  const bool do1 = max(a0, a1) > 0;
  if (do1) {
    x.e1 = pos1 ? x.s1 : x.s0;
    const int c1l = pos1 ? l1 : l0, c1r = pos1 ? r1 : r0;
    const int na = acode(c1l), nl = b.pull(1, c1l), nr = b.pull(2, c1l);
    if (pos1) {
      x.s1 = c1l, a1 = na, l1 = nl, r1 = nr;
    } else {
      x.s0 = c1l, a0 = na, l0 = nl, r0 = nr;
    }
    x.s2 = c1r, a2 = acode(c1r), l2 = b.pull(1, c1r), r2 = b.pull(2, c1r);
  }
  // step 2 over slots 0..2 in slot order
  const int best2 = max(max(a0, a1), a2);
  if (best2 > 0) {
    const int pos2 = a0 == best2 ? 0 : (a1 == best2 ? 1 : 2);
    x.e2 = pos2 == 0 ? x.s0 : (pos2 == 1 ? x.s1 : x.s2);
    const int c2l = pos2 == 0 ? l0 : (pos2 == 1 ? l1 : l2);
    const int c2r = pos2 == 0 ? r0 : (pos2 == 1 ? r1 : r2);
    if (pos2 == 0) x.s0 = c2l;
    if (pos2 == 1) x.s1 = c2l;
    if (pos2 == 2) x.s2 = c2l;
    if (do1) x.s3 = c2r;  // the slot after the last: 2 + do1
    else x.s2 = c2r;
  }
  x.count = 2 + (do1 ? 1 : 0) + (best2 > 0 ? 1 : 0);
  return x;
}

// phase A's (e1, e2, e2_full) at internal lane z; false where z is short
// and not staged (a coarse lane's come from its own meta)
__device__ bool rows_a(const Block& b, int z, int& e1, int& e2, int& e2f) {
  if (!b.is_short(z)) {
    e1 = e2 = -1;
    e2f = b.e2in(z);
    return true;
  }
  if (!b.staged(z)) return false;
  e1 = b.at(kRowE1, z);
  e2 = b.at(kRowE2, z);
  e2f = b.at(kRowE2f, z);
  return true;
}

// the packed claim row of internal lane t whose state is `state`
__device__ int claim_row(const Block& b, int t, int state) {
  const int ownp1 = b.in(6, t);
  const int claim = state == kWide ? t : ownp1 - 1;
  return ownp1 > 0 ? (claim + 1) * 4 + 3 : (b.in(3, t) + 1) * 4 + min(state, 2);
}

// lane x's step of a chain walk: the seed terminal's state (kTerm set),
// kBadStep where the parent is no internal node, kOutStep where phase A's
// row at the parent or grandparent is not staged, else x's transition
// table given its parent's (e1, e2) and its grandparent's e2_full
constexpr int kTerm = 1 << 8, kBadStep = 1 << 9, kOutStep = 1 << 10;

__device__ int chain_step(const Block& b, int x) {
  const int m = b.m;
  const int seed = b.in(4, x) >> 23, par = b.in(3, x);
  if (seed <= 2 || par < 0) return kTerm | (seed <= 2 ? seed : kWide);
  if (par >= m) return kBadStep;
  int e1p, e2p, e2fp, e2g = -1, u1, u2;
  if (!rows_a(b, par, e1p, e2p, e2fp)) return kOutStep;
  const int gp = b.in(3, par);
  if (gp >= 0 && gp < m && !rows_a(b, gp, u1, u2, e2g)) return kOutStep;
  const int t_wide = x == e1p ? kE1 : (x == e2p ? kE2 : kWide);
  const int t_e1 = x == e2g ? kE2 : kWide;
  return t_wide | (t_e1 << 2);  // f(E2) = WIDE
}

// phase B at internal lane y: the composed tables along the parent chain,
// one staged step a hop (a lane outside the window takes its step in place)
__device__ int walk_state(const Block& b, int y, int* err) {
  int tbl = kIdentity, x = y;
  for (int hops = 0;; ++hops) {
    const int f = b.staged(x) ? b.at(kRowStep, x) : chain_step(b, x);
    if (f & kTerm) return apply_tbl(tbl, f & 3);
    if ((f & kBadStep) || hops == kSLen + 2) {
      atomicOr(err, kErrChain);
      return kBadChain;
    }
    if (f & kOutStep) return kOutside;
    tbl = apply_tbl(tbl, apply_tbl(f, 0)) | (apply_tbl(tbl, apply_tbl(f, 1)) << 2) |
          (apply_tbl(tbl, apply_tbl(f, 2)) << 4);
    x = b.in(3, x);
  }
}

// the packed claim row at lane t, as the plain version's pull (-1 off the
// internal lanes); a seeded lane's is computed in place
__device__ int pk_at(const Block& b, int t, int* err) {
  if (t < 0 || t >= b.m) return -1;
  if (b.seeded(t)) {
    const int seed = b.in(4, t) >> 23;
    return claim_row(b, t, seed <= 2 ? seed : kWide);
  }
  const int v = b.staged(t) ? b.at(kRowPk, t) : kOutside;
  if (v == kOutside) atomicOr(err, kErrWindow);
  return v >= 0 ? v : -1;
}

// the first WIDE (its id) or seed terminal (its claim) along the chain
// t0, dec(pk0), ...: three candidates, walked only up to the first hit
__device__ int first_wide(const Block& b, int t, int pk, int* err) {
  for (int k = 0;; ++k) {
    if (pk >= 0 && (pk & 3) == kWide) return t;
    if (pk >= 0 && (pk & 3) == 3) return (pk >> 2) - 1;
    if (k == 2) return -1;
    t = dec(pk);
    pk = pk_at(b, t, err);
  }
}

__global__ void __launch_bounds__(kThreads)
    collapse_block_kernel(const int* __restrict__ meta, const int* __restrict__ node8,
                          const int* __restrict__ leaf8, const int* __restrict__ carr, int W,
                          int m, int* __restrict__ err, int* __restrict__ outm,
                          int* __restrict__ outa) {
  extern __shared__ int sm[];
  const int t0 = blockIdx.x * kTile;
  Block b{meta, W, m, t0 - kHalo, max(t0 - kHalo, 0), min(t0 + kTile + kHalo, W), sm};
  for (int k = threadIdx.x; k < kSpan; k += kThreads) {
    const int z = b.w0 + k;
    if (!b.staged(z)) continue;
#pragma unroll
    for (int r = 0; r < 8; ++r) tbvh::cp_async4(&b.at(r, z), meta + (size_t)r * W + z);
  }
  tbvh::cp_async_wait_all();
  __syncthreads();

  // phase A: every staged lane
  for (int z = b.lo + threadIdx.x; z < b.hi; z += kThreads) {
    const Expansion x = expand(b, z);
    b.at(kRowE1, z) = x.e1;
    b.at(kRowE2, z) = x.e2;
    b.at(kRowE2f, z) = b.is_short(z) ? x.e2 : b.e2in(z);
  }
  __syncthreads();
  for (int x = b.lo + threadIdx.x; x < min(b.hi, m); x += kThreads) b.at(kRowStep, x) = chain_step(b, x);
  __syncthreads();

  // phase B: every staged internal lane
  for (int y = b.lo + threadIdx.x; y < b.hi; y += kThreads) {
    const int state = y < m ? walk_state(b, y, err) : kUnk;
    b.at(kRowState, y) = state;
    b.at(kRowPk, y) = y >= m ? -1 : (state >= 0 ? claim_row(b, y, state) : kOutside);
  }
  __syncthreads();

  // phases C and D: the block's own lanes
  const int t_end = min(t0 + kTile, W);
  for (int i = t0 + threadIdx.x; i < t_end; i += kThreads) {
    const bool is_int = i < m;
    int state = b.at(kRowState, i);
    if (state == kOutside) atomicOr(err, kErrWindow);
    const bool is_wide = is_int && state == kWide && b.is_short(i);
    const int parent = b.at(3, i), ownp1 = b.at(6, i), leafp = b.at(7, i);

    int claim_int = -1;
    if (is_wide && parent >= 0)
      claim_int = ownp1 > 0 ? ownp1 - 1 : first_wide(b, parent, pk_at(b, parent, err), err);
    int claim_leaf = -1;
    if (i < m + 1 && leafp >= 0) {
      // leaf lane i's parent is boundary i or i - 1 (any other: no row)
      const int pk_q = leafp == i ? pk_at(b, i, err) : (leafp == i - 1 ? pk_at(b, i - 1, err) : -1);
      claim_leaf = first_wide(b, leafp, pk_q, err);
    }

    const Expansion x = expand(b, i);
    const bool cw = carr[5 * (size_t)W + i] == 1;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      outm[(size_t)k * W + i] = cw ? carr[(size_t)k * W + i] : (is_wide ? x.sid(k) : -1);
    outm[4 * (size_t)W + i] = cw ? carr[4 * (size_t)W + i] : (is_wide ? x.count : 0);
    outm[5 * (size_t)W + i] = is_int ? state : kUnk;
    outm[6 * (size_t)W + i] = cw ? ownp1 - 1 : claim_int;
    outm[7 * (size_t)W + i] = claim_leaf;
    // the slot AABBs: all 32 loads first, then the 32 stores, so the
    // loads are in flight together
    int v[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int sid = x.sid(k);
      const int* src = (sid >= 0 && sid < m) ? node8 + sid : (sid >= m ? leaf8 + (sid - m) : nullptr);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (cw)
          v[k][r] = r < 6 ? carr[(size_t)(6 + 6 * k + r) * W + i] : 0;
        else
          v[k][r] = (is_wide && src) ? src[(size_t)r * W] : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < 8; ++r) outa[((size_t)k * 8 + r) * W + i] = v[k][r];
  }
}

}  // namespace

extern "C" int tbvh_collapse_block(const int* meta, const int* node8, const int* leaf8,
                                   const int* carr, int W, int m, int* err, int* outm,
                                   int* outa, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(collapse_block_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  collapse_block_kernel<<<(W + kTile - 1) / kTile, kThreads, kSmem, stream>>>(
      meta, node8, leaf8, carr, W, m, err, outm, outa);
  return (int)cudaGetLastError();
}
