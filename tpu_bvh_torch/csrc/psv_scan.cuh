// The one-launch psv/nsv scan shared by threshold_scan.cu (B12/B13, B14),
// scan32.cu (B1, B16's two halves) and child_scan.cu (B15). They differ
// only in how a row's delta is read, in what each row writes (the `Op` of
// `launch`) and, for B15 (an Op with kLe), in the <= answers and a scatter
// after a second grid sync.
//
// Input: deltas d[m] with values in [0, 63]. For every row i and q = d[i]:
//   psv(i) = 64 j + d[j] for the last j < i with d[j] < q, -1 if none;
//   nsv(i) = 64 j + d[j] for the first j > i with d[j] < q, kBig if none.
// The packed key grows with j, so "last" is a max and "first" a min, as
// in tpu_bvh/ops/pallas/threshold_core.py. An Op with kLe also takes
//   pl(i) = the same as psv with d[j] <= q, nl(i) = the same as nsv;
// d[j] <= q is d[j] < q + 1, so these are the threshold q + 1 of the same
// scans (the equal rows join the warp's mask: the comparator yields them),
// and at q = 63 every row hits: the neighbouring rows.
//
// Design: one cooperative launch of a persistent grid.
//  * Bit-sliced masks. A warp takes 6 ballots, one per bit plane of d. A
//    lane then finds "the rows j of this warp with d[j] < q" for any q
//    with a 6-step comparator over the planes, most significant bit
//    first: where q's bit is 1, the rows still equal to q with a 0 there
//    become less; the equal rows narrow to those with q's bit. A lane
//    builds three such masks: for thresholds lane and lane + 32 (its
//    warp's last and first hitting row at all 64 thresholds) and for its
//    own row's q. The TPU's [64, rows] threshold plane is never built:
//    6 ballots and about 90 integer operations a lane stand for it.
//  * Tiles of kTile rows, one a thread, are dealt to the blocks in
//    contiguous runs. Phase 1, per tile: the warps' last and first hitting
//    rows at every threshold; their exclusive scans over the tile's warps
//    and the tile's totals (a key grows with its row, so the max over
//    earlier warps is the last earlier warp with a hit: one ballot and a
//    shuffle, no scan); then each row's answer within its tile (the
//    nearest set bit of its own mask in its warp, else the scan at q),
//    parked in two of the outputs; per block its totals and a 64-bit mask
//    of the thresholds it hits. One grid sync. Phase 2: a block's carry-in
//    at threshold v is the total of the last earlier block that hits v
//    (psv) and of the first later one (nsv), found by ballots over the
//    blocks' masks, 32 blocks a step; its tiles' totals are rewritten in
//    place as exclusive carries. Phase 3: a row without an answer in its
//    tile takes its tile's carry at q, and the Op writes the row. With
//    kLe, a second grid sync, then phase 4: the Op's scatter, a row at a
//    time (each row reads the answers other rows wrote in phase 3).
//  * The grid is the one the card holds resident (occupancy x SMs, at most
//    one block a tile and kMaxBlocks). A grid that cannot be resident is an
//    error.
// Compares and bit operations only: every output is exact.
//
// Scratch: `agg` holds (4 * 64 + 32) * nt ints, nt = ceil(m / kTile): the
// tiles' totals for psv and nsv, then the blocks' totals and hit masks
// (at most nt blocks; a mask a 128-byte line, so that the grid's reads of
// them after the sync spread over the L2); nothing needs clearing.

#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

// Internal linkage: two sources include this header, and each needs its
// own copy of the kernels (a __global__ has a host stub).
namespace psv {
namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 1024;  // rows per tile and threads per block
constexpr int kWarps = kTile / 32;
constexpr int kV = 64;  // thresholds
constexpr int kMaxBlocks = 1024;  // blocks a grid may have (the block masks in Smem)
constexpr int kKeep = 2;  // tiles a block whose rows and carries stay on chip for phase 3
constexpr int kMaskStride = 16;  // a block's hit mask owns a 128-byte line of scratch
constexpr int kBig = INT_MAX;
constexpr int kPad = 63;  // the delta of a row past the end: below no threshold
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  // per tile (two buffers, so a tile's rows read one while the next tile
  // fills the other), warp and threshold: the last and the first hitting
  // row, then in place the exclusive scans over the tile's warps; the pad
  // column keeps a warp's column reads off one bank
  int P[2][kWarps][kV + 1];
  int N[2][kWarps][kV + 1];
  unsigned long long mask[kMaxBlocks];  // per block: bit v set where it has a row with d < v
  int hit[kV];
  int carryP[kKeep][kV];  // the exclusive carries of the block's first kKeep tiles
  int carryN[kKeep][kV];
};

// Bit j is set where row j of this warp has d < q, and in `eq` where it
// has d == q; plane[b] is the ballot of bit b of d.
__device__ __forceinline__ unsigned compare(const unsigned (&plane)[6], int q, unsigned& eq) {
  unsigned lt = 0u;
  eq = kFull;
#pragma unroll
  for (int b = 5; b >= 0; --b) {
    const unsigned qb = 0u - ((unsigned)(q >> b) & 1u);  // all ones where q's bit b is 1
    lt |= eq & ~plane[b] & qb;
    eq &= ~(plane[b] ^ qb);
  }
  return lt;
}

// The packed key of the nearest set bit of mk before (after) this lane in
// its warp, -1 (kBig) where none; `base` is the warp's first row.
__device__ __forceinline__ int before_key(unsigned mk, int d, int base) {
  const int lane = threadIdx.x & 31;
  const int j = 31 - __clz(mk & ((1u << lane) - 1u));
  const int dj = __shfl_sync(kFull, d, j & 31);
  return j >= 0 ? 64 * (base + j) + dj : -1;
}

__device__ __forceinline__ int after_key(unsigned mk, int d, int base) {
  const int lane = threadIdx.x & 31;
  const int j = __ffs(mk & ~((2u << lane) - 1u)) - 1;
  const int dj = __shfl_sync(kFull, d, j & 31);
  return j >= 0 ? 64 * (base + j) + dj : kBig;
}

__device__ __forceinline__ void bit_planes(int d, unsigned (&plane)[6]) {
#pragma unroll
  for (int b = 0; b < 6; ++b) plane[b] = __ballot_sync(kFull, (d >> b) & 1);
}

// This warp's last and first hitting row, packed, at thresholds lane and
// lane + 32, into its row of P and N; `base` is the warp's first row. The
// two thresholds' comparators differ only in bit 5, so they run together.
__device__ __forceinline__ void warp_aggregates(const unsigned (&plane)[6], int d, int base,
                                                int (*P)[kV + 1], int (*N)[kV + 1]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned lt[2] = {0u, ~plane[5]}, eq[2] = {~plane[5], plane[5]};
#pragma unroll
  for (int b = 4; b >= 0; --b) {
    const unsigned qb = 0u - (((unsigned)lane >> b) & 1u);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lt[h] |= eq[h] & ~plane[b] & qb;
      eq[h] &= ~(plane[b] ^ qb);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned mk = lt[h];
    const int last = 31 - __clz(mk), first = __ffs(mk) - 1;  // -1 where mk == 0
    const int dl = __shfl_sync(kFull, d, last & 31);
    const int df = __shfl_sync(kFull, d, first & 31);
    P[warp][lane + 32 * h] = last < 0 ? -1 : 64 * (base + last) + dl;
    N[warp][lane + 32 * h] = first < 0 ? kBig : 64 * (base + first) + df;
  }
}

// `Op` reads a row's delta (`delta(i)`, i < m, in [0, 63]) and writes a
// row's answers (`write(i, d, psv, nsv)`; with `Op::kLe`,
// `write(i, d, psv, nsv, pl, nl)` and then `scatter(i)` after a second
// grid sync).
template <class Op>
__device__ __forceinline__ int load(const Op& op, int t, int m) {
  const int i = t * kTile + (int)threadIdx.x;
  return i < m ? op.delta(i) : kPad;
}

// pp and pn hold each row's answer within its tile (-1 / kBig where the
// tile has none) between phases 1 and 3 for the tiles past a block's first
// kKeep (those stay in registers); two of the Op's own outputs serve, and
// with kLe ppl and pnl hold the <= answers.
// Where clk is not null, thread 0 of block b writes its SM's clock64 to
// clk[5 b + k] at the start (k = 0), when the block's phase 1 is done (1),
// after the grid sync (2), after phase 2 (3) and after phase 3 (4).
template <class Op>
__global__ void __launch_bounds__(kTile)
    scan_kernel(Op op, int m, int nt, int* __restrict__ agg, int* pp, int* pn, int* ppl,
                int* pnl, long long* clk) {
  __shared__ Smem s;
  const int G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = (int)((long long)nt * b / G), t1 = (int)((long long)nt * (b + 1) / G);
  int* aggP = agg;
  int* aggN = agg + (size_t)nt * kV;
  int* blkP = agg + 2 * (size_t)nt * kV;
  int* blkN = blkP + (size_t)G * kV;
  unsigned long long* blkMask = reinterpret_cast<unsigned long long*>(blkN + (size_t)G * kV);
  if (clk && tid == 0) clk[5 * b] = clock64();

  // phase 1: per tile, the warps' aggregates, their exclusive scans over
  // the tile's warps (warp w scans thresholds 2w and 2w + 1) and the
  // tile's totals, then each row's answer within the tile
  int bp[2] = {-1, -1}, bn[2] = {kBig, kBig};
  static_assert(kKeep == 2, "phases 1 and 3 name the two kept tiles");
  int kd[kKeep], kp[kKeep], kn[kKeep];  // the first kKeep tiles' rows: d and answers
  int kpl[kKeep], knl[kKeep];  // and their <= answers (kLe)
  int d = load(op, t0, m);
  for (int t = t0; t < t1; ++t) {
    const int dn = t + 1 < t1 ? load(op, t + 1, m) : kPad;
    const int base = t * kTile + warp * 32, i = base + lane;
    int(*P)[kV + 1] = s.P[t & 1];
    int(*N)[kV + 1] = s.N[t & 1];
    unsigned plane[6];
    bit_planes(d, plane);
    warp_aggregates(plane, d, base, P, N);
    unsigned eq;
    const unsigned mk = compare(plane, d, eq);  // this row's hits in its warp
    const int wp = before_key(mk, d, base), wn = after_key(mk, d, base);
    int wpl = -1, wnl = kBig;  // kLe: the hits of d <= q, the equal rows too
    if constexpr (Op::kLe) {
      wpl = before_key(mk | eq, d, base);
      wnl = after_key(mk | eq, d, base);
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // lane w' holds warp w''s last / first hit at v
      const int v = 2 * warp + h;
      const int p = P[lane][v], n = N[lane][v];
      // keys grow with the row, so the max over earlier warps is the last
      // earlier warp with a hit, the min over later ones the first later
      const unsigned hit = __ballot_sync(kFull, p >= 0);
      const int wb = 31 - __clz(hit & ((1u << lane) - 1u));
      const int wa = __ffs(hit & ~((2u << lane) - 1u)) - 1;
      const int pe = __shfl_sync(kFull, p, wb & 31), ne = __shfl_sync(kFull, n, wa & 31);
      const int tp = __shfl_sync(kFull, p, (31 - __clz(hit)) & 31);  // -1 where no warp hits
      const int tn = __shfl_sync(kFull, n, (__ffs(hit) - 1) & 31);  // kBig where none
      P[lane][v] = wb >= 0 ? pe : -1;
      N[lane][v] = wa >= 0 ? ne : kBig;
      if (lane == 0) {
        aggP[t * kV + v] = tp;
        aggN[t * kV + v] = tn;
      }
      bp[h] = max(bp[h], tp);
      bn[h] = min(bn[h], tn);
    }
    __syncthreads();
    const int p = wp >= 0 ? wp : P[warp][d];
    const int n = wn != kBig ? wn : N[warp][d];
    int pl = -1, nl = kBig;
    if constexpr (Op::kLe) {  // threshold d + 1; d = 63 takes its neighbours in phase 3
      const int q1 = d + 1 < kV ? d + 1 : kV - 1;
      pl = wpl >= 0 ? wpl : P[warp][q1];
      nl = wnl != kBig ? wnl : N[warp][q1];
    }
    if (t == t0) {
      kd[0] = d, kp[0] = p, kn[0] = n, kpl[0] = pl, knl[0] = nl;
    } else if (t == t0 + 1) {
      kd[1] = d, kp[1] = p, kn[1] = n, kpl[1] = pl, knl[1] = nl;
    } else if (i < m) {
      pp[i] = p;
      pn[i] = n;
      if constexpr (Op::kLe) {
        ppl[i] = pl;
        pnl[i] = nl;
      }
    }
    d = dn;  // no barrier: the next tile fills the other buffer
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      blkP[b * kV + 2 * warp + h] = bp[h];
      blkN[b * kV + 2 * warp + h] = bn[h];
      s.hit[2 * warp + h] = bp[h] >= 0;
    }
  }
  __syncthreads();
  if (clk && tid == 0) clk[5 * b + 1] = clock64();
  if (warp == 0) {
    const unsigned lo = __ballot_sync(kFull, s.hit[lane]), hi = __ballot_sync(kFull, s.hit[lane + 32]);
    if (lane == 0) blkMask[b * kMaskStride] = lo | (unsigned long long)hi << 32;
  }
  cg::this_grid().sync();
  if (clk && tid == 0) clk[5 * b + 2] = clock64();

  // phase 2: per threshold, the block's carry-in is the total of the last
  // earlier block with a hit (psv) and of the first later one (nsv), found
  // by ballots over the blocks' masks, 32 blocks a step; then the block's
  // tiles' exclusive carries, in place and for its first kKeep tiles in
  // Smem. Lanes 0-3 of warp w run one chain each, psv (even lanes,
  // forward) and nsv (odd lanes, backward) of thresholds 2w and 2w + 1,
  // whose first 8 tile totals load beside the masks.
  for (int c = tid; c < G; c += kTile) s.mask[c] = __ldcg(&blkMask[c * kMaskStride]);
  const bool fwd = (lane & 1) == 0;
  const int vc = 2 * warp + ((lane >> 1) & 1), nk = t1 - t0;
  int* const a = fwd ? aggP : aggN;
  const int none = fwd ? -1 : kBig;
  int x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int t = fwd ? t0 + k : t1 - 1 - k;
    x[k] = lane < 4 && k < nk ? a[t * kV + vc] : none;
  }
  __syncthreads();
  int cin[4];  // lane 2h (psv) and 2h + 1 (nsv) of threshold 2 warp + h
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v = 2 * warp + h;
    int cp = -1, cn = -1;
    for (int top = b - 1; top >= 0 && cp < 0; top -= 32) {
      const int c = top - lane;
      const unsigned bal = __ballot_sync(kFull, c >= 0 && ((s.mask[c] >> v) & 1ull));
      if (bal) cp = top - (__ffs(bal) - 1);
    }
    for (int bot = b + 1; bot < G && cn < 0; bot += 32) {
      const int c = bot + lane;
      const unsigned bal = __ballot_sync(kFull, c < G && ((s.mask[c] >> v) & 1ull));
      if (bal) cn = bot + __ffs(bal) - 1;
    }
    cin[2 * h] = cp >= 0 ? __ldcg(&blkP[cp * kV + v]) : -1;
    cin[2 * h + 1] = cn >= 0 ? __ldcg(&blkN[cn * kV + v]) : kBig;
  }
  if (lane < 4) {
    int c = lane == 0 ? cin[0] : lane == 1 ? cin[1] : lane == 2 ? cin[2] : cin[3];
    int(*keep)[kV] = fwd ? s.carryP : s.carryN;
    for (int k0 = 0; k0 < nk; k0 += 8) {
      if (k0 > 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = fwd ? t0 + k0 + k : t1 - 1 - k0 - k;
          x[k] = k0 + k < nk ? a[t * kV + vc] : none;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int t = fwd ? t0 + k0 + k : t1 - 1 - k0 - k;
        if (k0 + k < nk) {
          a[t * kV + vc] = c;
          if (t - t0 < kKeep) keep[t - t0][vc] = c;
        }
        c = fwd ? max(c, x[k]) : min(c, x[k]);
      }
    }
  }
  __syncthreads();

  if (clk && tid == 0) clk[5 * b + 3] = clock64();

  // phase 3: a row without an answer in its tile takes its tile's carry
  for (int t = t0; t < t1; ++t) {
    const int i = t * kTile + tid, r = t - t0;
    if (i >= m) break;
    int di, p, n, pl, nl;
    if (r == 0) {
      di = kd[0], p = kp[0], n = kn[0], pl = kpl[0], nl = knl[0];
    } else if (r == 1) {
      di = kd[1], p = kp[1], n = kn[1], pl = kpl[1], nl = knl[1];
    } else {
      di = op.delta(i), p = pp[i], n = pn[i];
      if constexpr (Op::kLe) pl = ppl[i], nl = pnl[i];
    }
    if (p < 0) p = r < kKeep ? s.carryP[r][di] : aggP[t * kV + di];
    if (n == kBig) n = r < kKeep ? s.carryN[r][di] : aggN[t * kV + di];
    if constexpr (Op::kLe) {
      if (di == kV - 1) {  // every row has d <= 63: the neighbours
        pl = i > 0 ? 64 * (i - 1) + op.delta(i - 1) : -1;
        nl = i + 1 < m ? 64 * (i + 1) + op.delta(i + 1) : kBig;
      } else {
        if (pl < 0) pl = r < kKeep ? s.carryP[r][di + 1] : aggP[t * kV + di + 1];
        if (nl == kBig) nl = r < kKeep ? s.carryN[r][di + 1] : aggN[t * kV + di + 1];
      }
      op.write(i, di, p, n, pl, nl);
    } else {
      op.write(i, di, p, n);
    }
  }
  if constexpr (Op::kLe) {  // phase 4, once every row's answers are written
    cg::this_grid().sync();
    for (int t = t0; t < t1; ++t) {
      const int i = t * kTile + tid;
      if (i >= m) break;
      op.scatter(i);
    }
  }
  if (clk) {
    __syncthreads();
    if (tid == 0) clk[5 * b + 4] = clock64();
  }
}

// Blocks of scan_kernel<Op> the card holds at once on the current device
// (occupancy x SMs), found once; 0 if none or no cooperative launch.
template <class Op>
cudaError_t resident_blocks(int* blocks, int* per_sm, int* sms) {
  static int dev_seen = -1, per_sm_seen = 0, sms_seen = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_seen) {
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms_seen, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_seen, scan_kernel<Op>, kTile, 0);
    if (err != cudaSuccess) return err;
    if (!coop) per_sm_seen = 0;
    dev_seen = dev;
  }
  *per_sm = per_sm_seen;
  *sms = sms_seen;
  *blocks = per_sm_seen * sms_seen;
  return cudaSuccess;
}

// The grid of a launch over m rows: {blocks, most tiles a block, blocks an
// SM, SMs}.
template <class Op>
cudaError_t grid_of(int m, int* out) {
  int blocks, per_sm, sms;
  const cudaError_t err = resident_blocks<Op>(&blocks, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  const int nt = (m + kTile - 1) / kTile;
  out[0] = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  if (out[0] > nt) out[0] = nt;
  out[1] = out[0] > 0 ? (nt + out[0] - 1) / out[0] : 0;
  out[2] = per_sm;
  out[3] = sms;
  return cudaSuccess;
}

// One cooperative launch on `stream`; an error where the card cannot hold
// one block resident. pp and pn (with kLe also ppl and pnl) are i32[m]
// arrays of the Op's, which its write must leave in place or overwrite
// only at its own row.
template <class Op>
cudaError_t launch(Op op, int m, int* agg, int* pp, int* pn, long long* clk,
                   cudaStream_t stream, int* ppl = nullptr, int* pnl = nullptr) {
  int g[4];
  cudaError_t err = grid_of<Op>(m, g);
  if (err != cudaSuccess) return err;
  if (g[0] < 1) return cudaErrorCooperativeLaunchTooLarge;
  int nt = (m + kTile - 1) / kTile;
  void* args[] = {&op, &m, &nt, &agg, &pp, &pn, &ppl, &pnl, &clk};
  return cudaLaunchCooperativeKernel((const void*)scan_kernel<Op>, dim3(g[0]), dim3(kTile), args,
                                     0, stream);
}

}  // namespace
}  // namespace psv
