// The BVH4 collapse's prep and coarse stage: B3's input rows (P1,
// `collapse_prep_kernel`) and the long nodes' states, seeds, claims and
// coarse outputs scattered into them (P2, `collapse_coarse_kernel`).
//
// Replaces no TPU kernel: the JAX package computes these two stages with
// XLA ops around collapse_block_pallas (tpu_bvh/ops/collapse_fast.py). The
// port's plain version is `_prepare` in tpu_bvh_torch/ops/collapse_fast.py,
// which the CPU runs; the two kernels write the same rows bit for bit. The
// rows are B3's contract (tpu_bvh_torch/ops/collapse_block.py): meta,
// node8 and leaf8 i32[8, W] and carr i32[32, W], W = n, one buffer
// i32[56, W] in that order. A node is long when its leaf range exceeds
// S_LEN leaves; the long nodes form an ancestor-closed crown.
//
// P1, one launch over the W lanes, a tile of kTile lanes a block of
// kThreads threads (two lanes a thread, lane tile + k * kThreads + thread):
//  * lane i writes column i of every row: meta rows 0-3 (the area bits of
//    internal node i, with the plain path's separately rounded products
//    and sums, since those bits decide which child expands; left, right,
//    parent), 5 (the short flag) and 7 (leaf i's parent), rows 4 and 6 as
//    the background (_UNK << 23 and 0), node8 and leaf8 (the box bits and
//    two zero rows), and carr's background (-1 in rows 0-3, 0 in 4-31);
//    the lane past the internal nodes takes the padding (0, -1, -1, -1);
//  * the long flags go through a single-pass scan with decoupled
//    look-back, as B9 (ploc_round.cu) and B11 (plane_scan.cu) run it: a
//    block draws its tile from an atomic ticket in scan order (every tile
//    before it belongs to a running block), counts its long lanes with one
//    ballot a warp, and publishes the count at once; it writes its columns
//    and only then walks back over its predecessors' words (most of them
//    inclusive by then) and publishes its inclusive count. A word is
//    (epoch << 34 | flag << 32 | count), the epoch the wrapper's count of
//    launches, so no memset clears the words;
//  * rank[i] = the long nodes before internal node i (-1 where i is
//    short), ids[rank[i]] = i (the long ids in increasing order, as the
//    plain path's sort gives them) and, from the last tile, the long count.
// Bound on the card: bytes. It reads 24 B of box a node over the 2n - 1
// nodes, left, right, parent, first and last of the internal nodes and the
// leaves' parents (72 B a lane), and writes the 56 rows (224 B a lane),
// rank and the ids: about 1.2 GB at n = 4M.
//
// P2, one cooperative launch (a resident grid, striding over the coarse
// capacity `cap`; lanes at or past the long count are skipped: no lane
// below it points at them, since the crown is ancestor-closed, so the rows
// do not depend on the capacity and a chain-shaped crown runs at cap = m
// in the same launch). Coarse lane j is long node x = ids[j]. Phases, with
// a grid sync after each:
//   A: the two largest-area-child expansions of x (B3's rule, every coarse
//      node active), its parent's rank;
//   B: x's transition table from its parent's e1, e2 and its
//      grandparent's e2, packed as ptr * 64 + table (the root: itself);
//   the six pointer-doubling trips of `_prepare` in compacted space, each
//   reading one buffer and writing the other;
//   C: own_inc, x's nearest wide ancestor, inclusive;
//   D: the scatter: x's seed (state << 23 | e2 + 1) and own (own_pc + 1)
//      into meta rows 4 and 6; the seeds and own of x's short internal
//      children (a long child's column is written by its own lane, with
//      the values its parent would give it); and, where x is wide, its 30
//      coarse outputs (slots, count, the wide flag, the slot boxes) into
//      its carr column. Every other carr column keeps P1's background,
//      which is what the plain path scatters there, so every column is
//      written by one lane.
// Scratch written in the launch is read through the L2 (__ldcg): other
// blocks wrote it before the grid sync.
// Bound on the card: bytes, per long node its id, links, parent's rank and
// its children's areas and links read and its seed and own written; the
// seeds of its short children; 30 words and 6 box words a slot of a wide
// one (utils/work.collapse_prep). About 186K long nodes at n = 4M.
//
// Compares, selects and the area's float products only: every output is
// exact (nvcc --fmad=false, and the _rn intrinsics say so again).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kSLen = 33;  // collapse_block.S_LEN
constexpr int kWide = 0, kE1 = 1, kE2 = 2, kUnk = 3;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- P1

constexpr int kTile = 1024;  // lanes a block: collapse_fast._PREP_TILE
constexpr int kThreads = 512;
constexpr int kItems = kTile / kThreads;  // lanes a thread
constexpr int kWarps = kThreads / 32;
static_assert(kItems * kWarps == 32, "one warp scans the (lane group, warp) counts");
constexpr int kRows = 56;  // meta 8, node8 8, leaf8 8, carr 32
constexpr int kNode8 = 8, kLeaf8 = 16, kCarr = 24;
constexpr unsigned kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ unsigned long long word(unsigned epoch, unsigned flag, int count) {
  return ((unsigned long long)epoch << 34) | ((unsigned long long)flag << 32) | (unsigned)count;
}

// max(x, 0) as torch.clamp(x, min=0.0) gives it: -0.0 and NaN pass through
__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

// the surface area's bits of a packed box (min xyz, -max xyz), in the
// plain path's order: 2 * ((ex*ey + ex*ez) + ey*ez)
__device__ __forceinline__ int area_bits(const int (&box)[6]) {
  float e[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    e[k] = clamp0(__fsub_rn(-__int_as_float(box[3 + k]), __int_as_float(box[k])));
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(e[0], e[1]), __fmul_rn(e[0], e[2])),
                            __fmul_rn(e[1], e[2]));
  return __float_as_int(__fmul_rn(2.0f, s));
}

__global__ void __launch_bounds__(kThreads)
    collapse_prep_kernel(const int* __restrict__ pk, const int* __restrict__ left,
                         const int* __restrict__ right, const int* __restrict__ parent,
                         const int* __restrict__ first, const int* __restrict__ last, int n,
                         int* __restrict__ rows, int* __restrict__ rank, int* __restrict__ ids,
                         int* __restrict__ count, unsigned long long* status, int* ticket,
                         unsigned epoch) {
  __shared__ int s_ex[kItems * kWarps];  // each (lane group, warp)'s long lanes before it
  __shared__ int s_b, s_total, s_prefix;
  const int m = n - 1, mm = 2 * n - 1;
  const int nb = (n + kTile - 1) / kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const int b = atomicAdd(ticket, 1);
    if (b == nb - 1) atomicExch(ticket, 0);  // every block has drawn
    s_b = b;
  }
  __syncthreads();
  const int b = s_b, lo = b * kTile;

  // the tile's long flags, counted a warp at a time and scanned by warp 0
  bool fl[kItems];
  unsigned bal[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = lo + k * kThreads + tid;
    fl[k] = i < m && last[i] - first[i] + 1 > kSLen;
    bal[k] = __ballot_sync(kFull, fl[k]);
    if (lane == 0) s_ex[k * kWarps + warp] = __popc(bal[k]);
  }
  __syncthreads();
  if (warp == 0) {
    const int v = s_ex[lane];
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    s_ex[lane] = x - v;
    const int total = __shfl_sync(kFull, x, 31);
    if (lane == 0) {
      s_total = total;
      volatile unsigned long long* st = status;
      st[b] = word(epoch, b == 0 ? kInclusive : kAggregate, total);
    }
  }

  // every column of the tile
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = lo + k * kThreads + tid;
    if (i >= n) break;
    const bool internal = i < m;
    int box[6], leaf[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      box[r] = internal ? pk[(size_t)r * mm + i] : 0;
      leaf[r] = pk[(size_t)r * mm + m + i];
    }
    int* col = rows + i;
    const auto put = [&](int r, int v) { col[(size_t)r * n] = v; };
    put(0, internal ? area_bits(box) : 0);
    put(1, internal ? left[i] : -1);
    put(2, internal ? right[i] : -1);
    put(3, internal ? parent[i] : -1);
    put(4, kUnk << 23);
    put(5, internal && !fl[k]);
    put(6, 0);
    put(7, parent[m + i]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      put(kNode8 + r, r < 6 ? box[r] : 0);
      put(kLeaf8 + r, r < 6 ? leaf[r] : 0);
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) put(kCarr + r, r < 4 ? -1 : 0);
  }

  // the long lanes before the tile: warp 0 walks back 32 tiles a step
  // until it meets an inclusive count (tile 0's is), then publishes its own
  if (warp == 0) {
    int ex = 0;
    if (b > 0) {
      const volatile unsigned long long* st = status;
      for (int j = b - 1;; j -= 32) {
        const int p = j - lane;  // lane 0 is the nearest predecessor
        unsigned long long w = 0;
        bool ready;
        do {
          if (p >= 0) w = st[p];
          ready = p < 0 || ((unsigned)(w >> 34) == epoch && ((w >> 32) & 3) != 0);
        } while (!__all_sync(kFull, ready));
        const unsigned incs = __ballot_sync(kFull, p >= 0 && ((w >> 32) & 3) == kInclusive);
        const int stop = incs ? __ffs(incs) - 1 : 31;  // the nearest inclusive count
        int c = (p >= 0 && lane <= stop) ? (int)(unsigned)w : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
        ex += c;
        if (incs) break;
      }
    }
    if (lane == 0) {
      if (b > 0) {
        volatile unsigned long long* st = status;
        st[b] = word(epoch, kInclusive, ex + s_total);
      }
      if (b == nb - 1) *count = ex + s_total;
      s_prefix = ex;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = lo + k * kThreads + tid;
    if (i >= m) break;
    const int r = s_prefix + s_ex[k * kWarps + warp] + __popc(bal[k] & ((1u << lane) - 1u));
    rank[i] = fl[k] ? r : -1;
    if (fl[k]) ids[r] = i;
  }
}

// ---------------------------------------------------------------- P2

constexpr int kCoarseThreads = 256;
constexpr int kTrips = 6;  // the pointer-doubling trips of `_prepare`
// scratch rows, each `cap` long (collapse_fast._COARSE_ROWS)
constexpr int kE1Row = 0, kE2Row = 1, kPRankRow = 2, kSlotRow = 3, kCountRow = 7, kPackA = 8,
              kPackB = 9, kOwnRow = 10;

__device__ __forceinline__ int apply_tbl(int tbl, int s) { return (tbl >> (2 * s)) & 3; }

struct Expansion {
  int s[4], count, e1, e2;  // the four slot ids, their count, e1, e2
};

// the two largest-area-child expansions of a node with children (s0, s1),
// B3's rule (csrc/collapse_block.cu: expand): the first max wins ties,
// area > 0 strictly, areas compared as i32 bits, -1 off the internal nodes
// (B3's reads its staged tile, this one global memory); written with
// selects so that nothing leaves the registers
__device__ Expansion expand(const int* __restrict__ area, const int* __restrict__ left,
                            const int* __restrict__ right, int m, int s0, int s1) {
  const auto acode = [&](int t) { return (t >= 0 && t < m) ? area[t] : -1; };
  const auto lft = [&](int t) { return (t >= 0 && t < m) ? left[t] : -1; };
  const auto rgt = [&](int t) { return (t >= 0 && t < m) ? right[t] : -1; };
  Expansion x = {{s0, s1, -1, -1}, 2, -1, -1};
  int a0 = acode(s0), a1 = acode(s1), a2 = -1;
  int l0 = lft(s0), l1 = lft(s1), l2 = -1;
  int r0 = rgt(s0), r1 = rgt(s1), r2 = -1;
  const bool pos1 = a1 > a0;
  const bool do1 = max(a0, a1) > 0;
  if (do1) {
    x.e1 = pos1 ? s1 : s0;
    const int c1l = pos1 ? l1 : l0, c1r = pos1 ? r1 : r0;
    const int na = acode(c1l), nl = lft(c1l), nr = rgt(c1l);
    if (pos1) {
      x.s[1] = c1l, a1 = na, l1 = nl, r1 = nr;
    } else {
      x.s[0] = c1l, a0 = na, l0 = nl, r0 = nr;
    }
    x.s[2] = c1r, a2 = acode(c1r), l2 = lft(c1r), r2 = rgt(c1r);
  }
  const int best2 = max(max(a0, a1), a2);
  if (best2 > 0) {
    const int pos2 = a0 == best2 ? 0 : (a1 == best2 ? 1 : 2);
    x.e2 = pos2 == 0 ? x.s[0] : (pos2 == 1 ? x.s[1] : x.s[2]);
    const int c2l = pos2 == 0 ? l0 : (pos2 == 1 ? l1 : l2);
    const int c2r = pos2 == 0 ? r0 : (pos2 == 1 ? r1 : r2);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (pos2 == k) x.s[k] = c2l;
    if (do1) x.s[3] = c2r;  // the slot after the last: 2 + do1
    else x.s[2] = c2r;
  }
  x.count = 2 + (do1 ? 1 : 0) + (best2 > 0 ? 1 : 0);
  return x;
}

__global__ void __launch_bounds__(kCoarseThreads)
    collapse_coarse_kernel(const int* __restrict__ pk, const int* __restrict__ left,
                           const int* __restrict__ right, const int* __restrict__ parent, int n,
                           const int* __restrict__ rank, const int* __restrict__ ids,
                           const int* __restrict__ count, int cap, int* sc,
                           int* __restrict__ meta, int* __restrict__ carr) {
  cg::grid_group grid = cg::this_grid();
  const int m = n - 1, mm = 2 * n - 1;
  const int K = min(*count, cap);
  const int j0 = blockIdx.x * blockDim.x + threadIdx.x, step = gridDim.x * blockDim.x;
  int* e1s = sc + (size_t)kE1Row * cap;
  int* e2s = sc + (size_t)kE2Row * cap;
  int* prk = sc + (size_t)kPRankRow * cap;
  int* slot = sc + (size_t)kSlotRow * cap;
  int* cnt = sc + (size_t)kCountRow * cap;
  int* pa = sc + (size_t)kPackA * cap;
  int* pb = sc + (size_t)kPackB * cap;
  int* own = sc + (size_t)kOwnRow * cap;

  // A: the expansions and the parents' ranks
  for (int j = j0; j < K; j += step) {
    const int x = ids[j];
    const Expansion e = expand(meta, left, right, m, left[x], right[x]);
    e1s[j] = e.e1;
    e2s[j] = e.e2;
#pragma unroll
    for (int k = 0; k < 4; ++k) slot[(size_t)k * cap + j] = e.s[k];
    cnt[j] = e.count;
    const int cp = parent[x];
    prk[j] = cp >= 0 ? rank[cp] : -1;
  }
  grid.sync();

  // B: each coarse node's table under its parent, packed with the parent's lane
  for (int j = j0; j < K; j += step) {
    const int p = __ldcg(prk + j);
    int v = j * 64;  // the root: itself, the constant table WIDE
    if (p >= 0) {
      const int x = ids[j];
      const int e2g = __ldcg(e2s + max(__ldcg(prk + p), 0));
      const int e1p = __ldcg(e1s + p), e2p = __ldcg(e2s + p);
      const int t_wide = x == e1p ? kE1 : (x == e2p ? kE2 : kWide);
      const int t_e1 = x == e2g ? kE2 : kWide;
      v = p * 64 + (t_wide | (t_e1 << 2));
    }
    pa[j] = v;
  }
  grid.sync();

  // the doubling: after the trips pa holds each lane's state in its low bits
  for (int trip = 0; trip < kTrips; ++trip) {
    const int* src = (trip & 1) ? pb : pa;
    int* dst = (trip & 1) ? pa : pb;
    for (int j = j0; j < K; j += step) {
      const int v = __ldcg(src + j), pulled = __ldcg(src + (v >> 6));
      const int fp = pulled & 63, f = v & 63;
      const int nf = apply_tbl(f, apply_tbl(fp, 0)) | (apply_tbl(f, apply_tbl(fp, 1)) << 2) |
                     (apply_tbl(f, apply_tbl(fp, 2)) << 4);
      dst[j] = (pulled & ~63) | nf;
    }
    grid.sync();
  }
  static_assert(kTrips % 2 == 0, "the last trip writes pa");

  // C: own_inc: WIDE -> itself; E1 -> its parent; E2 -> its parent if that
  // is wide, else its grandparent
  for (int j = j0; j < K; j += step) {
    const int st = __ldcg(pa + j) & 3, x = ids[j], cp = parent[x];
    int o = cp;
    if (st == kWide) {
      o = x;
    } else if (st == kE2) {
      const int ps = max(__ldcg(prk + j), 0);
      if ((__ldcg(pa + ps) & 3) == kE1) o = parent[ids[ps]];
    }
    own[j] = o;
  }
  grid.sync();

  // D: the scatter into meta rows 4 and 6 and carr
  for (int j = j0; j < K; j += step) {
    const int x = ids[j], st = __ldcg(pa + j) & 3, p = __ldcg(prk + j), ps = max(p, 0);
    const int e1 = __ldcg(e1s + j), e2 = __ldcg(e2s + j), e2p = __ldcg(e2s + ps);
    const int oi = __ldcg(own + j);
    meta[4 * (size_t)n + x] = st * (1 << 23) + (e2 + 1);
    meta[6 * (size_t)n + x] = (p >= 0 ? __ldcg(own + ps) : -1) + 1;
    const int kids[2] = {left[x], right[x]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = kids[h];
      if (c < 0 || c >= m || rank[c] >= 0) continue;  // a leaf, or a long child
      const int cs = st == kWide ? (c == e1 ? kE1 : (c == e2 ? kE2 : kWide))
                                 : (st == kE1 && c == e2p ? kE2 : kWide);
      meta[4 * (size_t)n + c] = cs << 23;  // its e2 + 1 = 0: a short node has no coarse e2
      meta[6 * (size_t)n + c] = oi + 1;
    }
    if (st != kWide) continue;
    const int c2 = cnt[j];
    int s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[k] = k < c2 ? slot[(size_t)k * cap + j] : -1;
      carr[(size_t)k * n + x] = s[k];
    }
    carr[4 * (size_t)n + x] = c2;
    carr[5 * (size_t)n + x] = 1;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < 6; ++r)
        carr[(size_t)(6 + 6 * k + r) * n + x] = s[k] >= 0 ? pk[(size_t)r * mm + s[k]] : 0;
  }
}

// blocks of the coarse kernel the card holds at once (occupancy x SMs),
// found once a device; 0 where it takes no cooperative launch
cudaError_t coarse_resident(int* blocks) {
  static int dev_seen = -1, blocks_seen = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_seen) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, collapse_coarse_kernel,
                                                          kCoarseThreads, 0);
    if (err != cudaSuccess) return err;
    blocks_seen = coop ? per_sm * sms : 0;
    dev_seen = dev;
  }
  *blocks = blocks_seen;
  return cudaSuccess;
}

}  // namespace

// pk: the Bvh2's packed boxes as i32 bits [6, 2n - 1]; left, right, parent
// i32[2n - 1]; first, last i32[n - 1]; rows: i32[56, n], every element
// written; rank i32[n - 1]; ids: i32[n - 1], the first `count` written;
// count: one int; status: ceil(n / kTile) u64 (zeros, or words of other
// epochs); ticket: one int, 0 before the first launch and reset by every
// launch; epoch in [1, 2^30), a new one each launch
extern "C" int tbvh_collapse_prep(const int* pk, const int* left, const int* right,
                                  const int* parent, const int* first, const int* last, int n,
                                  int* rows, int* rank, int* ids, int* count, void* status,
                                  int* ticket, int epoch, cudaStream_t stream) {
  collapse_prep_kernel<<<(n + kTile - 1) / kTile, kThreads, 0, stream>>>(
      pk, left, right, parent, first, last, n, rows, rank, ids, count,
      reinterpret_cast<unsigned long long*>(status), ticket, (unsigned)epoch);
  return (int)cudaGetLastError();
}

// after tbvh_collapse_prep on the same stream: rank, ids and count are its
// outputs, cap >= count; scratch: i32[11, cap]; meta and carr: rows 0-7 and
// 24-55 of its `rows`
extern "C" int tbvh_collapse_coarse(const int* pk, const int* left, const int* right,
                                    const int* parent, int n, const int* rank, const int* ids,
                                    const int* count, int cap, int* scratch, int* meta, int* carr,
                                    cudaStream_t stream) {
  int blocks;
  cudaError_t err = coarse_resident(&blocks);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int need = (cap + kCoarseThreads - 1) / kCoarseThreads;
  if (blocks > need) blocks = need;
  void* args[] = {&pk, &left, &right, &parent, &n, &rank, &ids, &count, &cap, &scratch, &meta,
                  &carr};
  return (int)cudaLaunchCooperativeKernel((const void*)collapse_coarse_kernel, dim3(blocks),
                                          dim3(kCoarseThreads), args, 0, stream);
}
