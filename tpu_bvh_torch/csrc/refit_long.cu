// The anchored refit's long nodes (L), the LBVH tail's third launch.
//
// Replaces no TPU kernel: the JAX package answers the long nodes with XLA
// ops after refit_dense_pallas (tpu_bvh/ops/refit.py:_refit_anchored_fast,
// a payload sort of the long nodes under a budget, else the full table of
// _refit_full_table). Its plain version is refit.refit_long_reference; the
// two together with B2's tree mode equal refit._refit_anchored_packed
// joined with the leaf columns, bit for bit, on every input.
//
// After B2 (refit_dense.cu, the tree's mode) has written every internal
// node's dense union into nodes[:, :m], the leaf columns into nodes[:, m:],
// its level-4 rows t4 (t4[i] = the min of leaf columns [i, i + 16), past
// n - 1 as +3e38; a column's six words side by side) and its short flags,
// L overwrites every node whose flag is clear with the union of its leaf
// range [f, l] by the plain path's two-level query (a long range has more
// than R >= 15 leaves, so each end window lies inside it):
//   the two end windows t4[f] and t4[max(l - 15, 0)], and, where the range
//   holds whole 16-leaf blocks bf..bl (bf = ceil(f / 16), bl =
//   floor((l + 1) / 16) - 1), the min of those blocks; else a fill.
// Every min is over aabb.min_key's i32 keys (the float's total order with
// -0.0 < +0.0 and every NaN below all; integer min is order-free), and the
// answer goes back through from_min_key, as the plain path does. The block
// minima are t4 at every 16th column, taken as keys. The plain path takes
// the blocks' min from a doubling table over all of them; any grouping of
// the same blocks gives the same key.
//
// The plain path has two branches, and they differ only where a box
// coordinate passes the stencil's +3e38 fill or is a NaN. Under its budget
// of long nodes (cap = min(m, max(64, 4m / 3R)); the budget holds where cap
// = m or the count is at most cap) a long range with no whole block takes
// the +3e38 fill as its middle, and short nodes keep B2's union (which
// also takes +3e38 as a start value). Past the budget the full table gives
// every node its exact key-min. L counts the long nodes itself (each CTA
// its share, summed after the grid sync; no host read), and past the
// budget leaves the fill out of the long ranges and redoes, from the leaf
// columns in nodes[:, m:], each short node that B2 left at +3e38 or NaN.
//
// Design: one cooperative launch of a resident grid of 1024-thread CTAs
// and one grid sync. The blocks' min over bf..bl comes from two tiers:
// superblocks of kSuper blocks (16,384 leaves), each with a doubling table
// over its own blocks (built by one CTA in shared memory; levels 0..9 are
// written out, and level 10, the superblock's minimum, is not: two windows
// of 512 cover any range of its blocks), and a doubling table over the at
// most 256 superblock minima, which every CTA builds in its shared memory
// after the sync. A
// range inside one superblock takes two rows of its table; one that
// crosses takes its two partial superblocks (two rows each) and the whole
// ones between from the top table. Before the sync each CTA also compacts
// the long nodes of its chunk of nodes (a ballot a warp), so after it the
// long nodes' queries run side by side, one a thread.
// Bound on the card: bytes. It reads the flags (1 B a node) and the block
// minima (24 B a block), writes the superblock tables (24 B a block a
// level, 60 MB at n = 4M), and per long node reads its range, two t4
// windows and two to six table rows and writes its six words.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;  // a CTA; one block of a superblock a thread
constexpr int kBlock = 16;  // leaves a block minimum covers: t4's window
constexpr int kSuper = kThreads;  // blocks a superblock holds
constexpr int kLocal = 10;  // levels of a superblock's table kept: 0..9
constexpr int kMaxSuper = 256;  // superblocks at n <= 2^22
constexpr int kTop = 8;  // levels of the superblocks' table: 0..7
constexpr int kMaxBlocks = 1024;  // CTAs a grid may have: the counts' scratch
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int min_key(float x) {
  const int b = __float_as_int(x);
  return x != x ? INT_MIN : b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float from_min_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

__device__ __forceinline__ int floor_log2(int x) { return 31 - __clz(x); }

// one table row: the six keys of a block window, 8-byte aligned
struct Row {
  int2 a, b, c;
};

constexpr size_t kSmem = 2 * kSuper * sizeof(Row);  // two levels, or the top table
static_assert(kTop * kMaxSuper <= 2 * kSuper, "the top table fits the level buffers");

// rows written by other CTAs in this launch: read past the L1
__device__ __forceinline__ Row load_row(const Row* p) {
  const int2* q = reinterpret_cast<const int2*>(p);
  return Row{__ldcg(q), __ldcg(q + 1), __ldcg(q + 2)};
}

__device__ __forceinline__ int2 min2(int2 x, int2 y) {
  return make_int2(min(x.x, y.x), min(x.y, y.y));
}

__device__ __forceinline__ Row min_row(const Row& x, const Row& y) {
  return Row{min2(x.a, y.a), min2(x.b, y.b), min2(x.c, y.c)};
}

// t4's column i as keys: its six words, 24 B at an 8-byte boundary
__device__ __forceinline__ Row key_row(const float* t4, int i) {
  const float2* q = reinterpret_cast<const float2*>(t4 + (size_t)6 * i);
  const float2 x = q[0], y = q[1], z = q[2];
  return Row{make_int2(min_key(x.x), min_key(x.y)), make_int2(min_key(y.x), min_key(y.y)),
             make_int2(min_key(z.x), min_key(z.y))};
}

// the min of blocks [a, b] of one superblock, from its table (a range of
// more than 512 blocks takes two windows of 512)
__device__ __forceinline__ Row local_range(const Row* local, int nb, int a, int b) {
  const int k = min(floor_log2(b - a + 1), kLocal - 1);
  const Row* lv = local + (size_t)k * nb;
  return min_row(load_row(lv + a), load_row(lv + b - (1 << k) + 1));
}

// t4 f32[n, 6]; short_flag u8[n] (the first n - 1 read); first, last
// i32[n - 1]; local: kLocal * nb rows; top_in: kMaxSuper rows; counts: a
// word a CTA; list: i32[n - 1]; nodes f32[6, 2n - 1]
__global__ void __launch_bounds__(kThreads)
    refit_long_kernel(const float* __restrict__ t4, const unsigned char* __restrict__ short_flag,
                      const int* __restrict__ first, const int* __restrict__ last, int n, int R,
                      Row* __restrict__ local, Row* __restrict__ top_in, int* __restrict__ counts,
                      int* __restrict__ list, float* __restrict__ nodes) {
  extern __shared__ Row sm[];
  __shared__ int n_long, total;
  cg::grid_group grid = cg::this_grid();
  const int nb = (n + kBlock - 1) / kBlock, ns = (nb + kSuper - 1) / kSuper, m = n - 1;
  const int t = threadIdx.x, lane = t & 31;
  const int chunk = (m + gridDim.x - 1) / gridDim.x;  // this CTA's nodes: [lo, hi)
  const int lo = min(m, blockIdx.x * chunk), hi = min(m, lo + chunk);

  // the chunk's long nodes, compacted into list[lo, lo + n_long)
  if (t == 0) n_long = 0;
  __syncthreads();
  for (int i0 = lo; i0 < hi; i0 += kThreads) {
    const int i = i0 + t;
    const bool is_long = i < hi && !short_flag[i];
    const unsigned mask = __ballot_sync(kFull, is_long);
    int base = 0;
    if (lane == 0 && mask) base = atomicAdd(&n_long, __popc(mask));
    base = __shfl_sync(kFull, base, 0);
    if (is_long) list[lo + base + __popc(mask & ((1u << lane) - 1u))] = i;
  }
  __syncthreads();
  if (t == 0) counts[blockIdx.x] = n_long;

  // each superblock's table, and its minimum
  Row* cur = sm;
  Row* nxt = sm + kSuper;
  for (int s = blockIdx.x; s < ns; s += gridDim.x) {
    const int b0 = s * kSuper, cnt = min(kSuper, nb - b0), top = floor_log2(cnt);
    Row r;
    if (t < cnt) {
      r = key_row(t4, kBlock * (b0 + t));
      cur[t] = r;
      local[b0 + t] = r;
    }
    __syncthreads();
    for (int k = 1; k <= top; ++k) {
      if (t + (1 << k) <= cnt) {
        r = min_row(r, cur[t + (1 << (k - 1))]);
        nxt[t] = r;
        if (k < kLocal) local[(size_t)k * nb + b0 + t] = r;
      }
      __syncthreads();
      Row* w = cur;
      cur = nxt;
      nxt = w;
    }
    if (t == 0) top_in[s] = min_row(cur[0], cur[cnt - (1 << top)]);
    __syncthreads();
  }
  grid.sync();

  // the superblocks' table in shared memory, and the grid's long count
  if (t == 0) total = 0;
  Row r;
  if (t < ns) {
    r = load_row(top_in + t);
    sm[t] = r;
  }
  __syncthreads();
  for (int b = t; b < gridDim.x; b += kThreads) atomicAdd(&total, __ldcg(counts + b));
  const int top = min(floor_log2(ns), kTop - 1);
  for (int k = 1; k <= top; ++k) {
    if (t + (1 << k) <= ns) {
      r = min_row(r, sm[(k - 1) * kMaxSuper + t + (1 << (k - 1))]);
      sm[k * kMaxSuper + t] = r;
    }
    __syncthreads();
  }
  __syncthreads();
  const int cap = min(m, max(64, (4 * m) / (3 * R)));
  const bool exact = cap < m && total > cap;  // past the budget: the full table's answers

  const int fill = exact ? INT_MAX : min_key(kBig);
  const size_t ld = 2 * (size_t)n - 1;
  for (int j = t; j < n_long; j += kThreads) {
    const int i = list[lo + j];
    const int f = first[i], l = last[i];
    const Row u = min_row(key_row(t4, f), key_row(t4, max(l - (kBlock - 1), 0)));
    const int bf = (f + kBlock - 1) / kBlock, bl = (l + 1) / kBlock - 1;
    Row mid = Row{make_int2(fill, fill), make_int2(fill, fill), make_int2(fill, fill)};
    if (bl >= bf) {
      const int sf = bf / kSuper, sl = bl / kSuper;
      if (sf == sl) {
        mid = local_range(local, nb, bf, bl);
      } else {
        mid = min_row(local_range(local, nb, bf, sf * kSuper + kSuper - 1),
                      local_range(local, nb, sl * kSuper, bl));
        if (sl - sf >= 2) {
          const int k = floor_log2(sl - sf - 1);
          const Row* lv = sm + k * kMaxSuper;
          mid = min_row(mid, min_row(lv[sf + 1], lv[sl - (1 << k)]));
        }
      }
    }
    const Row v = min_row(u, mid);
    const int w[6] = {v.a.x, v.a.y, v.b.x, v.b.y, v.c.x, v.c.y};
#pragma unroll
    for (int c = 0; c < 6; ++c) nodes[c * ld + i] = from_min_key(w[c]);
  }
  if (!exact) return;
  for (int i = lo + t; i < hi; i += kThreads) {
    if (!short_flag[i]) continue;
    bool redo = false;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const float v = nodes[c * ld + i];
      redo |= v != v || v == kBig;
    }
    if (!redo) continue;
    const int f = first[i], l = last[i];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      int k = INT_MAX;
      for (int j = f; j <= l; ++j) k = min(k, min_key(nodes[c * ld + m + j]));
      nodes[c * ld + i] = from_min_key(k);
    }
  }
}

// CTAs of the kernel the card holds at once (occupancy x SMs), found once
// a device; 0 where it takes no cooperative launch
cudaError_t resident(int* blocks) {
  static int dev_seen = -1, blocks_seen = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_seen) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(refit_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, refit_long_kernel, kThreads,
                                                          kSmem);
    if (err != cudaSuccess) return err;
    blocks_seen = coop ? per_sm * sms : 0;
    dev_seen = dev;
  }
  *blocks = blocks_seen;
  return cudaSuccess;
}

}  // namespace

// After tbvh_refit_dense_nodes on the same stream, on its outputs: t4
// f32[n, 6], short_flag u8[n], nodes f32[6, 2n - 1]; first and last
// i32[n - 1]; radius B2's; scratch i32[6 (kLocal nb + kMaxSuper) +
// kMaxBlocks + n - 1], nb = ceil(n / 16); 2 <= n <= 2^22.
extern "C" int tbvh_refit_long(const float* t4, const unsigned char* short_flag,
                               const int* first, const int* last, int n, int radius, int* scratch,
                               float* nodes, cudaStream_t stream) {
  if (n < 2 || n > (1 << 22) || radius < 1) return (int)cudaErrorInvalidValue;
  int blocks;
  cudaError_t err = resident(&blocks);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int need = (n + kThreads - 1) / kThreads;
  if (blocks > need) blocks = need;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int nb = (n + kBlock - 1) / kBlock;
  Row* local = reinterpret_cast<Row*>(scratch);
  Row* top_in = local + (size_t)kLocal * nb;
  int* counts = reinterpret_cast<int*>(top_in + kMaxSuper);
  int* list = counts + kMaxBlocks;
  void* args[] = {&t4, &short_flag, &first, &last, &n, &radius, &local, &top_in, &counts, &list,
                  &nodes};
  return (int)cudaLaunchCooperativeKernel((const void*)refit_long_kernel, dim3(blocks),
                                          dim3(kThreads), args, kSmem, stream);
}
