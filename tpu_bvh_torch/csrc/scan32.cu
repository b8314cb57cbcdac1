// Topology scan for the single-pass LBVH (B1), and B16's two halves.
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/scan32.py:scan_core
// (_both_kernel), which derives every boundary's previous/next smaller
// delta and its two child argmins from 32-lane threshold scans. Same
// contract: from raw adjacent deltas (values [2,31] for distinct codes,
// [41,63] for ties) it writes psv_pos, psv_val, lc, nsv_pos, nsv_val, rc,
// values on the [0,52] scale, sentinels psv -1, nsv m, children -1 = leaf.
//
// Bound on the card: bytes, 4 B read and 24 B written per row.
//
// Design. All six outputs follow from the strict psv/nsv of the remapped
// deltas (raw - 2 or raw - 11, in registers), so B1 is one launch of the
// psv/nsv scan of psv_scan.cuh with an epilogue: the positions and values
// are the packed keys split, and the children are scattered by the rule
// of a bottom-up Apetrei climb (a node covering leaves [l, r] is the right
// child of boundary l - 1 if d(l - 1) > d(r), else the left child of r;
// d(-1) = d(m) = -1):
//   internal boundary j, range (psv j, nsv j]: if d(psv j) > d(nsv j),
//     rc[psv j] = j, else lc[nsv j] = j; the root writes nothing;
//   leaf i in 0..m: if d(i - 1) > d(i), rc[i - 1] = -1, else lc[i] = -1
//     (leaf m, always rc[m - 1], by row m - 1's thread).
// On the deltas of sorted codes every range has a unique minimum, so each
// slot is written exactly once: no atomics, no memset, no scratch but the
// scan's tile aggregates.
//
// B16: tpu_bvh/ops/pallas/scan32.py:_run launches _fwd_kernel on the V=32
// deltas (distinct codes raw - 2, every tie on lane 30) for (psv_pos,
// psv_val, lc), and _rev_kernel on their flip for (nsv_pos, nsv_val, rc)
// in flipped order and true coordinates. tbvh_scan32_fwd / tbvh_scan32_rev
// rebuild the raw delta exactly (a lane-30 tie at true position j is the
// ruler value 32 + clz(j ^ (j + 1)); in the flipped array true position j
// sits at m - 1 - j) and run the climb itself: one thread per leaf walks
// up, each child publishes its outer bound with one atomicExch on its
// parent's slot, the second arrival learns the parent's range and goes
// on. Each half must read 4 B and write 12 B per row; it is bound by the
// climb's dependent loads (no caller on the main path).

#include "psv_scan.cuh"
namespace {

__device__ __forceinline__ int remap(int raw) { return raw <= 31 ? raw - 2 : raw - 11; }

// B1's epilogue: the raw deltas in, the six outputs out
struct Topology {
  static constexpr bool kLe = false;  // strict answers only
  const int* raw;
  int m;
  int* psv_pos;
  int* psv_val;
  int* lc;
  int* nsv_pos;
  int* nsv_val;
  int* rc;
  __device__ int delta(int i) const { return remap(raw[i]); }
  __device__ void write(int i, int d, int p, int n) const {
    const bool hp = p >= 0, hn = n != psv::kBig;
    const int dp = hp ? p & 63 : -1, dn = hn ? n & 63 : -1;
    psv_pos[i] = hp ? p >> 6 : -1;
    psv_val[i] = dp;
    nsv_pos[i] = hn ? n >> 6 : m;
    nsv_val[i] = dn;
    if (hp || hn) {  // boundary i is a child of psv i or of nsv i
      if (dp > dn) {
        rc[p >> 6] = i;
      } else {
        lc[n >> 6] = i;
      }
    }
    if ((i > 0 ? delta(i - 1) : -1) > d) {  // leaf i
      rc[i - 1] = -1;
    } else {
      lc[i] = -1;
    }
    if (i == m - 1) rc[i] = -1;  // leaf m
  }
};

// The raw delta rebuilt from the V=32 deltas of B16 (distinct codes raw - 2
// in [0, 29], every tie on lane 30), in true order or flipped (true
// position j at index m - 1 - j): a tie at true position j has the ruler
// value 32 + clz(j ^ (j + 1)), as radix_tree.adjacent_deltas computes it.
struct Dlt32Deltas {
  const int* d;
  int m;
  bool flipped;
  __device__ int operator()(int j) const {
    const int v = d[flipped ? m - 1 - j : j];
    return v == 30 ? 32 + __clz(j ^ (j + 1)) : v + 2;
  }
};

// B16's climb. The forward half writes psv_pos, psv_val, lc at p; the
// reverse half nsv_pos, nsv_val, rc at m - 1 - p (flipped order, true
// coordinates).
template <bool kRev>
__global__ void climb_kernel(Dlt32Deltas dlt, int m, int* __restrict__ other, int* __restrict__ pos,
                             int* __restrict__ val, int* __restrict__ child) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > m) return;  // n = m + 1 leaves
  int l = i, r = i, node = -1;  // start at leaf i; -1 marks a leaf child
  while (true) {
    int dl = l > 0 ? dlt(l - 1) : -1;
    int dr = r < m ? dlt(r) : -1;
    if (dl < 0 && dr < 0) return;  // the root: done
    int p;
    if (dl > dr) {  // right child of boundary l-1
      p = l - 1;
      if (kRev) child[m - 1 - p] = node;
      int got = atomicExch(&other[p], r);
      if (got < 0) return;  // first arrival
      l = got;
    } else {  // left child of boundary r
      p = r;
      if (!kRev) child[p] = node;
      int got = atomicExch(&other[p], l);
      if (got < 0) return;
      r = got;
    }
    node = p;  // second arrival: node p covers [l, r]
    if (kRev) {
      pos[m - 1 - p] = r;
      val[m - 1 - p] = r < m ? remap(dlt(r)) : -1;
    } else {
      pos[p] = l - 1;
      val[p] = l > 0 ? remap(dlt(l - 1)) : -1;
    }
  }
}

// every slot of `other` starts at -1 (all bits set): no child has arrived yet
template <bool kRev>
int climb(const int* dlt32, int m, int* other, int* pos, int* val, int* child,
          cudaStream_t stream) {
  const int threads = 256;
  cudaError_t err = cudaMemsetAsync(other, 0xFF, (size_t)m * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  climb_kernel<kRev><<<(m + 1 + threads - 1) / threads, threads, 0, stream>>>(
      Dlt32Deltas{dlt32, m, kRev}, m, other, pos, val, child);
  return (int)cudaGetLastError();
}

}  // namespace

// agg: the scratch of psv_scan.cuh (threshold_core.scan_scratch)
extern "C" int tbvh_scan32(const int* dlt_raw, int m, int* agg, int* psv_pos, int* psv_val,
                           int* lc, int* nsv_pos, int* nsv_val, int* rc, cudaStream_t stream) {
  return (int)psv::launch(Topology{dlt_raw, m, psv_pos, psv_val, lc, nsv_pos, nsv_val, rc}, m,
                          agg, psv_pos, nsv_pos, nullptr, stream);
}

// The grid a call over m rows launches: {blocks, most tiles a block, blocks
// an SM, SMs}
extern "C" int tbvh_scan32_grid(int m, int* out) { return (int)psv::grid_of<Topology>(m, out); }

// B16, forward half: (psv_pos, psv_val, lc) from the V=32 deltas
extern "C" int tbvh_scan32_fwd(const int* dlt32, int m, int* other, int* psv_pos, int* psv_val,
                               int* lc, cudaStream_t stream) {
  return climb<false>(dlt32, m, other, psv_pos, psv_val, lc, stream);
}

// B16, reverse half: (nsv_pos, nsv_val, rc) from the flipped V=32 deltas,
// written in flipped order
extern "C" int tbvh_scan32_rev(const int* dlt32_flipped, int m, int* other, int* nsv_pos,
                               int* nsv_val, int* rc, cudaStream_t stream) {
  return climb<true>(dlt32_flipped, m, other, nsv_pos, nsv_val, rc, stream);
}
