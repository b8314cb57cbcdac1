// Child positions: the segmented argmin of (d << 22 | j) on each side of
// every row (B15).
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/threshold_core.py:
// child_positions_auto (_run_child; _child_kernel_lanes_fwd, _rev), which
// runs, per threshold v, a segmented running min of (d_j << 22 | j) over
// the candidates d_j > v, resetting at d_j <= v, and selects lane d_k
// exclusively before (left) and after (right) row k. Contract
// (tpu_bvh_torch/ops/threshold_core.py), for d i32[m] in [0, 63], m < 2^22:
//   left[k]  = argmin of (d_j, j) over j in (s_k, k), s_k = last j < k with d_j <= d_k;
//   right[k] = argmin of (d_j, j) over j in (k, e_k), e_k = first j > k with d_j <= d_k;
//   -1 where the window is empty.
//
// Bound on the card: bytes, 4 B read and 8 B written per row. A walk over
// the window would be quadratic (a lone 0 among larger values has a window
// of length m), and a range-min table costs log m passes. The design finds
// each child as the unique row that names its parent: with ns = next
// strictly smaller, pl = previous <=, nl = next <=, as packed keys,
//   left[k]  = the j with ns(j) = k and pl(j) = pl(k),
//   right[k] = the j with pl(j) = k and ns(j) = nl(k).
// (The window's minimum j*, the first of equal minima, has nothing smaller
// between it and k and nothing <= between s_k and it, which gives both
// equalities; any other j of the window has a smaller row between it and
// k, or between it and e_k, or an equal one before it.)
//
// One cooperative launch of psv_scan.cuh's scan (the Op below has kLe):
// its bit-sliced comparator gives each warp's "less" and "equal" masks in
// one pass, so a row gets ns at threshold q and pl, nl at q + 1 (its
// neighbours at q = 63) from the same tiles and carries. Phase 3 writes
// ns, pl, nl and -1 to the row's own left and right slots; after a second
// grid sync each row writes itself into at most two slots, each slot
// written by at most one row: no atomics, no order, no memset, exact.

#include "psv_scan.cuh"

namespace {

struct ChildPositions {
  static constexpr bool kLe = true;
  const int* d;
  int* ns;  // scratch, i32[m] each
  int* pl;
  int* nl;
  int* left;
  int* right;
  __device__ int delta(int i) const { return d[i]; }
  __device__ void write(int i, int, int, int n, int pl_i, int nl_i) const {
    ns[i] = n;
    pl[i] = pl_i;
    nl[i] = nl_i;
    left[i] = -1;
    right[i] = -1;
  }
  // packed keys 64 pos + d compare like positions, sentinels included;
  // other rows' answers come from the L2 (written by other blocks)
  __device__ void scatter(int j) const {
    const int nsj = __ldcg(ns + j), plj = __ldcg(pl + j);
    if (nsj != psv::kBig && __ldcg(pl + (nsj >> 6)) == plj) left[nsj >> 6] = j;
    if (plj >= 0 && __ldcg(nl + (plj >> 6)) == nsj) right[plj >> 6] = j;
  }
};

}  // namespace

// agg: the scratch of psv_scan.cuh (threshold_core.scan_scratch); scratch
// holds 3 m ints (ns, pl, nl). The strict psv parks in `left` until its
// row overwrites it with -1.
extern "C" int tbvh_child_positions(const int* dlt, int m, int* agg, int* scratch, int* left,
                                    int* right, cudaStream_t stream) {
  int* ns = scratch;
  int* pl = scratch + m;
  int* nl = scratch + 2 * (size_t)m;
  return (int)psv::launch(ChildPositions{dlt, ns, pl, nl, left, right}, m, agg, left, ns, nullptr,
                          stream, pl, nl);
}
