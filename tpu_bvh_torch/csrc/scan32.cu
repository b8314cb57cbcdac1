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
// in flipped order and true coordinates. Each half is one cooperative
// launch of the same scan with its own Op (Scan32Fwd, Scan32Rev), bound by
// bytes: 4 B read and 12 B written per row. The Op rebuilds the remapped
// delta exactly (a lane-30 tie at true position j is the ruler value
// 32 + clz(j ^ (j + 1)), remapped to 21 + clz(...), in [30, 52] for
// m < 2^22) and writes only its half's three outputs, by B1's rules:
//   forward: psv_pos, psv_val at row i, lc[nsv i] = i where
//     d(psv i) <= d(nsv i), lc[i] = -1 where d(i - 1) <= d(i);
//   reverse: the scan runs over the flipped array itself, so row g (true
//     position j = m - 1 - g) finds the true nsv as its psv and the true
//     psv as its nsv, and every output it owns lies at its own index g:
//     nsv_pos, nsv_val at g; rc at the flipped index of the true psv, with
//     B1's strict rule mirrored (true d(psv) > d(nsv), i.e. the flipped
//     nsv's value > the flipped psv's); rc[g] = -1 (leaf j + 1) where
//     g = 0 or the flipped d(g - 1) < d(g).
// The scan parks a row's within-tile answers in the two outputs the row
// itself writes at its own index (pos and val), so no row's write reaches
// another row's parked answer. No atomics, no memset, no scratch but the
// scan's tile aggregates.

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

// The remapped delta of B16's V=32 form at true position j: distinct codes
// keep raw - 2 in [0, 29]; a tie (lane 30) has the raw ruler value
// 32 + clz(j ^ (j + 1)), as radix_tree.adjacent_deltas computes it, which
// remaps to raw - 11.
__device__ __forceinline__ int delta32(int v, int j) {
  return v == 30 ? 21 + __clz(j ^ (j + 1)) : v;
}

// B16, forward half: (psv_pos, psv_val, lc) from the V=32 deltas
struct Scan32Fwd {
  static constexpr bool kLe = false;
  const int* d;
  int* psv_pos;
  int* psv_val;
  int* lc;
  __device__ int delta(int i) const { return delta32(d[i], i); }
  __device__ void write(int i, int di, int p, int n) const {
    const bool hp = p >= 0, hn = n != psv::kBig;
    const int dp = hp ? p & 63 : -1, dn = hn ? n & 63 : -1;
    psv_pos[i] = hp ? p >> 6 : -1;
    psv_val[i] = dp;
    if (hn && dp <= dn) lc[n >> 6] = i;  // boundary i is the left child of nsv i
    if (!(i > 0 && delta(i - 1) > di)) lc[i] = -1;  // leaf i
  }
};

// B16, reverse half: (nsv_pos, nsv_val, rc) in flipped order from the
// flipped V=32 deltas; row g is true position m - 1 - g
struct Scan32Rev {
  static constexpr bool kLe = false;
  const int* d;
  int m;
  int* nsv_pos;
  int* nsv_val;
  int* rc;
  __device__ int delta(int g) const { return delta32(d[g], m - 1 - g); }
  __device__ void write(int g, int dg, int p, int n) const {
    const bool hn = p >= 0, hp = n != psv::kBig;  // the true nsv and psv
    const int dn = hn ? p & 63 : -1, dp = hp ? n & 63 : -1;
    nsv_pos[g] = hn ? m - 1 - (p >> 6) : m;
    nsv_val[g] = dn;
    if (dp > dn) rc[n >> 6] = m - 1 - g;  // the right child of the true psv (dp >= 0: hp)
    if (g == 0 || delta(g - 1) < dg) rc[g] = -1;  // leaf m - g
  }
};

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

// B16, forward half: (psv_pos, psv_val, lc) from the V=32 deltas; agg as
// tbvh_scan32's
extern "C" int tbvh_scan32_fwd(const int* dlt32, int m, int* agg, int* psv_pos, int* psv_val,
                               int* lc, cudaStream_t stream) {
  return (int)psv::launch(Scan32Fwd{dlt32, psv_pos, psv_val, lc}, m, agg, psv_pos, psv_val,
                          nullptr, stream);
}

// B16, reverse half: (nsv_pos, nsv_val, rc) from the flipped V=32 deltas,
// written in flipped order
extern "C" int tbvh_scan32_rev(const int* dlt32_flipped, int m, int* agg, int* nsv_pos,
                               int* nsv_val, int* rc, cudaStream_t stream) {
  return (int)psv::launch(Scan32Rev{dlt32_flipped, m, nsv_pos, nsv_val, rc}, m, agg, nsv_pos,
                          nsv_val, nullptr, stream);
}
