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
// about 1.9 ms per full-array access, so it turns every pointer chase
// into strip-folded shift sweeps over VMEM blocks with a 256-lane halo,
// and resolves states by 6 trips of pointer doubling. On the H100 a load
// at a bounded offset is served from L1/L2, so the natural form is one
// thread per lane with direct loads:
//   phase A (collapse_expand): expansion tables, slot ids, counts, e1/e2;
//   phase B (collapse_state): each lane walks its parent chain to the
//     seeded terminal (a coarse node or a child of one, meta row 4, or
//     the root), composing the 3-state transition tables on the way. A
//     short node's chain has at most S_LEN + 2 hops, so the serial walk
//     gives the doubling's composed function; a longer walk is a bug and
//     sets the error flag (the wrapper raises) instead of truncating.
//     It also writes the packed (claim | tag) row phase C walks;
//   phase C (collapse_emit): the claims (first WIDE or terminal among
//     parent, grandparent, great-grandparent), the slot AABBs loaded at
//     the slot ids, the coarse pass-through, and all outputs.
// B reads other lanes' A results and C other lanes' B results, so they
// are three launches on one stream. Everything is integer work (areas are
// compared as i32 bits, the first max wins, area > 0 strictly), so the
// result equals the plain PyTorch version bit for bit.
//
// Bound on the card: bytes. What the function needs per lane: the 8 meta
// words, carr row 5 and 40 output words; carr's other 29 used rows only
// at the coarse wide lanes (a few percent), and 6 AABB words of node8 or
// leaf8 per slot of a short wide lane (their rows 6-7 are zero padding,
// copied through as the TPU kernel does). The chain walks add a few
// dependent loads per lane, served from L1/L2.

#include <cuda_runtime.h>

namespace {

constexpr int kSLen = 33;
constexpr int kWide = 0, kE1 = 1, kE2 = 2, kUnk = 3;
constexpr int kIdentity = 0 | (1 << 2) | (2 << 4);  // the table (0, 1, 2)
constexpr int kThreads = 256;

// scratch rows (each W long)
constexpr int kSid = 0, kCount = 4, kE1o = 5, kE2o = 6, kE2f = 7, kState = 8, kPk = 9;

__device__ __forceinline__ int pull(const int* row, int t, int m) {
  return (t >= 0 && t < m) ? row[t] : -1;
}

__device__ __forceinline__ int apply_tbl(int tbl, int s) { return (tbl >> (2 * s)) & 3; }

__global__ void collapse_expand(const int* __restrict__ meta, int W, int m,
                                int* __restrict__ scr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  const int* area = meta;
  const int* lrow = meta + W;
  const int* rrow = meta + 2 * W;
  const int left = lrow[i], right = rrow[i];
  const bool shortv = meta[5 * W + i] == 1 && i < m;
  auto acode = [m](int t, int a) { return (t >= 0 && t < m) ? a : -1; };

  int sid[4] = {left, right, -1, -1};
  int ac[4] = {acode(left, pull(area, left, m)), acode(right, pull(area, right, m)), -1, -1};
  int lc[4] = {pull(lrow, left, m), pull(lrow, right, m), -1, -1};
  int rc[4] = {pull(rrow, left, m), pull(rrow, right, m), -1, -1};

  // step 1: the first max wins ties, area > 0 strictly
  const int best1 = max(ac[0], ac[1]);
  const int pos1 = ac[1] > ac[0] ? 1 : 0;
  const bool do1 = best1 > 0 && shortv;
  const int e1 = sid[pos1];
  if (do1) {
    const int c1l = lc[pos1], c1r = rc[pos1];
    sid[pos1] = c1l;
    ac[pos1] = acode(c1l, pull(area, c1l, m));
    lc[pos1] = pull(lrow, c1l, m);
    rc[pos1] = pull(rrow, c1l, m);
    sid[2] = c1r;
    ac[2] = acode(c1r, pull(area, c1r, m));
    lc[2] = pull(lrow, c1r, m);
    rc[2] = pull(rrow, c1r, m);
  }
  const int count1 = 2 + (do1 ? 1 : 0);

  // step 2 over slots 0..2 in slot order
  const int best2 = max(max(ac[0], ac[1]), ac[2]);
  const int pos2 = ac[0] == best2 ? 0 : (ac[1] == best2 ? 1 : 2);
  const bool do2 = best2 > 0 && shortv;
  const int e2 = sid[pos2];
  if (do2) {
    const int c2l = lc[pos2], c2r = rc[pos2];
    sid[pos2] = c2l;
    sid[count1] = c2r;
  }
  for (int k = 0; k < 4; ++k) scr[(kSid + k) * W + i] = sid[k];
  scr[kCount * W + i] = count1 + (do2 ? 1 : 0);
  const int e2_out = do2 ? e2 : -1;
  scr[kE1o * W + i] = do1 ? e1 : -1;
  scr[kE2o * W + i] = e2_out;
  const int e2in = (meta[4 * W + i] & ((1 << 23) - 1)) - 1;
  scr[kE2f * W + i] = shortv ? e2_out : e2in;
}

__global__ void collapse_state(const int* __restrict__ meta, int W, int m,
                               int* __restrict__ scr, int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  if (i >= m) {
    scr[kState * W + i] = kUnk;
    scr[kPk * W + i] = -1;
    return;
  }
  const int* prow = meta + 3 * W;
  const int* seedrow = meta + 4 * W;
  const int* e1o = scr + kE1o * W;
  const int* e2o = scr + kE2o * W;
  const int* e2f = scr + kE2f * W;
  // walk up, composing tbl = f_i o f_parent o ...; state = tbl(terminal seed)
  int tbl = kIdentity, x = i, state = kUnk;
  for (int hops = 0;; ++hops) {
    const int seed = seedrow[x] >> 23, par = prow[x];
    if (seed <= 2 || par < 0) {
      state = apply_tbl(tbl, seed <= 2 ? seed : kWide);
      break;
    }
    if (hops == kSLen + 2 || par >= m) {
      *err = 1;
      break;
    }
    const int e1p = e1o[par], e2p = e2o[par];
    const int e2g = pull(e2f, prow[par], m);
    const int t_wide = x == e1p ? kE1 : (x == e2p ? kE2 : kWide);
    const int t_e1 = x == e2g ? kE2 : kWide;
    const int f = t_wide | (t_e1 << 2);  // f(E2) = WIDE
    tbl = apply_tbl(tbl, apply_tbl(f, 0)) | (apply_tbl(tbl, apply_tbl(f, 1)) << 2) |
          (apply_tbl(tbl, apply_tbl(f, 2)) << 4);
    x = par;
  }
  scr[kState * W + i] = state;
  const int ownp1 = meta[6 * W + i];
  const int claim = state == kWide ? i : ownp1 - 1;
  scr[kPk * W + i] = ownp1 > 0 ? (claim + 1) * 4 + 3
                               : (prow[i] + 1) * 4 + min(state, 2);
}

__device__ __forceinline__ int dec(int pk) { return pk >= 0 ? (pk >> 2) - 1 : -1; }

// the first WIDE (its id) or seed terminal (its claim) in chain order
__device__ __forceinline__ int first_wide(int t0, int pk0, int t1, int pk1, int t2, int pk2) {
  const int ts[3] = {t0, t1, t2}, pks[3] = {pk0, pk1, pk2};
  int c = -1;
  for (int j = 2; j >= 0; --j) {
    const int pk = pks[j];
    if (pk >= 0 && (pk & 3) == kWide) c = ts[j];
    else if (pk >= 0 && (pk & 3) == 3) c = (pk >> 2) - 1;
  }
  return c;
}

__global__ void collapse_emit(const int* __restrict__ meta, const int* __restrict__ node8,
                              const int* __restrict__ leaf8, const int* __restrict__ carr,
                              int W, int m, const int* __restrict__ scr,
                              int* __restrict__ outm, int* __restrict__ outa) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  const int* pk = scr + kPk * W;
  const int state = scr[kState * W + i];
  const bool is_int = i < m;
  const bool is_wide = state == kWide && meta[5 * W + i] == 1 && is_int;
  const int parent = meta[3 * W + i];
  const int ownp1 = meta[6 * W + i];
  const int leafp = meta[7 * W + i];

  // ---- claims ----
  const int pk_q = leafp == i ? pk[i] : (leafp == i - 1 ? (i >= 1 ? pk[i - 1] : -1) : -1);
  const int pq = dec(pk_q);
  const int pk_p = pull(pk, parent, m), pk_pq = pull(pk, pq, m);
  const int gp = dec(pk_p), gpq = dec(pk_pq);
  const int pk_gp = pull(pk, gp, m), pk_gpq = pull(pk, gpq, m);
  const int ggp = dec(pk_gp);
  const int pk_ggp = pull(pk, ggp, m);
  int claim_int = -1;
  if (is_wide && parent >= 0)
    claim_int = ownp1 > 0 ? ownp1 - 1 : first_wide(parent, pk_p, gp, pk_gp, ggp, pk_ggp);
  const int claim_leaf = (i < m + 1 && leafp >= 0)
                             ? first_wide(leafp, pk_q, pq, pk_pq, gpq, pk_gpq) : -1;

  // ---- outputs, with the coarse pass-through ----
  const bool cw = carr[5 * W + i] == 1;
  for (int k = 0; k < 4; ++k)
    outm[k * W + i] = cw ? carr[k * W + i] : (is_wide ? scr[(kSid + k) * W + i] : -1);
  outm[4 * W + i] = cw ? carr[4 * W + i] : (is_wide ? scr[kCount * W + i] : 0);
  outm[5 * W + i] = is_int ? state : kUnk;
  outm[6 * W + i] = cw ? ownp1 - 1 : claim_int;
  outm[7 * W + i] = claim_leaf;
  for (int k = 0; k < 4; ++k) {
    int* oa = outa + (size_t)k * 8 * W;
    const int sid = scr[(kSid + k) * W + i];
    const int* src = (sid >= 0 && sid < m) ? node8 + sid : (sid >= m ? leaf8 + (sid - m) : nullptr);
    for (int r = 0; r < 8; ++r) {
      int v;
      if (cw) v = r < 6 ? carr[(6 + 6 * k + r) * W + i] : 0;
      else v = (is_wide && src) ? src[(size_t)r * W] : 0;
      oa[(size_t)r * W + i] = v;
    }
  }
}

}  // namespace

extern "C" int tbvh_collapse_block(const int* meta, const int* node8, const int* leaf8,
                                   const int* carr, int W, int m, int* scratch, int* err,
                                   int* outm, int* outa, cudaStream_t stream) {
  const int blocks = (W + kThreads - 1) / kThreads;
  collapse_expand<<<blocks, kThreads, 0, stream>>>(meta, W, m, scratch);
  int e = (int)cudaGetLastError();
  if (e) return e;
  collapse_state<<<blocks, kThreads, 0, stream>>>(meta, W, m, scratch, err);
  e = (int)cudaGetLastError();
  if (e) return e;
  collapse_emit<<<blocks, kThreads, 0, stream>>>(meta, node8, leaf8, carr, W, m, scratch, outm,
                                                 outa);
  return (int)cudaGetLastError();
}
