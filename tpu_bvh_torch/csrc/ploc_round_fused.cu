// One PLOC/HPLOC merge round in one launch: the nearest-neighbour stage,
// merged-node emission and survivor compaction.
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/ploc_round.py:401
// (ploc_round_pp; body _fused_kernel :245, which inlines ploc_nn.py's
// _nn_body), one kernel over a grid that runs in order with a sequential
// carry of the merge and keep counts. Same contract as the plain version
// (tpu_bvh_torch/ops/ploc_round.py: ploc_nn_round_raw_reference on the nc
// live lanes, then ploc_emit_compact_reference): over lanes i < nc,
//   * best_rel, has_nn, the mutual flags (merge = left of a mutual pair,
//     dropped = right) and the union with the best forward candidate, as
//     csrc/ploc_nn.cu computes them;
//   * merge lane i takes id new = base + (merges before i) and writes node
//     column new = [own node id, partner node id, union]; no other node
//     column is touched;
//   * a lane that is not dropped is written to column (keeps before i) of
//     `out`: merged lanes as [union, own code, new], the others unchanged.
//
// Design: 256 lanes a block. Hopper's blocks run in no order, so the carry
// is a single-pass scan with decoupled look-back:
//   1. thread 0 draws the block's index from an atomic ticket, so every
//      predecessor has already been scheduled (the look-back cannot wait
//      on a block that is not running); the last draw resets the ticket;
//   2. the block loads its lanes and a halo of 2 * kMaxR on each side into
//      shared memory and computes best_rel, the flags and the unions there
//      (ploc_nn.cu's work): the NN output never reaches device memory. Each
//      pair's union area is computed once, from its left lane, into a
//      table that the right lane's backward search reads (ploc_nn.cu
//      computes it from both ends): the same area, as the union's min does
//      not depend on the order of its arguments;
//   3. it counts its merges and keeps and publishes them as its aggregate,
//      then warp 0 walks back over its predecessors' status words, 32 at a
//      time, summing aggregates until it meets an inclusive prefix, and
//      publishes its own inclusive prefix (ploc::look_back, shared with
//      B9: two 64-bit status words a block tagged with the launch's epoch,
//      so no memset runs between rounds);
//   4. it writes its merged nodes and survivors at their final places;
//   5. the last block writes (n_merged, n_keep) to ctl[1], ctl[2].
// Ranks fix every position, and the arithmetic is ploc_common.cuh's, so
// the result equals the plain version bit for bit.
//
// Bound on the card: bytes (chip_smoke.py ploc_bounds, "ploc_round"): the
// state rows of every live lane read once (the code row only of survivors
// at shift 32, where one segment makes it unneeded), the survivors and the
// merged nodes written once; the R pair areas per lane (about 150 f32
// operations) stay under that. The kernel reads each lane's rows once into
// shared memory, plus the 2 * kMaxR halo lanes on each side of a block.

#include "ploc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 2 * ploc::kMaxR;
constexpr int kTile = kThreads + 2 * kHalo;        // lanes held in shared memory
constexpr int kRelW = kThreads + 2 * ploc::kMaxR;  // lanes whose best_rel is computed
constexpr int kAreaW = kRelW + ploc::kMaxR;       // lanes whose forward pair areas are kept

__global__ void __launch_bounds__(kThreads)
    ploc_round_kernel(const int* __restrict__ mat, int stride, int nc, int shift, int R, int base,
                      int* __restrict__ out, int ostride, int* __restrict__ nodes,
                      int nodes_stride, unsigned long long* status, int* ctl, unsigned epoch) {
  __shared__ float box[6][kTile];
  __shared__ unsigned seg[kTile];
  __shared__ int node[kTile];
  __shared__ signed char rel[kRelW];
  __shared__ signed char fwd[kRelW];
  __shared__ bool has[kRelW];
  __shared__ float area[ploc::kMaxR][kAreaW];  // area[d - 1][e]: lanes t0 + e and t0 + e + d
  __shared__ int ws[kThreads / 32];
  __shared__ int s_b, s_ex_m, s_ex_k;

  const int nb = gridDim.x;
  if (threadIdx.x == 0) {
    const int b = atomicAdd(ctl, 1);
    if (b == nb - 1) atomicExch(ctl, 0);  // every block has drawn
    s_b = b;
  }
  __syncthreads();
  const int b = s_b;

  // 2. the NN stage in shared memory (ploc_nn.cu over the nc live lanes)
  const int lo = b * kThreads;
  const int t0 = lo - kHalo;  // lane of tile column 0
  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    const int l = t0 + e;
    const bool in = l >= 0 && l < nc;
#pragma unroll
    for (int k = 0; k < 6; ++k) box[k][e] = in ? __int_as_float(mat[(size_t)k * stride + l]) : 0.0f;
    seg[e] = in ? ploc::seg_of(mat[(size_t)6 * stride + l], shift) : 0u;
    node[e] = in ? mat[(size_t)7 * stride + l] : 0;
  }
  __syncthreads();
  // the pair areas of ploc::nearest's forward search, for the lanes
  // [t0, t0 + kAreaW): BIG where the pair is not a candidate
  for (int e = threadIdx.x; e < kAreaW; e += kThreads) {
    const int l = t0 + e;
    float own[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) own[k] = box[k][e];
    const bool valid = l >= 0 && l < nc;
    for (int d = 1; d <= R; ++d) {
      float a = ploc::kBig;
      if (valid && l + d < nc && seg[e + d] == seg[e]) {
        float nb[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) nb[k] = box[k][e + d];
        a = ploc::union_area(own, nb);
      }
      area[d - 1][e] = a;
    }
  }
  __syncthreads();
  // best_rel as ploc::nearest finds it: forward offsets with a strict <,
  // then backward ones, where a tie goes to the smaller index
  for (int e = threadIdx.x; e < kRelW; e += kThreads) {
    const int c = e + ploc::kMaxR;  // area column of lane lo - kMaxR + e
    float best = ploc::kBig;
    int r = 0;
    for (int d = 1; d <= R; ++d) {
      const float a = area[d - 1][c];
      if (a < best) {
        best = a;
        r = d;
      }
    }
    fwd[e] = (signed char)r;
    for (int d = 1; d <= R; ++d) {
      const float a = area[d - 1][c - d];  // the pair (l - d, l) from its left lane
      if (a < best || (a == best && -d < r)) {
        best = a;
        r = -d;
      }
    }
    rel[e] = (signed char)r;
    has[e] = best < ploc::kBig;
  }
  __syncthreads();
  const int l = lo + threadIdx.x;
  const int e = threadIdx.x + ploc::kMaxR;
  const int br = rel[e];
  bool merge = false, dropped = false;
  for (int d = 1; d <= R; ++d) {
    merge |= br == d && rel[e + d] == -d;
    dropped |= br == -d && rel[e - d] == d;
  }
  const bool live = has[e] && l < nc;
  merge = merge && live;
  const bool keep = l < nc && !(dropped && live);

  // 3. both exclusive prefixes: within the block, then across blocks
  int total;
  const int ex = ploc::block_excl_scan<kThreads>(((int)merge << 16) | (int)keep, ws, &total);
  const int agg_m = total >> 16, agg_k = total & 0xffff;
  if (threadIdx.x < 32) {
    int pm, pk;
    ploc::look_back(status, b, epoch, agg_m, agg_k, &pm, &pk);
    if (threadIdx.x == 0) {
      s_ex_m = pm;
      s_ex_k = pk;
      if (b == nb - 1) {
        ctl[1] = pm + agg_m;
        ctl[2] = pk + agg_k;
      }
    }
  }
  __syncthreads();

  // 4. merged nodes and survivors at their final places
  if (l >= nc) return;
  const int c = l - t0;
  const int new_id = base + s_ex_m + (ex >> 16);
  const int f = fwd[e];
  if (merge) {  // a merge lane's best neighbour is its forward candidate, f > 0
    nodes[new_id] = node[c];
    nodes[(size_t)nodes_stride + new_id] = node[c + f];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      nodes[(size_t)(2 + k) * nodes_stride + new_id] =
          __float_as_int(ploc::jmin(box[k][c], box[k][c + f]));
  }
  if (keep) {
    const int r = s_ex_k + (ex & 0xffff);
#pragma unroll
    for (int k = 0; k < 6; ++k)
      out[(size_t)k * ostride + r] = __float_as_int(merge ? ploc::jmin(box[k][c], box[k][c + f])
                                                          : box[k][c]);
    out[(size_t)6 * ostride + r] = mat[(size_t)6 * stride + l];
    out[(size_t)7 * ostride + r] = merge ? new_id : node[c];
  }
}

}  // namespace

// status: 2 * ceil(nc / 256) u64 (zeros, or words of earlier epochs);
// ctl: the ticket (0 before the first launch, reset by every launch), then
// (n_merged, n_keep)
extern "C" int tbvh_ploc_round(const int* mat, int stride, int nc, int shift, int radius, int base,
                               int* out, int ostride, int* nodes, int nodes_stride, void* status,
                               int* ctl, int epoch, cudaStream_t stream) {
  ploc_round_kernel<<<(nc + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      mat, stride, nc, shift, radius, base, out, ostride, nodes, nodes_stride,
      reinterpret_cast<unsigned long long*>(status), ctl, (unsigned)epoch);
  return (int)cudaGetLastError();
}
