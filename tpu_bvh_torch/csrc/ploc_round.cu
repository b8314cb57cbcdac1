// PLOC round completion: merged-node emission and survivor compaction,
// given the nearest-neighbour stage's output (B9).
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/ploc_round.py:
// ploc_emit_compact (_round_kernel2), which front-compacts both streams
// with in-register binary-shift routing and stitches the blocks together
// through a carry in SMEM over a grid that runs in order. Same contract
// (tpu_bvh_torch/ops/ploc_round.py): over the live lanes i < nc, with
// merge = (nn row 7 == 1) and keep = (nn row 7 != 2),
//   * merge lane i takes id new = base + (merges before i) and writes node
//     column new = [own node id, partner node id (nn row 6), union (nn
//     rows 0-5)]; no other node column is touched;
//   * keep lane i is written to column (keeps before i) of `out`: merged
//     lanes as [union, own code, new], the others unchanged;
//   * every column of `out` past the survivors, [n_keep, S), is zero.
// The ranks are exclusive prefix counts over the whole array.
//
// Design: one launch over the S columns of `out`, tiles of kTile = 1024
// lanes, one a block of 512 threads (two lanes a thread, lane
// tile + k * 512 + thread for k = 0, 1), so that at sponza's 262K lanes
// 256 blocks hold every lane and all of them are resident at once.
// Hopper's blocks run in no order, so the carry is a single-pass scan
// with decoupled look-back (ploc::look_back, as B6's round kernel runs it):
//   1. a block that holds live lanes (index < ceil(nc / kTile)) draws its
//      place from an atomic ticket, so every predecessor is running; the
//      last draw resets the ticket. The blocks past them hold only columns
//      in [nc, S), zero them and leave: they need no count;
//   2. the block scans its merge and keep flags (one read of the flag
//      row), and warp 0 looks back for the merges and keeps before it,
//      32 tiles a step: tiles of 1024 lanes keep the walk at eight steps
//      at 262K lanes, where tiles of 256 lanes took 32 steps of a round
//      trip to the L2 each;
//   3. it writes its merged nodes and survivors at their final places;
//   4. the zero tail. A live lane that is not kept zeroes one column of
//      [n_keep, nc), mirrored from the end: block b has Z_b = lo_b - K_b
//      such lanes before it (lo_b its first lane, K_b the keeps before it),
//      and its z-th one zeroes column nc - 1 - Z_b - z. Columns [nc, S)
//      are zeroed by their own lanes. Every column of [n_keep, S) is
//      written once, and no survivor column is touched, so the wrapper
//      clears nothing;
//   5. the last live block writes n_merged to the wrapper's word.
// Ranks fix every position, so the result is deterministic and equals the
// plain version bit for bit (the kernel does no float arithmetic).
//
// Bound on the card: bytes. The function must read the nn flag row at
// every live lane, the 8 state rows of a survivor that did not merge,
// state rows 6-7 and nn rows 0-6 of a merge lane, and nothing more of a
// dropped lane; it writes 8 rows per survivor and per merged node, and 8
// rows of zeros per column of [n_keep, S). The kernel reads and writes
// just that.

#include "ploc_common.cuh"

namespace {

constexpr int kTile = 1024;  // lanes a block
constexpr int kThreads = 512;
constexpr int kItems = kTile / kThreads;  // lanes a thread

__device__ __forceinline__ void zero_column(int* out, int ostride, int c) {
#pragma unroll
  for (int k = 0; k < 8; ++k) out[(size_t)k * ostride + c] = 0;
}

__global__ void __launch_bounds__(kThreads)
    emit_kernel(const int* __restrict__ mat, int mstride, const int* __restrict__ nn, int nstride,
                int nc, int base, int* __restrict__ out, int ostride, int* __restrict__ nodes,
                int nodes_stride, unsigned long long* status, int* ticket, int* n_merged,
                unsigned epoch) {
  __shared__ int ws[kThreads / 32];
  __shared__ int s_b, s_ex_m, s_ex_k;
  const int nb = (nc + kTile - 1) / kTile;  // blocks with live lanes
  if ((int)blockIdx.x >= nb) {  // only columns of [nc, S)
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int l = blockIdx.x * kTile + k * kThreads + threadIdx.x;
      if (l < ostride) zero_column(out, ostride, l);
    }
    return;
  }
  if (threadIdx.x == 0) {
    const int b = atomicAdd(ticket, 1);
    if (b == nb - 1) atomicExch(ticket, 0);  // every live block has drawn
    s_b = b;
  }
  __syncthreads();
  const int b = s_b;
  const int lo = b * kTile;
  // per lane: merge count << 16 | keep count (at most kTile each), and
  // their exclusive prefix within the tile
  int fl[kItems], ex[kItems], total = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int l = lo + k * kThreads + threadIdx.x;
    const int f = l < nc ? nn[(size_t)7 * nstride + l] : 0;  // 0: neither dropped nor merged
    fl[k] = l < nc ? ((f == 1) << 16) | (f != 2) : 0;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int t;
    ex[k] = total + ploc::block_excl_scan<kThreads>(fl[k], ws, &t);
    total += t;
  }
  if (threadIdx.x < 32) {
    int pm, pk;
    ploc::look_back(status, b, epoch, total >> 16, total & 0xffff, &pm, &pk);
    if (threadIdx.x == 0) {
      s_ex_m = pm;
      s_ex_k = pk;
      if (b == nb - 1) *n_merged = pm + (total >> 16);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int t = k * kThreads + threadIdx.x, l = lo + t;
    if (l >= nc) {
      if (l < ostride) zero_column(out, ostride, l);
      continue;
    }
    const bool merge = (fl[k] >> 16) != 0, keep = (fl[k] & 1) != 0;
    const int new_id = base + s_ex_m + (ex[k] >> 16);
    if (merge) {
      nodes[new_id] = mat[(size_t)7 * mstride + l];
      nodes[(size_t)nodes_stride + new_id] = nn[(size_t)6 * nstride + l];
#pragma unroll
      for (int r = 0; r < 6; ++r)
        nodes[(size_t)(2 + r) * nodes_stride + new_id] = nn[(size_t)r * nstride + l];
    }
    const int kept_before = ex[k] & 0xffff;
    if (keep) {
      const int c = s_ex_k + kept_before;
#pragma unroll
      for (int r = 0; r < 6; ++r)
        out[(size_t)r * ostride + c] =
            merge ? nn[(size_t)r * nstride + l] : mat[(size_t)r * mstride + l];
      out[(size_t)6 * ostride + c] = mat[(size_t)6 * mstride + l];
      out[(size_t)7 * ostride + c] = merge ? new_id : mat[(size_t)7 * mstride + l];
    } else {  // the zero tail in [n_keep, nc), mirrored from the end
      const int z_before = (lo - s_ex_k) + (t - kept_before);
      zero_column(out, ostride, nc - 1 - z_before);
    }
  }
}

}  // namespace

// out: i32[8, ostride], every column written (survivors, then zeros);
// status: 2 * ceil(nc / kTile) u64 (zeros, or words of other epochs); ticket:
// one int, 0 before the first launch and reset by every launch; n_merged:
// the word that receives the merge count
extern "C" int tbvh_ploc_emit_compact(const int* mat, int mstride, const int* nn, int nstride,
                                      int nc, int base, int* out, int ostride, int* nodes,
                                      int nodes_stride, void* status, int* ticket, int* n_merged,
                                      int epoch, cudaStream_t stream) {
  emit_kernel<<<(ostride + kTile - 1) / kTile, kThreads, 0, stream>>>(
      mat, mstride, nn, nstride, nc, base, out, ostride, nodes, nodes_stride,
      reinterpret_cast<unsigned long long*>(status), ticket, n_merged, (unsigned)epoch);
  return (int)cudaGetLastError();
}
