// PLOC round completion: merged-node emission and survivor compaction,
// given the nearest-neighbour stage's output.
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
//     lanes as [union, own code, new], the others unchanged.
// The ranks are exclusive prefix counts over the whole array. Hopper's
// blocks run in no order, so there is no carry: emit_count counts the
// flags of each 256-lane block, emit_scan (one block) turns the counts
// into block offsets and the totals (n_merged, n_keep), emit_scatter
// scans within the block and writes every row at its final place. Ranks
// fix every position, so the result is deterministic and equals the
// plain version bit for bit (the kernels do no float arithmetic).
//
// Bound on the card: bytes. The function must read the nn flag row at
// every live lane, the 8 state rows of a survivor that did not merge,
// state rows 6-7 and nn rows 0-6 of a merge lane, and nothing more of a
// dropped lane; it writes 8 rows per survivor and per merged node. The
// kernels read just that, and the flag row twice (count and scatter).
// Three launches.

#include "ploc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int packed_flags(const int* nn, int nstride, int l, int nc) {
  if (l >= nc) return 0;
  const int f = nn[(size_t)7 * nstride + l];
  return ((f == 1) << 16) | (f != 2);  // merge count << 16 | keep count
}

__global__ void __launch_bounds__(kThreads)
    emit_count(const int* __restrict__ nn, int nstride, int nc, int* __restrict__ counts,
               int nb) {
  __shared__ int ws[kThreads / 32];
  const int l = blockIdx.x * kThreads + threadIdx.x;
  int total;
  ploc::block_excl_scan<kThreads>(packed_flags(nn, nstride, l, nc), ws, &total);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = total >> 16;
    counts[nb + blockIdx.x] = total & 0xffff;
  }
}

// exclusive scan of both count rows in place; totals = (n_merged, n_keep)
__global__ void __launch_bounds__(kScanThreads)
    emit_scan(int* __restrict__ counts, int nb, int* __restrict__ totals) {
  __shared__ int ws[kScanThreads / 32];
  int carry_m = 0, carry_k = 0;
  for (int c0 = 0; c0 < nb; c0 += kScanThreads) {
    const int i = c0 + threadIdx.x;
    const int vm = i < nb ? counts[i] : 0;
    const int vk = i < nb ? counts[nb + i] : 0;
    int tm, tk;
    const int em = ploc::block_excl_scan<kScanThreads>(vm, ws, &tm);
    const int ek = ploc::block_excl_scan<kScanThreads>(vk, ws, &tk);
    if (i < nb) {
      counts[i] = carry_m + em;
      counts[nb + i] = carry_k + ek;
    }
    carry_m += tm;
    carry_k += tk;
  }
  if (threadIdx.x == 0) {
    totals[0] = carry_m;
    totals[1] = carry_k;
  }
}

__global__ void __launch_bounds__(kThreads)
    emit_scatter(const int* __restrict__ mat, int mstride, const int* __restrict__ nn,
                 int nstride, int nc, int base, const int* __restrict__ offsets, int nb,
                 int* __restrict__ out, int ostride, int* __restrict__ nodes, int nodes_stride) {
  __shared__ int ws[kThreads / 32];
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const int fl = packed_flags(nn, nstride, l, nc);
  int total;
  const int ex = ploc::block_excl_scan<kThreads>(fl, ws, &total);
  if (l >= nc) return;
  const bool merge = (fl >> 16) != 0, keep = (fl & 1) != 0;
  const int new_id = base + offsets[blockIdx.x] + (ex >> 16);
  if (merge) {
    nodes[new_id] = mat[(size_t)7 * mstride + l];
    nodes[(size_t)nodes_stride + new_id] = nn[(size_t)6 * nstride + l];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      nodes[(size_t)(2 + k) * nodes_stride + new_id] = nn[(size_t)k * nstride + l];
  }
  if (keep) {
    const int r = offsets[nb + blockIdx.x] + (ex & 0xffff);
#pragma unroll
    for (int k = 0; k < 6; ++k)
      out[(size_t)k * ostride + r] =
          merge ? nn[(size_t)k * nstride + l] : mat[(size_t)k * mstride + l];
    out[(size_t)6 * ostride + r] = mat[(size_t)6 * mstride + l];
    out[(size_t)7 * ostride + r] = merge ? new_id : mat[(size_t)7 * mstride + l];
  }
}

}  // namespace

// scratch: 2 * ceil(nc / 256) + 2 ints; the last two receive (n_merged, n_keep)
extern "C" int tbvh_ploc_emit_compact(const int* mat, int mstride, const int* nn, int nstride,
                                      int nc, int base, int* out, int ostride, int* nodes,
                                      int nodes_stride, int* scratch, cudaStream_t stream) {
  const int nb = (nc + kThreads - 1) / kThreads;
  emit_count<<<nb, kThreads, 0, stream>>>(nn, nstride, nc, scratch, nb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  emit_scan<<<1, kScanThreads, 0, stream>>>(scratch, nb, scratch + 2 * nb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  emit_scatter<<<nb, kThreads, 0, stream>>>(mat, mstride, nn, nstride, nc, base, scratch, nb, out,
                                            ostride, nodes, nodes_stride);
  return (int)cudaGetLastError();
}
