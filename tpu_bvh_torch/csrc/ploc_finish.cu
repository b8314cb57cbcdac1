// PLOC finisher: every remaining merge round of the last few thousand
// clusters, in one launch of one block.
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/ploc_round.py: ploc_finish
// (_finish_kernel), which holds a [8, 16384] state in VMEM and runs the
// rounds under an in-kernel stage ladder, the analog of the reference's
// single-block SinglePassPloc (Ploc++Kernel.h:98-209). Same contract
// (tpu_bvh_torch/ops/ploc_round.py:ploc_finish), with one difference: the
// HPLOC segment shift grows by `step` per round, as the plain round loop and
// the documented schedule do, where the TPU kernel hard-codes 3.
//
// Design: one block of 1024 threads. The state of the nc0 live clusters
// (8 rows, 32 B a lane) and one best_rel byte per lane sit in dynamic
// shared memory, 33 B a lane, so nc0 <= 7040 within the 227 KB a block
// may opt in to. Thread t owns lanes t, t + 1024, ... (at most 8). Each
// round: (1) the nearest neighbour of every live lane (ploc::nearest, as
// in ploc_nn.cu); (2) merge/keep flags and their ranks, one block scan per
// 1024-lane chunk in cluster order; (3) merged nodes written to device
// memory at base + (merges so far) + rank; (4) survivors compacted in
// place, one row at a time: every owner reads its row value (a merged lane
// its union with its partner), the block synchronises, then writes it at
// its rank (a rank never passes its lane). The loop stops at one cluster;
// after nc0 + 16 rounds (the TPU kernel's bound; only non-finite boxes
// take that many) it sets the error flag, which the wrapper raises.
//
// Bound on the card: it reads 32 B per cluster once and writes 32 B per
// merged node, about 0.26 MB at 4096 clusters (0.08 us of bandwidth);
// what it really costs is latency: about 30 dependent rounds on one SM,
// each with a few dozen block barriers.

#include "ploc_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxK = 8;  // lanes per thread

__global__ void __launch_bounds__(kThreads, 1)
    ploc_finish_kernel(const int* __restrict__ mat, int stride, int nc0, int shift0, int step,
                       int base, int R, int* __restrict__ nodes, int nodes_stride,
                       int* __restrict__ err) {
  extern __shared__ int st[];  // [8][W] state rows, then W bytes of best_rel
  __shared__ int ws[kThreads / 32];
  const int W = nc0;
  signed char* rel = reinterpret_cast<signed char*>(st + 8 * W);
  for (int i = threadIdx.x; i < W; i += kThreads)
#pragma unroll
    for (int k = 0; k < 8; ++k) st[k * W + i] = mat[(size_t)k * stride + i];
  __syncthreads();

  auto get_box = [&](int l, int k) { return __int_as_float(st[k * W + l]); };
  const int K = (W + kThreads - 1) / kThreads;
  const int limit = nc0 + 16;
  int nc = nc0, shift = shift0, rounds = 0;
  while (nc > 1 && rounds < limit) {
    auto get_seg = [&](int l) { return ploc::seg_of(st[6 * W + l], shift); };
    for (int l = threadIdx.x; l < nc; l += kThreads) {
      int f;
      bool h;
      rel[l] = (signed char)ploc::nearest(l, nc, R, get_box, get_seg, &f, &h);
    }
    __syncthreads();

    // flags (bit 0 merge, bit 1 keep) and ranks of the owned lanes. A lane
    // with no candidate ends with best_rel = -R (the tie rule walks it
    // down), which may point before lane 0; within [0, nc) a mutual
    // partner implies a finite pair area, so no has_nn test is needed.
    int rank_m[kMaxK], rank_k[kMaxK], fl[kMaxK];
    int carry_m = 0, carry_k = 0;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      fl[j] = 0;
      if (j < K) {
        const int l = j * kThreads + threadIdx.x;
        if (l < nc) {
          const int d = rel[l];
          const bool mutual = d != 0 && l + d >= 0 && rel[l + d] == -d;
          fl[j] = (mutual && d > 0) | ((!(mutual && d < 0)) << 1);
        }
        int tot;
        const int packed = ((fl[j] & 1) << 16) | (fl[j] >> 1);  // merge << 16 | keep
        const int ex = ploc::block_excl_scan<kThreads>(packed, ws, &tot);
        rank_m[j] = carry_m + (ex >> 16);
        rank_k[j] = carry_k + (ex & 0xffff);
        carry_m += tot >> 16;
        carry_k += tot & 0xffff;
      }
    }
    const int id0 = base + (nc0 - nc);  // ids the finisher allocated so far

#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < K && (fl[j] & 1)) {
        const int l = j * kThreads + threadIdx.x;
        const int p = l + rel[l];
        const int id = id0 + rank_m[j];
        nodes[id] = st[7 * W + l];
        nodes[(size_t)nodes_stride + id] = st[7 * W + p];
#pragma unroll
        for (int k = 0; k < 6; ++k)
          nodes[(size_t)(2 + k) * nodes_stride + id] =
              __float_as_int(ploc::jmin(get_box(l, k), get_box(p, k)));
      }
    }

#pragma unroll 1
    for (int k = 0; k < 8; ++k) {
      int v[kMaxK];
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        v[j] = 0;
        if (j < K && (fl[j] & 2)) {
          const int l = j * kThreads + threadIdx.x;
          if (!(fl[j] & 1)) {
            v[j] = st[k * W + l];
          } else if (k < 6) {
            v[j] = __float_as_int(ploc::jmin(get_box(l, k), get_box(l + rel[l], k)));
          } else {
            v[j] = k == 6 ? st[6 * W + l] : id0 + rank_m[j];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (j < K && (fl[j] & 2)) st[k * W + rank_k[j]] = v[j];
      __syncthreads();
    }
    nc -= carry_m;
    shift = min(shift + step, 32);
    ++rounds;
  }
  if (nc > 1 && threadIdx.x == 0) *err = 1;
}

}  // namespace

extern "C" int tbvh_ploc_finish(const int* mat, int stride, int nc, int shift, int step, int base,
                                int radius, int* nodes, int nodes_stride, int* err,
                                cudaStream_t stream) {
  const size_t smem = (size_t)nc * 33;
  cudaError_t e = cudaFuncSetAttribute(ploc_finish_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ploc_finish_kernel<<<1, kThreads, smem, stream>>>(mat, stride, nc, shift, step, base, radius,
                                                    nodes, nodes_stride, err);
  return (int)cudaGetLastError();
}
