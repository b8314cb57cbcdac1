// Topology scan for the single-pass LBVH: a bottom-up Apetrei climb.
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/scan32.py:scan_core
// (_both_kernel), which derives every boundary's previous/next smaller
// delta and its two child argmins from 32-lane threshold scans. Same
// contract: from raw adjacent deltas (values [2,31] for distinct codes,
// [41,63] for ties) it writes psv_pos, psv_val, lc, nsv_pos, nsv_val, rc,
// values on the [0,52] scale, sentinels psv -1, nsv m, children -1 = leaf.
//
// Design. The answers are unique (every range of sorted keys has a unique
// minimum delta), so any exact algorithm matches. On the GPU the natural
// one is the reference's own climb: one thread per leaf walks up; a node
// covering leaves [l, r] has its parent at boundary l-1 or r, whichever
// delta is larger. Each child publishes its outer bound with one atomicExch
// on the parent's slot; the second arrival learns the parent's full range
// [l, r] and continues, the first stops. The parent's range gives
// psv = l-1 and nsv = r directly; each child writes its own id into the
// parent's lc/rc. Deltas strictly decrease going up, so no climb is longer
// than 53 steps.
//
// Bound on the card: memory latency of the dependent loads on each climb
// step (a few bytes per step; ~2m atomics in total), not bandwidth. The
// design keeps every thread's state in registers and touches each node
// once; later work can batch the climb per warp.
//
// The same climb also replaces tpu_bvh/ops/pallas/scan32.py:_run (B16),
// which launches _fwd_kernel on the V=32 deltas (distinct codes raw - 2,
// every tie on lane 30) for (psv_pos, psv_val, lc), and _rev_kernel on
// their flip for (nsv_pos, nsv_val, rc) in flipped order and true
// coordinates. tbvh_scan32_fwd / tbvh_scan32_rev rebuild the raw delta
// exactly (a lane-30 tie at true position j is the ruler value
// 32 + clz(j ^ (j + 1)); in the flipped array true position j sits at
// m - 1 - j), climb, and write that half's three outputs. Each half must
// read 4 B and write 12 B per row; like B1 it is bound by the climb's
// dependent loads.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int remap(int raw) { return raw <= 31 ? raw - 2 : raw - 11; }

// The raw adjacent deltas (B1's input).
struct RawDeltas {
  const int* d;
  __device__ int operator()(int j) const { return d[j]; }
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

enum Half { kBoth, kFwd, kRev };  // which outputs a launch writes

// kFwd writes psv_pos, psv_val, lc; kRev writes nsv_pos, nsv_val, rc at
// index m - 1 - p (flipped order, true coordinates); kBoth all six.
template <class Delta, int kHalf>
__global__ void climb_kernel(Delta dlt, int m, int* __restrict__ other,
                             int* __restrict__ psv_pos, int* __restrict__ psv_val,
                             int* __restrict__ lc, int* __restrict__ nsv_pos,
                             int* __restrict__ nsv_val, int* __restrict__ rc) {
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
      if (kHalf != kFwd) rc[kHalf == kRev ? m - 1 - p : p] = node;
      int got = atomicExch(&other[p], r);
      if (got < 0) return;  // first arrival
      l = got;
    } else {  // left child of boundary r
      p = r;
      if (kHalf != kRev) lc[p] = node;
      int got = atomicExch(&other[p], l);
      if (got < 0) return;
      r = got;
    }
    node = p;  // second arrival: node p covers [l, r]
    if (kHalf != kRev) {
      psv_pos[p] = l - 1;
      psv_val[p] = l > 0 ? remap(dlt(l - 1)) : -1;
    }
    if (kHalf != kFwd) {
      const int at = kHalf == kRev ? m - 1 - p : p;
      nsv_pos[at] = r;
      nsv_val[at] = r < m ? remap(dlt(r)) : -1;
    }
  }
}

// every slot of `other` starts at -1 (all bits set): no child has arrived yet
template <int kHalf, class Delta>
int climb(Delta dlt, int m, int* other, int* psv_pos, int* psv_val, int* lc, int* nsv_pos,
          int* nsv_val, int* rc, cudaStream_t stream) {
  const int threads = 256;
  cudaError_t err = cudaMemsetAsync(other, 0xFF, (size_t)m * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  climb_kernel<Delta, kHalf><<<(m + 1 + threads - 1) / threads, threads, 0, stream>>>(
      dlt, m, other, psv_pos, psv_val, lc, nsv_pos, nsv_val, rc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tbvh_scan32(const int* dlt_raw, int m, int* other, int* psv_pos, int* psv_val,
                           int* lc, int* nsv_pos, int* nsv_val, int* rc, cudaStream_t stream) {
  return climb<kBoth>(RawDeltas{dlt_raw}, m, other, psv_pos, psv_val, lc, nsv_pos, nsv_val, rc,
                      stream);
}

// B16, forward half: (psv_pos, psv_val, lc) from the V=32 deltas
extern "C" int tbvh_scan32_fwd(const int* dlt32, int m, int* other, int* psv_pos, int* psv_val,
                               int* lc, cudaStream_t stream) {
  return climb<kFwd>(Dlt32Deltas{dlt32, m, false}, m, other, psv_pos, psv_val, lc, nullptr,
                     nullptr, nullptr, stream);
}

// B16, reverse half: (nsv_pos, nsv_val, rc) from the flipped V=32 deltas,
// written in flipped order
extern "C" int tbvh_scan32_rev(const int* dlt32_flipped, int m, int* other, int* nsv_pos,
                               int* nsv_val, int* rc, cudaStream_t stream) {
  return climb<kRev>(Dlt32Deltas{dlt32_flipped, m, true}, m, other, nullptr, nullptr, nullptr,
                     nsv_pos, nsv_val, rc, stream);
}
