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

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int remap(int raw) { return raw <= 31 ? raw - 2 : raw - 11; }

__global__ void climb_kernel(const int* __restrict__ dlt, int m, int* __restrict__ other,
                             int* __restrict__ psv_pos, int* __restrict__ psv_val,
                             int* __restrict__ lc, int* __restrict__ nsv_pos,
                             int* __restrict__ nsv_val, int* __restrict__ rc) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > m) return;  // n = m + 1 leaves
  int l = i, r = i, node = -1;  // start at leaf i; -1 marks a leaf child
  while (true) {
    int dl = l > 0 ? dlt[l - 1] : -1;
    int dr = r < m ? dlt[r] : -1;
    if (dl < 0 && dr < 0) return;  // the root: done
    int p;
    if (dl > dr) {  // right child of boundary l-1
      p = l - 1;
      rc[p] = node;
      int got = atomicExch(&other[p], r);
      if (got < 0) return;  // first arrival
      l = got;
    } else {  // left child of boundary r
      p = r;
      lc[p] = node;
      int got = atomicExch(&other[p], l);
      if (got < 0) return;
      r = got;
    }
    node = p;  // second arrival: node p covers [l, r]
    psv_pos[p] = l - 1;
    psv_val[p] = l > 0 ? remap(dlt[l - 1]) : -1;
    nsv_pos[p] = r;
    nsv_val[p] = r < m ? remap(dlt[r]) : -1;
  }
}

}  // namespace

extern "C" int tbvh_scan32(const int* dlt_raw, int m, int* other, int* psv_pos, int* psv_val,
                           int* lc, int* nsv_pos, int* nsv_val, int* rc, cudaStream_t stream) {
  const int threads = 256;
  // every slot starts at -1 (all bits set): no child has arrived yet
  cudaError_t err = cudaMemsetAsync(other, 0xFF, (size_t)m * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  climb_kernel<<<(m + 1 + threads - 1) / threads, threads, 0, stream>>>(
      dlt_raw, m, other, psv_pos, psv_val, lc, nsv_pos, nsv_val, rc);
  return (int)cudaGetLastError();
}
