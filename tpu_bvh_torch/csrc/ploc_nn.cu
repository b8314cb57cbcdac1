// PLOC nearest-neighbour stage: for every lane, the neighbour within +-R
// of smallest union area, the mutual-pair flags, and the union with the
// best forward candidate.
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/ploc_nn.py:
// ploc_nn_round_raw (_nn_kernel, body _nn_body), a [8, 16K] VMEM block
// with a 128-lane halo on each side and pltpu.roll neighbour views. Same
// contract (tpu_bvh_torch/ops/ploc_nn.py): for lanes i < s of the state
// mat (live clusters i < nc),
//   out rows 0-5  min(own box, box of the best forward candidate) as f32
//                 bits (min with +0.0 where there is none),
//   out row 6     that candidate's node id (0 where there is none),
//   out row 7     1 = merge (left of a mutual pair), 2 = dropped (right).
//
// Design: one thread per lane, a block of 256 lanes. The mutual check at
// lane i reads best_rel at i +- R, which depends on the boxes at i +- 2R,
// so the block loads its lanes plus a halo of 2 * kMaxR on each side into
// shared memory once, computes best_rel for its lanes plus kMaxR on each
// side (the threads take two lanes each where needed), synchronises, and
// checks mutuality from shared memory: one launch, no second pass over
// device memory. Bound on the card: bytes, 8 rows read (7 at shift 32,
// where the code row is not needed) and 8 written per lane, about 5 us at
// 262K lanes; the R pair areas per lane (about 150 f32 operations) stay
// well under that.

#include "ploc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 2 * ploc::kMaxR;
constexpr int kTile = kThreads + 2 * kHalo;       // lanes held in shared memory
constexpr int kRelW = kThreads + 2 * ploc::kMaxR;  // lanes whose best_rel is computed

__global__ void __launch_bounds__(kThreads)
    ploc_nn_kernel(const int* __restrict__ mat, int stride, int s, int nc, int shift, int R,
                   int* __restrict__ out, int out_stride) {
  __shared__ float box[6][kTile];
  __shared__ unsigned seg[kTile];
  __shared__ int node[kTile];
  __shared__ signed char rel[kRelW];
  __shared__ signed char fwd[kRelW];
  __shared__ bool has[kRelW];

  const int lo = blockIdx.x * kThreads;
  const int t0 = lo - kHalo;  // lane of tile column 0
  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    const int l = t0 + e;
    const bool in = l >= 0 && l < s;
#pragma unroll
    for (int k = 0; k < 6; ++k) box[k][e] = in ? __int_as_float(mat[(size_t)k * stride + l]) : 0.0f;
    seg[e] = in ? ploc::seg_of(mat[(size_t)6 * stride + l], shift) : 0u;
    node[e] = in ? mat[(size_t)7 * stride + l] : 0;
  }
  __syncthreads();

  auto get_box = [&](int l, int k) { return box[k][l - t0]; };
  auto get_seg = [&](int l) { return seg[l - t0]; };
  const int r0 = lo - ploc::kMaxR;  // lane of rel column 0
  for (int e = threadIdx.x; e < kRelW; e += kThreads) {
    int f;
    bool h;
    rel[e] = (signed char)ploc::nearest(r0 + e, nc, R, get_box, get_seg, &f, &h);
    fwd[e] = (signed char)f;
    has[e] = h;
  }
  __syncthreads();

  const int l = lo + threadIdx.x;
  if (l >= s) return;
  const int e = threadIdx.x + ploc::kMaxR;
  const int br = rel[e];
  bool merge = false, dropped = false;
  for (int d = 1; d <= R; ++d) {
    merge |= br == d && rel[e + d] == -d;
    dropped |= br == -d && rel[e - d] == d;
  }
  const bool live = has[e] && l < nc;
  const int flag = (merge && live) ? 1 : ((dropped && live) ? 2 : 0);
  const int f = fwd[e];
  const int c = l - t0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float p = f > 0 ? box[k][c + f] : 0.0f;
    out[(size_t)k * out_stride + l] = __float_as_int(ploc::jmin(box[k][c], p));
  }
  out[(size_t)6 * out_stride + l] = f > 0 ? node[c + f] : 0;
  out[(size_t)7 * out_stride + l] = flag;
}

}  // namespace

extern "C" int tbvh_ploc_nn(const int* mat, int stride, int s, int nc, int shift, int radius,
                            int* out, int out_stride, cudaStream_t stream) {
  ploc_nn_kernel<<<(s + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      mat, stride, s, nc, shift, radius, out, out_stride);
  return (int)cudaGetLastError();
}
