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
// Bound on the card: bytes (tpu_bvh_torch/utils/work.py, ploc_nn): the 8
// state rows of every live lane read (7 at shift 32, where one segment
// makes the code row unneeded) and the 8 output rows written, about 4.7 us
// at 262K lanes; the R pair areas a lane (18 f32 operations each) stay
// under that.
//
// Design: a block owns kTile = 1000 output lanes and works on kCols = 1024
// table columns, the lanes [lo - 2 kMaxR, lo + kTile + kMaxR): the mutual
// check at lane i reads best_rel at i +- R, and best_rel at a lane reads
// the pair areas up to R lanes back. It
//   1. copies the boxes, codes and node ids of those columns and the kMaxR
//      lanes past them into shared memory (cp.async; the code row only
//      where segments exist, shift < 32);
//   2. computes each pair's union area once, from its left lane, into a
//      table: each of the 256 threads owns 4 adjacent columns, reads the
//      12 boxes they pair with as float4s and writes its 4 x R areas as
//      float4s. Inside the area the min is the hardware's NaN-propagating
//      min.NaN.f32: it differs from jnp.minimum's only in the sign of a
//      zero, and the sign of a zero cannot change a sum or product other
//      than in its own sign, nor a compare;
//   3. finds best_rel for its 4 columns as ploc::nearest does (forward
//      offsets with a strict <, then backward ones, a tie to the smaller
//      index): the forward areas from registers, the backward ones from
//      the table (a pair (i - d, i) as lane i - d computed it), and packs
//      (best_rel, best forward offset, has_nn) into one word a column;
//   4. checks mutuality (best_rel b != 0 and best_rel at i + b == -b) and
//      writes the 8 output rows, lane by lane across the threads, the
//      unions with jnp.minimum's rule (tbvh::jmin), whose bits are kept.
// Every thread has an equal share of each phase, no pair area is computed
// twice, and the halo is 3% of the loads. One launch, no scratch.
// Where clk is not null, thread 0 of block b writes its SM's clock64 to
// clk[5 b + k] at the start (k = 0) and after phases 1-4 (k = 1..4; the
// last after a block barrier, so it holds every thread's writes).

#include "ploc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                            // adjacent table columns a thread owns
constexpr int kCols = kThreads * kLanes;             // table columns a block
constexpr int kTile = kCols - 3 * ploc::kMaxR;       // output lanes a block
constexpr int kBoxW = kCols + ploc::kMaxR;           // lanes of boxes a block holds
constexpr int kWin = kLanes + ploc::kMaxR;           // boxes a thread's areas read
constexpr int kStamps = 5;
static_assert(kWin % 4 == 0 && kBoxW % 4 == 0, "float4 reads of the box rows");

struct Smem {
  float box[6][kBoxW];
  int code[kBoxW];
  int node[kBoxW];
  float area[ploc::kMaxR][kCols];  // area[d - 1][c]: columns c and c + d
  int info[kCols];                 // best_rel | fwd << 8 | has_nn << 16
};

// min of two floats, a NaN propagating (sm_80+); -0.0 and +0.0 in either order
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// ploc::union_area with min_nan for the union's min: the same area up to
// the sign of a zero, so every compare of areas comes out the same
__device__ __forceinline__ float pair_area(const float (&bx)[6][kWin], int i, int j) {
  float u[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) u[k] = min_nan(bx[k][i], bx[k][j]);
  const float ex = __fsub_rn(-u[3], u[0]);
  const float ey = __fsub_rn(-u[4], u[1]);
  const float ez = __fsub_rn(-u[5], u[2]);
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(ex, ey), __fmul_rn(ex, ez)), __fmul_rn(ey, ez));
  return __fmul_rn(2.0f, s);
}

__global__ void __launch_bounds__(kThreads, 2)
    ploc_nn_kernel(const int* __restrict__ mat, int stride, int s, int nc, int shift, int R,
                   int* __restrict__ out, int out_stride, long long* clk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * kTile;
  const int t0 = lo - 2 * ploc::kMaxR;  // lane of column 0
  const bool segs = shift < 32;
  if (clk && tid == 0) clk[kStamps * blockIdx.x] = clock64();

  // 1. the tile
  for (int e = tid; e < kBoxW; e += kThreads) {
    const int l = t0 + e;
    if (l >= 0 && l < s) {
#pragma unroll
      for (int k = 0; k < 6; ++k) tbvh::cp_async4(&sm.box[k][e], mat + (size_t)k * stride + l);
      if (segs) tbvh::cp_async4(&sm.code[e], mat + (size_t)6 * stride + l);
      else sm.code[e] = 0;
      tbvh::cp_async4(&sm.node[e], mat + (size_t)7 * stride + l);
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k) sm.box[k][e] = 0.0f;
      sm.code[e] = 0;
      sm.node[e] = 0;
    }
  }
  tbvh::cp_async_wait_all();
  __syncthreads();
  if (clk && tid == 0) clk[kStamps * blockIdx.x + 1] = clock64();

  // 2. the forward pair areas of columns c0 .. c0 + 3 (kBig where the pair
  // is not a candidate), kept in registers and written to the table
  const int c0 = kLanes * tid;
  float bx[6][kWin];
  unsigned sg[kWin];
#pragma unroll
  for (int q = 0; q < kWin; q += 4) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(&sm.box[k][c0 + q]);
      bx[k][q] = v.x;
      bx[k][q + 1] = v.y;
      bx[k][q + 2] = v.z;
      bx[k][q + 3] = v.w;
    }
    const int4 c = *reinterpret_cast<const int4*>(&sm.code[c0 + q]);
    sg[q] = ploc::seg_of(c.x, shift);
    sg[q + 1] = ploc::seg_of(c.y, shift);
    sg[q + 2] = ploc::seg_of(c.z, shift);
    sg[q + 3] = ploc::seg_of(c.w, shift);
  }
  float a[kLanes][ploc::kMaxR];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int l = t0 + c0 + j;
    const bool valid = l >= 0 && l < nc;
#pragma unroll
    for (int d = 1; d <= ploc::kMaxR; ++d) {
      a[j][d - 1] = (d <= R && valid && l + d < nc && sg[j + d] == sg[j])
                        ? pair_area(bx, j, j + d) : ploc::kBig;
    }
  }
#pragma unroll
  for (int d = 0; d < ploc::kMaxR; ++d)
    *reinterpret_cast<float4*>(&sm.area[d][c0]) = make_float4(a[0][d], a[1][d], a[2][d], a[3][d]);
  __syncthreads();
  if (clk && tid == 0) clk[kStamps * blockIdx.x + 2] = clock64();

  // 3. best_rel of columns c0 .. c0 + 3; the first kMaxR columns' are not
  // needed (their backward pairs lie outside the table)
  if (c0 >= ploc::kMaxR) {
    float best[kLanes];
    int rel[kLanes], fwd[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      best[j] = ploc::kBig;
      rel[j] = 0;
    }
#pragma unroll
    for (int d = 1; d <= ploc::kMaxR; ++d) {
      if (d > R) break;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        if (a[j][d - 1] < best[j]) {
          best[j] = a[j][d - 1];
          rel[j] = d;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) fwd[j] = rel[j];
#pragma unroll
    for (int d = 1; d <= ploc::kMaxR; ++d) {
      if (d > R) break;
      // the areas of columns c0 - 8 .. c0 - 1 at offset d
      const float4 p1 = *reinterpret_cast<const float4*>(&sm.area[d - 1][c0 - 4]);
      float4 p2 = p1;
      if (d > kLanes) p2 = *reinterpret_cast<const float4*>(&sm.area[d - 1][c0 - 8]);
      const float back[8] = {p2.x, p2.y, p2.z, p2.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const int q = j - d;  // the pair (c0 + q, c0 + j)
        const float v = q >= 0 ? a[q < 0 ? 0 : q][d - 1] : back[q + 8];
        if (v < best[j] || (v == best[j] && -d < rel[j])) {
          best[j] = v;
          rel[j] = -d;
        }
      }
    }
    int w[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      w[j] = (rel[j] & 0xff) | (fwd[j] << 8) | ((best[j] < ploc::kBig ? 1 : 0) << 16);
    *reinterpret_cast<int4*>(&sm.info[c0]) = make_int4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();
  if (clk && tid == 0) clk[kStamps * blockIdx.x + 3] = clock64();

  // 4. mutual pairs and the output rows
  for (int i = tid; i < kTile; i += kThreads) {
    const int l = lo + i;
    if (l >= s) break;
    const int c = i + 2 * ploc::kMaxR;
    const int inf = sm.info[c];
    const int br = (signed char)(inf & 0xff);
    const int f = (inf >> 8) & 0xff;
    const int partner = (signed char)(sm.info[c + br] & 0xff);
    const bool mutual = br != 0 && partner == -br;
    const bool live = (inf >> 16) != 0 && l < nc;
    const int flag = (mutual && live) ? (br > 0 ? 1 : 2) : 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float p = f > 0 ? sm.box[k][c + f] : 0.0f;
      out[(size_t)k * out_stride + l] = __float_as_int(ploc::jmin(sm.box[k][c], p));
    }
    out[(size_t)6 * out_stride + l] = f > 0 ? sm.node[c + f] : 0;
    out[(size_t)7 * out_stride + l] = flag;
  }
  if (clk) {
    __syncthreads();
    if (tid == 0) clk[kStamps * blockIdx.x + 4] = clock64();
  }
}

}  // namespace

// clk: null, or i64[ceil(s / kTile), 5] for the phase clocks
extern "C" int tbvh_ploc_nn(const int* mat, int stride, int s, int nc, int shift, int radius,
                            int* out, int out_stride, long long* clk, cudaStream_t stream) {
  // above 48 KB of shared memory; the opt-in holds for the current device
  // only, so it is made on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      ploc_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (e != cudaSuccess) return (int)e;
  ploc_nn_kernel<<<(s + kTile - 1) / kTile, kThreads, sizeof(Smem), stream>>>(
      mat, stride, s, nc, shift, radius, out, out_stride, clk);
  return (int)cudaGetLastError();
}
