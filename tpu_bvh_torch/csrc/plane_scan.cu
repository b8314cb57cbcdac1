// Inclusive cummin / cummax of an i32[m, V] plane along its rows, forward
// or from the bottom (B11).
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/plane_scan.py:plane_scan
// (_scan_kernel), which walks 512-row chunks in order, scans each with
// sublane rolls and carries the last row in VMEM from one grid step to
// the next. Contract (tpu_bvh_torch/ops/plane_scan.py): out[r, c] = op of
// x[0..r, c] (forward) or x[r..m-1, c] (reverse), op = min or max. The
// port's caller is the sharded build's psv and nsv scans
// (tpu_bvh_torch/parallel/sharded_build.py), on [L, 64] threshold planes.
//
// Bound on the card: bytes, the plane read once and written once (256 B
// each per row at V = 64). Hopper's blocks run in no order, so the TPU's
// in-order carry becomes a single-pass chained scan with decoupled
// look-back: one launch, one read and one write of the plane.
//  * Tiles of kRows rows by a strip of kCols columns (wider planes take
//    several strips, each its own chain). Thread 0 draws the block's tile
//    from an atomic ticket in scan order, so every tile before it in its
//    strip has been drawn by a running block (the look-back never waits on
//    a block that is not resident); the last draw resets the ticket.
//  * A thread holds 4 columns of kRowsPerThread consecutive rows in
//    registers, loaded with 16-byte streaming loads where the rows allow
//    it (V a multiple of 4, aligned pointers), and scans them in place;
//    the two half-warps' row groups combine by one shuffle, the block's 8
//    warps through their aggregates in shared memory. Four blocks of 256
//    threads an SM keep 128 KB of loads in flight. (On an H100 at
//    [262143, 64], tiles of 64 rows took 68% longer, of 256 rows 9%
//    longer, plain loads and stores 4-8% longer.)
//  * Warp 0 publishes the tile's per-column aggregate, walks back over the
//    tiles before it (after it, in reverse), taking aggregates until it
//    meets an inclusive prefix, and publishes its own inclusive prefix. A
//    status is one 64-bit word a column, (epoch << 33 | inclusive << 32 |
//    value), so value and flag travel together; the epoch is the wrapper's
//    count of launches, so a word of an earlier call never reads as
//    current and no memset runs.
//  * Every thread folds the tile's carry into its rows and writes them.
// Only min and max, exact and idempotent: the order of the combines does
// not matter and every output is exact.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 64;  // columns per strip: 16 groups of 4
constexpr int kGroups = kCols / 4;
constexpr int kRowsPerThread = 8;
constexpr int kRows = 128;  // rows per tile: 16 row groups of kRowsPerThread
// blocks an SM, which caps a thread at 64 registers: at 73 (three blocks)
// the reverse modes took 26% longer than the forward ones (H100, [262143, 64])
constexpr int kMinBlocks = 4;
static_assert(kRows == kThreads / kGroups * kRowsPerThread, "a tile is the block's rows");
static_assert(kCols == 64, "warp 0's lanes take columns lane and lane + 32");
constexpr unsigned kFull = 0xffffffffu;

template <bool kMin>
__device__ __forceinline__ int op(int a, int b) {
  return kMin ? min(a, b) : max(a, b);
}

__device__ __forceinline__ unsigned long long word(unsigned epoch, bool inclusive, int v) {
  return ((unsigned long long)(epoch << 1 | (unsigned)inclusive) << 32) | (unsigned)v;
}

// status: ceil(m / kRows) * strips * kCols words, tile-major; ctl: the ticket
template <bool kMin, bool kRev, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    plane_scan_kernel(const int* __restrict__ x, int m, int V, int nt, int strips,
                      int* __restrict__ out, unsigned long long* status, int* ctl,
                      unsigned epoch) {
  __shared__ int s_ticket;
  __shared__ __align__(16) int wagg[kWarps][kCols];  // each warp's aggregate
  __shared__ __align__(16) int carry[kCols];  // the op over the tiles before this one
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const int t = atomicAdd(ctl, 1);
    if (t == nt * strips - 1) atomicExch(ctl, 0);  // every block has drawn
    s_ticket = t;
  }
  __syncthreads();
  const int ord = s_ticket / strips, strip = s_ticket - ord * strips;
  const int tile = kRev ? nt - 1 - ord : ord;
  const int g = tid % kGroups;  // columns c0 .. c0 + 3
  const int c0 = strip * kCols + 4 * g;
  const int r0 = tile * kRows + tid / kGroups * kRowsPerThread;
  constexpr int I = kMin ? INT_MAX : INT_MIN;

  int v[kRowsPerThread][4];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = r0 + k;
    const size_t at = (size_t)r * V + c0;
    if (kVec) {
      int4 q = make_int4(I, I, I, I);
      if (r < m && c0 < V) q = __ldcs(reinterpret_cast<const int4*>(x + at));
      v[k][0] = q.x, v[k][1] = q.y, v[k][2] = q.z, v[k][3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k][j] = r < m && c0 + j < V ? __ldcs(x + at + j) : I;
    }
  }
  // the thread's rows, inclusive in scan order; a = the thread's aggregate
#pragma unroll
  for (int k = 1; k < kRowsPerThread; ++k) {
    const int cur = kRev ? kRowsPerThread - 1 - k : k, prev = kRev ? cur + 1 : cur - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[cur][j] = op<kMin>(v[prev][j], v[cur][j]);
  }
  int a[4], pre[4];
  // lanes l and l ^ 16 hold row groups 2w and 2w + 1; in scan order the
  // second takes the first's aggregate
  const bool second = kRev ? lane < 16 : lane >= 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int own = v[kRev ? 0 : kRowsPerThread - 1][j];
    const int o = __shfl_xor_sync(kFull, own, 16);
    pre[j] = second ? o : I;
    a[j] = op<kMin>(own, o);
  }
  if (lane < 16) reinterpret_cast<int4*>(wagg[warp])[g] = make_int4(a[0], a[1], a[2], a[3]);
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (kRev ? w > warp : w < warp) {
      const int4 q = reinterpret_cast<const int4*>(wagg[w])[g];
      pre[0] = op<kMin>(pre[0], q.x), pre[1] = op<kMin>(pre[1], q.y);
      pre[2] = op<kMin>(pre[2], q.z), pre[3] = op<kMin>(pre[3], q.w);
    }
  }

  // the tile's carry: warp 0 publishes its aggregate, walks back to an
  // inclusive prefix and publishes its own; lane l takes columns l, l + 32
  if (warp == 0) {
    int agg[2], ex[2] = {I, I};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      agg[h] = I;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) agg[h] = op<kMin>(agg[h], wagg[w][lane + 32 * h]);
    }
    volatile unsigned long long* st = status + ((size_t)tile * strips + strip) * kCols;
    if (ord == 0) {
      st[lane] = word(epoch, true, agg[0]);
      st[lane + 32] = word(epoch, true, agg[1]);
    } else {
      st[lane] = word(epoch, false, agg[0]);
      st[lane + 32] = word(epoch, false, agg[1]);
      bool done[2] = {false, false};
      for (int p = kRev ? tile + 1 : tile - 1;; p += kRev ? 1 : -1) {
        const volatile unsigned long long* ps = status + ((size_t)p * strips + strip) * kCols;
        unsigned long long w0, w1;
        bool ready;
        do {
          w0 = done[0] ? 0ull : ps[lane];
          w1 = done[1] ? 0ull : ps[lane + 32];
          ready = (done[0] || (unsigned)(w0 >> 33) == epoch) &&
                  (done[1] || (unsigned)(w1 >> 33) == epoch);
        } while (!__all_sync(kFull, ready));
        if (!done[0]) {
          ex[0] = op<kMin>(ex[0], (int)(unsigned)w0);
          done[0] = (w0 >> 32) & 1ull;
        }
        if (!done[1]) {
          ex[1] = op<kMin>(ex[1], (int)(unsigned)w1);
          done[1] = (w1 >> 32) & 1ull;
        }
        if (__all_sync(kFull, done[0] && done[1])) break;  // tile 0 is inclusive
      }
      st[lane] = word(epoch, true, op<kMin>(ex[0], agg[0]));
      st[lane + 32] = word(epoch, true, op<kMin>(ex[1], agg[1]));
    }
    carry[lane] = ex[0];
    carry[lane + 32] = ex[1];
  }
  __syncthreads();

  const int4 cq = reinterpret_cast<const int4*>(carry)[g];
  pre[0] = op<kMin>(pre[0], cq.x), pre[1] = op<kMin>(pre[1], cq.y);
  pre[2] = op<kMin>(pre[2], cq.z), pre[3] = op<kMin>(pre[3], cq.w);
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = r0 + k;
    if (r >= m) break;
    const size_t at = (size_t)r * V + c0;
    if (kVec) {
      if (c0 < V)
        __stcs(reinterpret_cast<int4*>(out + at),
               make_int4(op<kMin>(pre[0], v[k][0]), op<kMin>(pre[1], v[k][1]),
                         op<kMin>(pre[2], v[k][2]), op<kMin>(pre[3], v[k][3])));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < V) __stcs(out + at + j, op<kMin>(pre[j], v[k][j]));
    }
  }
}

template <bool kMin, bool kRev>
cudaError_t run(const int* x, int m, int V, int* out, unsigned long long* status, int* ctl,
                unsigned epoch, cudaStream_t stream) {
  const int nt = (m + kRows - 1) / kRows, strips = (V + kCols - 1) / kCols;
  const bool vec = V % 4 == 0 && (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  if (vec)
    plane_scan_kernel<kMin, kRev, true>
        <<<nt * strips, kThreads, 0, stream>>>(x, m, V, nt, strips, out, status, ctl, epoch);
  else
    plane_scan_kernel<kMin, kRev, false>
        <<<nt * strips, kThreads, 0, stream>>>(x, m, V, nt, strips, out, status, ctl, epoch);
  return cudaGetLastError();
}

}  // namespace

// status: ceil(m / kRows) * ceil(V / kCols) * kCols u64 (zeros, or words of
// earlier epochs); ctl: the ticket (0 before the first launch, reset by
// every launch); epoch in [1, 2^31), a new one each launch
extern "C" int tbvh_plane_scan(const int* x, int m, int V, int is_min, int reverse, int* out,
                               void* status, int* ctl, int epoch, cudaStream_t stream) {
  auto* st = reinterpret_cast<unsigned long long*>(status);
  const unsigned e = (unsigned)epoch;
  cudaError_t err;
  if (is_min)
    err = reverse ? run<true, true>(x, m, V, out, st, ctl, e, stream)
                  : run<true, false>(x, m, V, out, st, ctl, e, stream);
  else
    err = reverse ? run<false, true>(x, m, V, out, st, ctl, e, stream)
                  : run<false, false>(x, m, V, out, st, ctl, e, stream);
  return (int)err;
}
