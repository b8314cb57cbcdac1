// PLOC finisher: every remaining merge round of the last few thousand
// clusters, in one launch of one thread-block cluster.
//
// Replaces the TPU kernel tpu_bvh/ops/pallas/ploc_round.py: ploc_finish
// (_finish_kernel), which holds a [8, 16384] state in VMEM and runs the
// rounds under an in-kernel stage ladder, the analog of the reference's
// single-block SinglePassPloc (Ploc++Kernel.h:98-209). Same contract
// (tpu_bvh_torch/ops/ploc_round.py:ploc_finish), with one difference: the
// HPLOC segment shift grows by `step` per round, as the plain round loop and
// the documented schedule do, where the TPU kernel hard-codes 3.
//
// A round is B6's (csrc/ploc_round_fused.cu): the radius-R nearest
// neighbour of every live lane by union area within its Morton-prefix
// segment, each pair's area computed once, from its left lane, into a
// table that the right lane's backward search reads; mutual pairs merge at
// ids base + (merges so far) + rank; survivors are compacted in cluster
// order. The loop stops at one cluster; after nc0 + 16 rounds (the TPU
// kernel's bound; only non-finite boxes take that many) it sets the error
// flag, which the wrapper raises.
//
// Design: the rounds are dependent, so their latency is the cost. The live
// count picks the regime, round by round:
//   wide      (nc > kOneCtaAt) a cluster of C = kCtas CTAs of 1024 threads holds
//             the state, CTA r the contiguous slice [r*S, r*S + S) of the
//             lanes, S = ceil(nc / C), in its own shared memory. A slice
//             reads the 2R lanes on each side of it from the CTAs that own
//             them through distributed shared memory (DSMEM) into its halo
//             columns. Each CTA scans its merge/keep flags and publishes
//             its two totals; after a cluster barrier every CTA reads the
//             C totals for its global ranks. Survivors (a merged lane with
//             its union and new id) are written at their global rank into
//             the other buffer of a ping-pong pair, in whichever CTA owns
//             that rank under the next round's slicing, and a second
//             cluster barrier ends the round: two cluster barriers a round
//             and no in-place compaction.
//   one CTA   (32 < nc <= kOneCtaAt) the last wide round writes every
//             survivor into CTA 0, the other CTAs leave after its closing
//             cluster barrier (no one reads their shared memory after it),
//             and CTA 0 goes on alone with block barriers only.
//   one warp  (nc <= 32) warp 0 of CTA 0 holds one cluster per lane in
//             registers: the pair areas come by shuffles, the ranks by
//             __ballot_sync / __popc, the compaction through 1 KB of shared
//             memory (the free area table) under __syncwarp, with no block
//             barrier.
// Scans and loops run over the live count: a thread takes ceil(n / 1024)
// contiguous lanes of its slice, counts them, and one block scan ranks
// them. The arithmetic is ploc_common.cuh's (--fmad=false, _rn, jmin), and
// ranks fix every position, so every node column equals the plain version
// bit for bit.
//
// Shared memory per CTA for a slice capacity `cap`: two state buffers of
// 8 rows x (cap + 4R) ints, the pair-area table R x (cap + 3R) floats,
// best_rel and has_nn bytes: 98 B a lane and 2,848 B more, so cap <= 2336
// within the 227 KB a block may opt in to (less 512 B for the static
// shared memory), and the finisher takes kCtas x 2336 clusters.
//
// Device counters (stats, i64[3][7]): per regime, thread 0 of CTA 0 counts
// rounds and clock64 cycles: the round's total, the NN stage (halo reads,
// pair areas, best_rel), flags and scans (with the cross-CTA totals), the
// node emission, the survivors' compaction, and the time it waits at
// barriers outside the block scan.
//
// Bound on the card: it reads 32 B per cluster once and writes 32 B per
// merged node, about 1 MB at the 16,384-cluster hand-over (0.3 us of
// bandwidth); what it really costs is latency: 36-43 dependent rounds.

#include <cooperative_groups.h>

#include "ploc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kR = ploc::kMaxR;
constexpr int kPad = 2 * kR;  // halo columns on each side of a slice
constexpr int kMaxQ = 4;      // lanes of a slice per thread: cap <= 4096
// the cluster's CTAs: 8 is the portable size (16 timed alike on the H100,
// PERF.md), so no non-portable attribute is set; ploc_round.FIN_CTAS
constexpr int kCtas = 8;
// the live count at which CTA 0 goes on alone (512 and 2048 timed slower,
// PERF.md); ploc_round.FIN_ONE_CTA
constexpr int kOneCtaAt = 1024;
constexpr int kMaxCap = 2336;  // the largest slice (see the note above); ploc_round.FIN_CAP
constexpr int kWarpAt = 32;   // the one-warp regime takes at most 32 clusters
constexpr int kStat = 7;      // rounds, total, nn, scan, emit, compact, barrier

__host__ __device__ constexpr size_t smem_bytes(int cap) {
  return (size_t)4 * 16 * (cap + 2 * kPad) + (size_t)4 * kR * (cap + 3 * kR) +
         (size_t)2 * (cap + 2 * kR);
}
static_assert(kMaxCap <= kMaxQ * kThreads && kOneCtaAt <= kMaxCap && kMaxCap % 4 == 0);
static_assert(smem_bytes(kMaxCap) + 512 <= 232448, "a slice must fit the H100's opt-in");

// The dynamic shared memory of one CTA: the state rows of its slice (lane i
// at column i of row(p, k), halo columns -kPad..-1 and n..n + kPad - 1),
// the forward pair areas of lanes -2R..n + R - 1 (area[d - 1][i + 2R]),
// and best_rel / has_nn of lanes -R..n + R - 1 (at i + R).
struct Slab {
  int* rows;
  float* area;
  signed char* rel;
  bool* has;
  int W, AW;
  __device__ Slab(int* base, int cap) {
    W = cap + 2 * kPad;
    AW = cap + 3 * kR;
    rows = base;
    area = reinterpret_cast<float*>(rows + 16 * W);
    rel = reinterpret_cast<signed char*>(area + kR * AW);
    has = reinterpret_cast<bool*>(rel + cap + 2 * kR);
  }
  __device__ int* row(int p, int k) const { return rows + (p * 8 + k) * W + kPad; }
};

// the address of *p in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ int* remote(const int* p, unsigned rank) {
  int* out;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(p), "r"(rank));
  return out;
}

// clock64 bookkeeping of thread 0 (the others keep theirs in registers)
struct Clock {
  long long (*acc)[kStat];
  long long c0, r0, wait;
  int reg;
  __device__ void round_start(int g) {
    reg = g;
    r0 = c0 = clock64();
    wait = 0;
  }
  __device__ void mark(int j) {
    const long long c1 = clock64();
    if (threadIdx.x == 0) {
      acc[reg][j] += c1 - c0 - wait;
      acc[reg][6] += wait;
    }
    wait = 0;
    c0 = c1;
  }
  __device__ void round_end() {
    mark(5);
    if (threadIdx.x == 0) {
      acc[reg][0] += 1;
      acc[reg][1] += c0 - r0;
    }
  }
  template <class F>
  __device__ void barrier(F f) {
    const long long b0 = clock64();
    f();
    wait += clock64() - b0;
  }
};

// The one-warp regime: every remaining round of nc <= 32 clusters held in
// warp 0's registers (lane i = cluster i). Returns the live count.
__device__ int tail_rounds(const Slab& sm, int p, int nc, int nc0, int& shift, int step,
                           int base, int R, int& rounds, int limit, int* __restrict__ nodes,
                           int nodes_stride, Clock& clk, int (*tail)[kWarpAt]) {
  const unsigned full = 0xffffffffu;
  const int i = threadIdx.x;
  float box[6];
  int code = 0, node = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) box[k] = i < nc ? __int_as_float(sm.row(p, k)[i]) : 0.0f;
  if (i < nc) {
    code = sm.row(p, 6)[i];
    node = sm.row(p, 7)[i];
  }
  while (nc > 1 && rounds < limit) {
    clk.round_start(2);
    const bool valid = i < nc;
    const unsigned sg = ploc::seg_of(code, shift);
    float fa[kR];
    float best = ploc::kBig;
    int rel = 0;
#pragma unroll
    for (int d = 1; d <= kR; ++d) {
      float nb[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) nb[k] = __shfl_down_sync(full, box[k], d);
      const unsigned ns = __shfl_down_sync(full, sg, d);
      float a = ploc::kBig;
      if (d <= R && valid && i + d < nc && ns == sg) a = ploc::union_area(box, nb);
      fa[d - 1] = a;
      if (a < best) {
        best = a;
        rel = d;
      }
    }
#pragma unroll
    for (int d = 1; d <= kR; ++d) {
      const float up = __shfl_up_sync(full, fa[d - 1], d);  // the pair (i - d, i)
      const float a = (d <= R && i >= d) ? up : ploc::kBig;
      if (a < best || (a == best && -d < rel)) {
        best = a;
        rel = -d;
      }
    }
    const bool has = best < ploc::kBig;
    const int j = i + rel;
    const int src = j & 31;
    const int prel = __shfl_sync(full, rel, src);
    float pb[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) pb[k] = __shfl_sync(full, box[k], src);
    const int pnode = __shfl_sync(full, node, src);
    clk.mark(2);
    const bool mutual = has && valid && j >= 0 && j < kWarpAt && prel == -rel;
    const bool merge = mutual && rel > 0;
    const bool keep = valid && !(mutual && rel < 0);
    const unsigned mb = __ballot_sync(full, merge), kb = __ballot_sync(full, keep);
    const unsigned lt = (1u << i) - 1u;
    const int id = base + (nc0 - nc) + __popc(mb & lt);
    clk.mark(3);
    if (merge) {
      nodes[id] = node;
      nodes[(size_t)nodes_stride + id] = pnode;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        box[k] = ploc::jmin(box[k], pb[k]);
        nodes[(size_t)(2 + k) * nodes_stride + id] = __float_as_int(box[k]);
      }
      node = id;
    }
    clk.mark(4);
    if (keep) {
      const int r = __popc(kb & lt);
#pragma unroll
      for (int k = 0; k < 6; ++k) tail[k][r] = __float_as_int(box[k]);
      tail[6][r] = code;
      tail[7][r] = node;
    }
    clk.barrier([] { __syncwarp(); });
    nc -= __popc(mb);
    if (i < nc) {
#pragma unroll
      for (int k = 0; k < 6; ++k) box[k] = __int_as_float(tail[k][i]);
      code = tail[6][i];
      node = tail[7][i];
    }
    clk.barrier([] { __syncwarp(); });
    shift = min(shift + step, 32);
    ++rounds;
    clk.round_end();
  }
  return nc;
}

__global__ void __launch_bounds__(kThreads, 1)
    ploc_finish_kernel(const int* __restrict__ mat, int stride, int nc0, int shift0, int step,
                       int base, int R, int* __restrict__ nodes, int nodes_stride,
                       int* __restrict__ err, long long* __restrict__ stats, int cap) {
  extern __shared__ int dyn[];
  __shared__ long long acc[3][kStat];
  __shared__ int ws[kThreads / 32];
  __shared__ int s_tot[2];            // this CTA's (merges, keeps), read by the cluster
  __shared__ int s_pre[4];            // exclusive (merges, keeps), totals (merges, keeps)
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = kCtas;
  const int rank = (int)cluster.block_rank();
  const Slab sm(dyn, cap);
  if (threadIdx.x < 3 * kStat) acc[threadIdx.x / kStat][threadIdx.x % kStat] = 0;
  Clock clk{acc, 0, 0, 0, 0};

  int nc = nc0, shift = shift0, rounds = 0, p = 0;
  const int limit = nc0 + 16;
  bool wide = nc0 > kOneCtaAt;
  if (!wide && rank != 0) return;  // CTA 0 alone from the start
  {
    const int S = wide ? (nc + C - 1) / C : nc;
    const int lo = wide ? rank * S : 0;
    const int n = max(min(lo + S, nc) - lo, 0);
    for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
      for (int k = 0; k < 8; ++k) sm.row(0, k)[i] = mat[(size_t)k * stride + lo + i];
  }
  if (wide) cluster.sync();
  else __syncthreads();

  while (nc > 1 && rounds < limit) {
    if (!wide && nc <= kWarpAt) {
      if (threadIdx.x >= 32) return;
      // the compaction goes through the area table, which is free by now
      nc = tail_rounds(sm, p, nc, nc0, shift, step, base, R, rounds, limit, nodes, nodes_stride,
                       clk, reinterpret_cast<int(*)[kWarpAt]>(sm.area));
      break;
    }
    clk.round_start(wide ? 0 : 1);
    const int S = wide ? (nc + C - 1) / C : nc;
    const int lo = wide ? rank * S : 0;
    const int n = max(min(lo + S, nc) - lo, 0);  // lanes of this slice
    auto sync_block = [&] { clk.barrier([] { __syncthreads(); }); };

    // 1. halo: the 2R lanes on each side of the slice, from their owners
    if (wide) {
      for (int t = threadIdx.x; t < 2 * kPad * 8; t += kThreads) {
        const int h = t >> 3, k = t & 7;
        const int col = h < kPad ? h - kPad : n + h - kPad;
        const int j = lo + col;
        if (j >= 0 && j < nc) {
          const int o = j / S;
          sm.row(p, k)[col] = remote(sm.row(p, k), o)[j - o * S];
        }
      }
      sync_block();
    }
    // 2. the forward pair areas of lanes -2R .. n + R - 1, BIG where the
    // pair is not a candidate (either lane dead, or two segments): one
    // (lane, offset) pair per thread, so a round's latency is one area
    const int* code_row = sm.row(p, 6);
    for (int x = threadIdx.x; x < (n + 3 * kR) * kR; x += kThreads) {
      const int e = x / kR, d = x % kR + 1;
      const int i = e - 2 * kR;
      const int l = lo + i;
      float a = ploc::kBig;
      if (d <= R && l >= 0 && l + d < nc &&
          ploc::seg_of(code_row[i], shift) == ploc::seg_of(code_row[i + d], shift)) {
        float own[6], nb[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          own[k] = __int_as_float(sm.row(p, k)[i]);
          nb[k] = __int_as_float(sm.row(p, k)[i + d]);
        }
        a = ploc::union_area(own, nb);
      }
      sm.area[(d - 1) * sm.AW + e] = a;
    }
    sync_block();
    // 3. best_rel as ploc::nearest finds it, for lanes -R .. n + R - 1:
    // forward offsets with a strict <, then backward ones, where a tie goes
    // to the smaller index
    for (int e = threadIdx.x; e < n + 2 * kR; e += kThreads) {
      const int c = e + kR;  // area column of lane e - R
      float fw[kR], bw[kR];
#pragma unroll
      for (int d = 1; d <= kR; ++d) {
        fw[d - 1] = sm.area[(d - 1) * sm.AW + c];
        bw[d - 1] = sm.area[(d - 1) * sm.AW + c - d];  // the pair (l - d, l)
      }
      float best = ploc::kBig;
      int r = 0;
#pragma unroll
      for (int d = 1; d <= kR; ++d) {
        if (d <= R && fw[d - 1] < best) {
          best = fw[d - 1];
          r = d;
        }
      }
#pragma unroll
      for (int d = 1; d <= kR; ++d) {
        if (d <= R && (bw[d - 1] < best || (bw[d - 1] == best && -d < r))) {
          best = bw[d - 1];
          r = -d;
        }
      }
      sm.rel[e] = (signed char)r;
      sm.has[e] = best < ploc::kBig;
    }
    sync_block();
    clk.mark(2);

    // 4. flags of this thread's contiguous lanes, ranks within the CTA, then
    // across the cluster from the CTAs' totals
    const int q = (n + kThreads - 1) / kThreads;  // <= kMaxQ
    const int i0 = threadIdx.x * q;
    int fl[kMaxQ];
    int cm = 0, ck = 0;
#pragma unroll
    for (int j = 0; j < kMaxQ; ++j) {
      fl[j] = 0;
      const int i = i0 + j;
      if (j < q && i < n) {
        const int e = i + kR;
        const int br = sm.rel[e];
        const bool mutual = sm.has[e] && sm.rel[e + br] == -br;  // br != 0 when has_nn
        fl[j] = (int)(mutual && br > 0) | ((int)!(mutual && br < 0) << 1);
        cm += fl[j] & 1;
        ck += fl[j] >> 1;
      }
    }
    int tot;
    const int ex = ploc::block_excl_scan<kThreads>((cm << 16) | ck, ws, &tot);
    int pre_m = 0, pre_k = 0, all_m = tot >> 16, all_k = tot & 0xffff;
    if (wide) {
      if (threadIdx.x == 0) {
        s_tot[0] = all_m;
        s_tot[1] = all_k;
      }
      clk.barrier([&] { cluster.sync(); });
      if (threadIdx.x < 32) {
        int m = 0, k = 0;
        if (threadIdx.x < C) {
          const int* t = remote(s_tot, threadIdx.x);
          m = t[0];
          k = t[1];
        }
        int m_in = m, k_in = k;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int ym = __shfl_up_sync(0xffffffffu, m_in, o);
          const int yk = __shfl_up_sync(0xffffffffu, k_in, o);
          if ((int)threadIdx.x >= o) {
            m_in += ym;
            k_in += yk;
          }
        }
        if (threadIdx.x == rank) {
          s_pre[0] = m_in - m;
          s_pre[1] = k_in - k;
        }
        if (threadIdx.x == 31) {
          s_pre[2] = m_in;
          s_pre[3] = k_in;
        }
      }
      sync_block();
      pre_m = s_pre[0];
      pre_k = s_pre[1];
      all_m = s_pre[2];
      all_k = s_pre[3];
    }
    clk.mark(3);

    // 5. merged nodes at base + (merges so far) + global merge rank
    const int id0 = base + (nc0 - nc) + pre_m;
    {
      int r = ex >> 16;
#pragma unroll
      for (int j = 0; j < kMaxQ; ++j) {
        if (fl[j] & 1) {
          const int i = i0 + j;
          const int pr = i + sm.rel[i + kR];
          const int id = id0 + r++;
          nodes[id] = sm.row(p, 7)[i];
          nodes[(size_t)nodes_stride + id] = sm.row(p, 7)[pr];
#pragma unroll
          for (int k = 0; k < 6; ++k)
            nodes[(size_t)(2 + k) * nodes_stride + id] = __float_as_int(
                ploc::jmin(__int_as_float(sm.row(p, k)[i]), __int_as_float(sm.row(p, k)[pr])));
        }
      }
    }
    clk.mark(4);

    // 6. survivors at their global keep rank, into the CTA that owns it
    // under the next round's slicing (CTA 0 once the cluster is done)
    const int nn = all_k;  // the next live count
    const bool next_wide = wide && nn > kOneCtaAt;
    const int S2 = next_wide ? (nn + C - 1) / C : nn;
    {
      int rm = ex >> 16, rk = ex & 0xffff;
#pragma unroll
      for (int j = 0; j < kMaxQ; ++j) {
        if (!(fl[j] & 2)) continue;
        const int i = i0 + j;
        const int g = pre_k + rk++;
        const int o = next_wide ? g / S2 : 0;
        int v[8];
        if (fl[j] & 1) {
          const int pr = i + sm.rel[i + kR];
#pragma unroll
          for (int k = 0; k < 6; ++k)
            v[k] = __float_as_int(
                ploc::jmin(__int_as_float(sm.row(p, k)[i]), __int_as_float(sm.row(p, k)[pr])));
          v[6] = sm.row(p, 6)[i];
          v[7] = id0 + rm++;
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = sm.row(p, k)[i];
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          int* dst = sm.row(1 - p, k);
          if (wide && o != rank) dst = remote(dst, o);
          dst[g - o * S2] = v[k];
        }
      }
    }
    if (wide) clk.barrier([&] { cluster.sync(); });
    else sync_block();
    nc -= all_m;
    shift = min(shift + step, 32);
    ++rounds;
    p ^= 1;
    clk.round_end();
    if (wide && !next_wide) {
      wide = false;
      if (rank != 0) return;  // after the cluster barrier: no one reads this CTA
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    if (nc > 1) *err = 1;
    for (int g = 0; g < 3; ++g)
      for (int j = 0; j < kStat; ++j) stats[g * kStat + j] = acc[g][j];
  }
}

cudaLaunchConfig_t config(size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t set_attributes(size_t smem) {
  return cudaFuncSetAttribute(ploc_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// the number of clusters of the finisher at its largest slice that the
// card can hold at once (0: such a cluster cannot be scheduled)
extern "C" int tbvh_ploc_finish_clusters(int* out) {
  const size_t smem = smem_bytes(kMaxCap);
  cudaError_t e = set_attributes(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(smem, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, ploc_finish_kernel, &cfg);
}

// stats: i64[3][7] (see the note above); cap >= ceil(nc / kCtas) and
// >= min(nc, kOneCtaAt), a multiple of 4, at most kMaxCap
extern "C" int tbvh_ploc_finish(const int* mat, int stride, int nc, int shift, int step, int base,
                                int radius, int* nodes, int nodes_stride, int* err,
                                long long* stats, int cap, cudaStream_t stream) {
  if (cap > kMaxCap || cap % 4 != 0 || cap < (nc + kCtas - 1) / kCtas ||
      cap < min(nc, kOneCtaAt))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(cap);
  cudaError_t e = set_attributes(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(smem, stream, attr);
  e = cudaLaunchKernelEx(&cfg, ploc_finish_kernel, mat, stride, nc, shift, step, base, radius,
                         nodes, nodes_stride, err, stats, cap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
