// The front half of the LBVH and PLOC builds, as three launches around
// torch.sort: triangles -> packed rows and the scene box (A), packed rows
// -> the biased 64-bit sort key (B), and one gather after the sort (C).
//
// Replaces no TPU kernel. The JAX package's front half
// (tpu_bvh/models/lbvh.py: _sorted_leaves_from_tris and _sorted_leaves_cols,
// tpu_bvh/ops/aabb.py, tpu_bvh/ops/morton.py) is XLA ops, which XLA fuses
// into a few loops. The port's plain version (ops/front_half.py) runs the
// same chain as about 175 eager PyTorch ops, each a full pass over 4M i64
// or f32 columns; these kernels compute the same bits in three passes.
//
//   A  tris f32[n, 3, 3] -> rows f32[6, n] (min xyz, -max xyz: the fmin of
//      the vertices and of their negations, taken on min_key integers, as
//      aabb.packed_bounds) and box f32[6]: scene min xyz, extent xyz.
//   B  rows -> key i64[n] = (code - 2^31) * 2^32 + prim: the centroid, its
//      place in the scene box, and the 30-bit Morton code (plain, or
//      extended with the host's bit budget, morton.bit_budget).
//   C  skey, pos (torch.sort of the keys) -> codes i64[n] = (skey >> 32) +
//      2^31, rows in sorted order f32[6, n] (rows[:, pos]) and leaf_prim
//      i32[n] (the key's low 32 bits, which are prim_idx[pos]). From
//      triangles prim_idx is arange, so the low bits are pos itself and C
//      gathers at them, reading no pos.
//
// Bound on the card: bytes. A reads 36 B a triangle and writes 24; B
// reads 24 and writes 8; C reads 8, gathers 24 and writes 36: 60 / 32 /
// 68 B a primitive from triangles, 0.64 GB at 4M, 0.19 ms at 3.35 TB/s
// (from PrimRefs B reads 4 B of prim_idx and C 8 B of pos besides). What the design does about it: each kernel
// reads its inputs once and writes only what the next stage reads. A
// stages each tile of triangles into shared memory with 16-byte loads
// (9 floats a triangle are not 16-byte aligned one by one; 256 of them
// are), and each thread then reads its triangle at a stride of 9 words,
// which falls on 32 distinct banks. The scene box is a min over
// order-preserving integer keys (min_key), so it is exact and independent
// of order: warp and block minima, one atomicMin a block and key, and the
// last block to finish turns the keys into the box and resets the scratch
// and the counter for the next launch (no memset a call). B and C are one
// thread a primitive, coalesced except C's gather of the six rows at pos.
//
// Every f32 step is an explicit round-to-nearest intrinsic (nvcc builds
// with --fmad=false besides), the integer code is built in u32 with
// shifts of 32 or more giving 0 (morton._shl / _shr), and the f32 -> i64
// conversion is the C++ cast PyTorch's .to(torch.int64) compiles to, so
// every output equals the plain version's bits.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = kThreads * 9;  // one tile of triangles, 9 floats each
constexpr int kBlocksPerSm = 8;            // A's resident blocks on an SM

// An i32 key of an f32 whose integer order is fmin's: the floats' total
// order (-0.0 < +0.0) with every NaN below all (aabb.min_key).
__device__ __forceinline__ int min_key(float x) {
  const int b = __float_as_int(x);
  return x != x ? INT_MIN : b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float from_min_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

// The block's six minimum keys into the scratch; the last block to arrive
// writes the box (scene min, extent = max - min) and resets the scratch
// keys to INT_MAX and the counter to 0.
__device__ void finish_box(int (&k)[6], int* scratch, unsigned* done, float* box) {
  __shared__ int sk[6];
  __shared__ bool last;
  if (threadIdx.x < 6) sk[threadIdx.x] = INT_MAX;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int v = __reduce_min_sync(0xffffffffu, k[c]);
    if ((threadIdx.x & 31) == 0) atomicMin(&sk[c], v);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) atomicMin(scratch + c, sk[c]);
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x < 3) {
    __threadfence();
    const float lo = from_min_key(atomicExch(scratch + threadIdx.x, INT_MAX));
    const float hi = -from_min_key(atomicExch(scratch + 3 + threadIdx.x, INT_MAX));
    box[threadIdx.x] = lo;
    box[3 + threadIdx.x] = __fsub_rn(hi, lo);
    if (threadIdx.x == 0) *done = 0u;
  }
}

// A. tris f32[n, 3, 3] -> rows f32[6, n] and box
__global__ void __launch_bounds__(kThreads)
    front_box_kernel(const float* __restrict__ tris, int n, float* __restrict__ rows,
                     int* scratch, unsigned* done, float* __restrict__ box) {
  __shared__ __align__(16) float tile[kTileFloats];
  int k[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) k[c] = INT_MAX;
  const bool vec = (reinterpret_cast<uintptr_t>(tris) & 15) == 0;
  for (int t0 = blockIdx.x * kThreads; t0 < n; t0 += gridDim.x * kThreads) {
    const int i = t0 + threadIdx.x;
    const float* g = tris + (size_t)t0 * 9;
    const int nf = min(kThreads, n - t0) * 9;
    __syncthreads();  // the last tile's reads are done
    int j0 = 0;
    if (vec) {
      j0 = nf & ~3;
      for (int j = threadIdx.x * 4; j < j0; j += kThreads * 4)
        *reinterpret_cast<float4*>(tile + j) = __ldg(reinterpret_cast<const float4*>(g + j));
    }
    for (int j = j0 + threadIdx.x; j < nf; j += kThreads) tile[j] = __ldg(g + j);
    __syncthreads();
    if (i < n) {
      const float* v = tile + threadIdx.x * 9;  // v[vertex * 3 + axis]
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int lo = min(min_key(v[a]), min(min_key(v[3 + a]), min_key(v[6 + a])));
        const int ng = min(min_key(-v[a]), min(min_key(-v[3 + a]), min_key(-v[6 + a])));
        rows[(size_t)a * n + i] = from_min_key(lo);
        rows[(size_t)(3 + a) * n + i] = from_min_key(ng);
        k[a] = min(k[a], lo);
        k[3 + a] = min(k[3 + a], ng);
      }
    }
  }
  finish_box(k, scratch, done, box);
}

__device__ __forceinline__ unsigned shl(unsigned x, unsigned s) { return s >= 32u ? 0u : x << s; }
__device__ __forceinline__ unsigned shr(unsigned x, unsigned s) { return s >= 32u ? 0u : x >> s; }

__device__ __forceinline__ unsigned spread2(unsigned v) {  // 16 -> 32 bits
  v &= 0x0000FFFFu;
  v = (v ^ (v << 8)) & 0x00FF00FFu;
  v = (v ^ (v << 4)) & 0x0F0F0F0Fu;
  v = (v ^ (v << 2)) & 0x33333333u;
  v = (v ^ (v << 1)) & 0x55555555u;
  return v;
}

__device__ __forceinline__ unsigned spread3(unsigned x) {  // 10 -> 30 bits
  x = (x * 0x00010001u) & 0xFF0000FFu;
  x = (x * 0x00000101u) & 0x0F00F00Fu;
  x = (x * 0x00000011u) & 0xC30C30C3u;
  x = (x * 0x00000005u) & 0x49249249u;
  return x;
}

// torch.clamp: a NaN passes through; the sign of a zero is lost to the cast
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v != v ? v : fminf(v, hi); }

// morton.extended_morton30_cols' axis_code: p scaled by 2^nbits (0 from 32
// bits on), clamped to [0, f32(2^nbits) - 1], cast as PyTorch casts
__device__ __forceinline__ long long axis_code(float p, unsigned nbits) {
  const float scale = nbits >= 32u ? 0.0f : static_cast<float>(1u << nbits);
  const float hi = __fsub_rn(scale, 1.0f);
  return static_cast<long long>(clamp_max(clamp_min(__fmul_rn(p, scale), 0.0f), hi));
}

struct Budget {  // morton.BitBudget, as u32 where the plain code masks to 32 bits
  int extended, a0, a1, a2;
  unsigned bx, by, bz, px, py;
  bool use_swap, have_pre;
};

__device__ unsigned extended_code(const float (&p)[3], const Budget& b) {
  const long long lx = axis_code(p[b.a0], b.bx);
  const long long ly = axis_code(p[b.a1], b.by);
  const long long lz = axis_code(p[b.a2], b.bz);
  unsigned cx = static_cast<unsigned>(lx), cy = static_cast<unsigned>(ly);
  unsigned cz = static_cast<unsigned>(lz);
  unsigned m = 0u, d0 = 0u, d1 = 0u;
  if (b.have_pre) {
    const unsigned bx1 = b.bx - b.px;
    m = shr(cx & shl(shl(1u, b.px) - 1u, bx1), bx1);
    m = shl(m, b.py * 2u);
    const unsigned bx2 = bx1 - b.py, by1 = b.by - b.py;
    const unsigned t0 = spread2(shr(cx & shl(shl(1u, b.py) - 1u, bx2), bx2));
    const unsigned t1 = spread2(shr(cy & shl(shl(1u, b.py) - 1u, by1), by1));
    m |= t0 * 2u + t1;
    const unsigned bx3 = b.use_swap ? bx2 - 1u : bx2;
    if (b.use_swap) m = shl(m, 1u) | shr(cx & shl(1u, bx3), bx3);
    m = shl(m, bx3 + by1 + b.bz);
    cx &= shl(1u, bx3) - 1u;
    cy &= shl(1u, by1) - 1u;
    if (b.use_swap) {
      d0 = by1 - bx3;
      d1 = by1 - b.bz;
      cx = shl(cx, d0);
    } else {
      d0 = bx3 - by1;
      d1 = bx3 - b.bz;
      cy = shl(cy, d0);
    }
    cz = shl(cz, d1);
  }
  if (b.bz == 0u) return m | (spread2(cx) * 2u + spread2(cy));
  // where(c > 0, spread3(c), 0): only a raw code can be negative (a NaN's
  // cast, or -1 where an axis takes 32 bits or more), and it reads 0
  const bool raw = !b.have_pre;
  const unsigned sx = raw && lx < 0 ? 0u : spread3(cx);
  const unsigned sy = raw && ly < 0 ? 0u : spread3(cy);
  const unsigned sz = raw && lz < 0 ? 0u : spread3(cz);
  const unsigned t3 = b.use_swap ? sy * 4u + sx * 2u + sz : sx * 4u + sy * 2u + sz;
  return m | shr(t3, d0 + d1);
}

// B. rows f32[6, n] -> key i64[n]; prim == nullptr stands for arange(n)
__global__ void __launch_bounds__(kThreads)
    front_keys_kernel(const float* __restrict__ rows, int n, const int* __restrict__ prim,
                      const float* __restrict__ scene_min, const float* __restrict__ ext,
                      Budget b, long long* __restrict__ key) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = __ldg(rows + (size_t)a * n + i);
    const float hi = -__ldg(rows + (size_t)(3 + a) * n + i);
    const float e = __ldg(ext + a);
    const float c = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
    p[a] = __fdiv_rn(__fsub_rn(c, __ldg(scene_min + a)), e > 0.0f ? e : 1.0f);
  }
  unsigned code;
  if (b.extended) {
    code = extended_code(p, b);
  } else {
    unsigned q[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      q[a] = static_cast<unsigned>(static_cast<long long>(
          clamp_max(clamp_min(__fmul_rn(p[a], 1024.0f), 0.0f), 1023.0f)));
    code = spread3(q[0]) * 4u + spread3(q[1]) * 2u + spread3(q[2]);
  }
  const long long pi = prim == nullptr ? i : __ldg(prim + i);
  key[i] = static_cast<long long>((static_cast<unsigned long long>(code ^ 0x80000000u) << 32) +
                                  static_cast<unsigned long long>(pi));
}

// C. skey, pos i64[n] -> codes i64[n], leaf rows f32[6, n], leaf_prim i32[n];
// pos == nullptr gathers at the key's low 32 bits (prim_idx was arange)
__global__ void __launch_bounds__(kThreads)
    front_gather_kernel(const long long* __restrict__ skey, const long long* __restrict__ pos,
                        const float* __restrict__ rows, int n, long long* __restrict__ codes,
                        float* __restrict__ leaf, int* __restrict__ leaf_prim) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const long long s = __ldg(skey + j);
  const long long at = pos == nullptr ? static_cast<long long>(static_cast<unsigned>(s))
                                      : __ldg(pos + j);
  float r[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) r[c] = __ldg(rows + (size_t)c * n + at);
#pragma unroll
  for (int c = 0; c < 6; ++c) leaf[(size_t)c * n + j] = r[c];
  codes[j] = (s >> 32) + 2147483648LL;
  leaf_prim[j] = static_cast<int>(static_cast<unsigned>(s));
}

int box_grid(int n) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (n + kThreads - 1) / kThreads;
  return tiles < sms * kBlocksPerSm ? tiles : sms * kBlocksPerSm;
}

}  // namespace

extern "C" {

// A: tris f32[n, 3, 3] -> rows f32[6, n], box f32[6]. scratch i32[6]
// (INT_MAX when first made) and done u32[1] (0) are reset by the launch.
int tbvh_front_tri_box(const void* tris, int n, void* rows, void* scratch, void* done,
                       void* box, void* stream) {
  front_box_kernel<<<box_grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tris), n, static_cast<float*>(rows),
      static_cast<int*>(scratch), static_cast<unsigned*>(done), static_cast<float*>(box));
  return static_cast<int>(cudaGetLastError());
}

// B: extended == 0 gives the plain 30-bit code and ignores the budget
int tbvh_front_keys(const void* rows, int n, const void* prim, const void* scene_min,
                    const void* ext, int extended, int a0, int a1, int a2, int bits_x,
                    int bits_y, int bits_z, int pre_x, int pre_y, int use_swap, int have_pre,
                    void* key, void* stream) {
  const Budget b{extended, a0, a1, a2,
                 static_cast<unsigned>(bits_x), static_cast<unsigned>(bits_y),
                 static_cast<unsigned>(bits_z), static_cast<unsigned>(pre_x),
                 static_cast<unsigned>(pre_y), use_swap != 0, have_pre != 0};
  front_keys_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), n, static_cast<const int*>(prim),
      static_cast<const float*>(scene_min), static_cast<const float*>(ext), b,
      static_cast<long long*>(key));
  return static_cast<int>(cudaGetLastError());
}

// C: pos may be null where the keys' prims were arange(n)
int tbvh_front_gather(const void* skey, const void* pos, const void* rows, int n, void* codes,
                      void* leaf, void* leaf_prim, void* stream) {
  front_gather_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(skey), static_cast<const long long*>(pos),
      static_cast<const float*>(rows), n, static_cast<long long*>(codes),
      static_cast<float*>(leaf), static_cast<int*>(leaf_prim));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
