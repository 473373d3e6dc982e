// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the 64 x 64 tile, the JAX package's _block_live tile skip
// and per-element mask, the bf16 mma.sync m16n8k16 product and its
// fragment packing, quad reductions, and the race-probe hooks.
//
// Race probe: a source that defines FLASH_RACE_PROBE before including this
// header gets PROBE_POISON (fill a shared tile with NaN, then a barrier)
// and PROBE_SKEW (a seeded pseudo-random sleep of up to ~1 us per thread)
// for its hand-over points, and the device symbol probe_seed; otherwise
// both macros are empty.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNeg = -1e30f;
constexpr int kTile = 64;  // query rows and keys of a tile

// _block_live on a whole 64 x 64 tile: dead when (causal) even its last
// query row precedes its first key, or (window) even its first query row
// is past its last key's window
template <class A>
__device__ __forceinline__ bool tile_live(const A& a, int q0, int k0) {
  if (!a.causal) return true;
  bool live = a.q_off + q0 + kTile - 1 >= a.k_off + k0;
  if (a.window > 0) live = live && (a.q_off + q0 - (a.k_off + k0 + kTile - 1) < a.window);
  return live;
}

// the TPU kernels' per-element mask: the K tail, causality at global
// positions, the window (q_pos is global, kp indexes the keys)
template <class A>
__device__ __forceinline__ bool key_valid(const A& a, int q_pos, int kp) {
  bool valid = kp < a.sk;
  if (a.causal) {
    const int k_pos = a.k_off + kp;
    valid = valid && k_pos <= q_pos;
    if (a.window > 0) valid = valid && (q_pos - k_pos < a.window);
  }
  return valid;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// D += A.B, A 16x16 row-major, B 16x8 column-major, bf16 in, f32 sums.
// Fragments (g = lane / 4, t = lane % 4): a0 = A[g][2t..2t+1], a1 =
// A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..2t+1][g],
// b1 = B[2t+8..2t+9][g]; c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..].
// So the C fragments of two neighbouring 8-column products are the A
// fragment of one 16-deep product over those columns.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, the first in the low half (the lower index)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// The A fragment of rows row..row+15 and columns col..col+15 of a
// row-major bf16 tile with `stride` elements a row.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int stride,
                                       int row, int col) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const __nv_bfloat16* p = tile + (row + g) * stride + col + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * stride);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * stride + 8);
}

// Copy rows r0..r0+63 of two row-major [n, D] bf16 matrices into two
// shared tiles of `stride` elements a row, 16 bytes a thread, both loads
// of a step made before either store; rows past n are zeros.
template <int D>
__device__ __forceinline__ void stage2_bf16(__nv_bfloat16* ta, __nv_bfloat16* tb, int stride,
                                            const __nv_bfloat16* a, const __nv_bfloat16* b,
                                            int r0, int n) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += blockDim.x) {
    const int row = i / kChunks, ch = i % kChunks;
    uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
    if (r0 + row < n) {
      const size_t off = static_cast<size_t>(r0 + row) * D + ch * 8;
      va = *reinterpret_cast<const uint4*>(a + off);
      vb = *reinterpret_cast<const uint4*>(b + off);
    }
    *reinterpret_cast<uint4*>(ta + row * stride + ch * 8) = va;
    *reinterpret_cast<uint4*>(tb + row * stride + ch * 8) = vb;
  }
}

// The same for float32, one element a thread and step, into tiles of
// strides sa and sb (rows padded against bank conflicts)...
template <int D>
__device__ __forceinline__ void stage2_f32(float* ta, int sa, float* tb, int sb, const float* a,
                                           const float* b, int r0, int n) {
  for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
    const int row = i / D, col = i % D;
    const bool ok = r0 + row < n;
    const size_t off = static_cast<size_t>(r0 + row) * D + col;
    ta[row * sa + col] = ok ? a[off] : 0.f;
    tb[row * sb + col] = ok ? b[off] : 0.f;
  }
}

// ...and for one float32 matrix.
template <int D>
__device__ __forceinline__ void stage_f32(float* tile, int stride, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
    const int row = i / D, col = i % D;
    tile[row * stride + col] = r0 + row < n ? src[static_cast<size_t>(r0 + row) * D + col] : 0.f;
  }
}

#ifdef FLASH_RACE_PROBE
__device__ unsigned probe_seed;

__device__ __forceinline__ void probe_skew(int site, int kt) {
  unsigned h = probe_seed ^ (blockIdx.x * 73856093u) ^ (blockIdx.y * 19349663u) ^
               (threadIdx.x * 83492791u) ^ (site * 2654435761u) ^ (kt * 40503u);
  h ^= h >> 13;
  h *= 0x5bd1e995u;
  h ^= h >> 15;
  __nanosleep(h & 1023u);
}

// fill n elements with NaN, then a barrier: the staging that follows
// writes every element it owns over the poison
template <typename T>
__device__ __forceinline__ void probe_poison(T* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if constexpr (sizeof(T) == 2) {
      reinterpret_cast<uint16_t*>(p)[i] = 0x7fc0u;  // bf16 NaN
    } else {
      reinterpret_cast<uint32_t*>(p)[i] = 0x7fc00000u;  // f32 NaN
    }
  }
  __syncthreads();
}
#define PROBE_SKEW(site, kt) flash::probe_skew(site, kt)
#define PROBE_POISON(p, n) flash::probe_poison(p, n)
#else
#define PROBE_SKEW(site, kt)
#define PROBE_POISON(p, n)
#endif

}  // namespace flash
