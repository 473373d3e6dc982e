// quantize_kernel: stochastic fixed-point quantization of a 1-D float32
// array into uint8 or uint16 codes, its range reduced in the same launch.
//
// Replaces the Pallas kernel parameter_server_tpu/ops/quantize.py::
// _quantize_pallas (body _kernel) and the range it is given (:70-71,
// jnp.min / jnp.max outside the Pallas body). Plain version:
// filter/fixing_float.py::quantize_range, then quantize_codes.
//
// lo = min(x) + 0.0, hi = max(max(x), lo + 1e-12) + 0.0 (1e-12 in f32);
// code = clip(floor((x - lo) / (hi - lo) * levels + u), 0, levels),
// levels = 2^(8b) - 1, u = top 24 bits of dither_hash_u32(i, seed) times
// 2^-24. Where hi == lo the quotient is NaN; the code is then 0, as in the
// plain version.
//
// The range's bits. min and max are exact and order-free, except in two
// places where the card's torch.aminmax answers by its reduction order:
// it keeps the second operand of each combine on a tie, so between +0.0
// and -0.0 the sign of a zero min or max depends on the reduction tree;
// and a NaN anywhere makes both NaN (a NaN operand is kept). quantize_range
// therefore adds +0.0 to lo and to hi: a zero lo or hi is +0.0 (-0.0 + 0.0
// rounds to +0.0), whatever the order, and a NaN lo or hi is the card's
// canonical NaN (an f32 add returns 0x7FFFFFFF for a NaN operand). This
// kernel does the same: fminf / fmaxf for the values, a flag for NaN (both
// NaN if any element is), then the two +0.0 adds. Neither the codes nor
// the decoded values depend on the sign of a zero lo or hi.
//
// Bound on the card: HBM bytes. One read of x (4 B an element) and the
// codes (b B), ~21 operations an element, far below the card's compute
// rate; at P 2^22 that is 5 B an element, ~6.3 us at 3.35 TB/s. The range
// needs a grid-wide reduction before any code can be written, so the
// kernel runs in two phases around one grid barrier (a cooperative launch
// of a persistent grid, every block resident: 1024 threads a block, two a
// SM, so that few blocks, 264, meet at the barrier and leave partials):
// 1. 16-byte loads of x, a min, max and NaN flag a thread, reduced in the
//    block by shuffles, written as the block's partial;
// 2. after the barrier every block reduces all partials to lo and hi
//    (block 0 writes them out), then reads x again with 16-byte loads and
//    stores 4 codes a thread in one 4-byte (u8) or 8-byte (u16) store.
// The second read of x hits the 50 MB L2 while x fits it (16 MB at P
// 2^22); above it (P 2^26: 256 MB) x is read from HBM twice, a floor of
// 8 + b B an element. The TPU kernel's 2048x128 VMEM blocks and the padding
// to whole blocks were layout choices and are gone: any length is taken.
//
// Built with --fmad=false: every operation rounds as the plain version's.
#include <cooperative_groups.h>

#include "ftrl_common.cuh"

namespace cg = cooperative_groups;

// QUANTIZE_STOP=1 / 2, a diagnostic build (segment_ab.py --variant): end
// after phase 1 / after the barrier and the range, to time the phases (the
// results are incomplete)
#ifndef QUANTIZE_STOP
#define QUANTIZE_STOP 0
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void take(float v, float& mn, float& mx, bool& nan) {
  mn = fminf(mn, v);
  mx = fmaxf(mx, v);
  nan = nan || v != v;
}

// the block's min, max and NaN flag, in every thread
__device__ __forceinline__ void block_range(float& mn, float& mx, bool& nan) {
  __shared__ float s_mn[kWarps], s_mx[kWarps];
  __shared__ int s_nan[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
  nan = __any_sync(kFull, nan);
  const int w = threadIdx.x >> 5;
  __syncthreads();  // the buffers' last readers are done
  if ((threadIdx.x & 31) == 0) {
    s_mn[w] = mn;
    s_mx[w] = mx;
    s_nan[w] = nan;
  }
  __syncthreads();
  mn = s_mn[0];
  mx = s_mx[0];
  nan = s_nan[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
    mn = fminf(mn, s_mn[k]);
    mx = fmaxf(mx, s_mx[k]);
    nan = nan || s_nan[k];
  }
}

__device__ __forceinline__ uint32_t code_of(float x, float lo, float span, float levels,
                                            uint32_t i, uint32_t seed) {
  const float scaled = (x - lo) / span * levels;
  const float u = static_cast<float>(dither_hash_u32(i, seed) >> 8) * (1.0f / 16777216.0f);
  float v = floorf(scaled + u);
  v = v >= 0.f ? v : 0.f;  // negatives, and NaN where hi == lo
  v = v <= levels ? v : levels;
  return static_cast<uint32_t>(v);
}

// four codes in one store
__device__ __forceinline__ void store4(uint8_t* q, long long i, const uint32_t (&c)[4]) {
  *reinterpret_cast<uint32_t*>(q + i) = c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24;
}
__device__ __forceinline__ void store4(uint16_t* q, long long i, const uint32_t (&c)[4]) {
  *reinterpret_cast<uint2*>(q + i) = make_uint2(c[0] | c[1] << 16, c[2] | c[3] << 16);
}

// x 16-byte aligned; partials: 3 floats a block (min, max, NaN flag)
template <typename Q>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, long long n, float levels, uint32_t seed,
                    Q* __restrict__ q, float* __restrict__ lo_out, float* __restrict__ hi_out,
                    float* __restrict__ partials) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);

  // phase 1: each block's range
  float mn = INFINITY, mx = -INFINITY;
  bool nan = false;
  for (long long i = tid; i < n4; i += stride) {
    const float4 v = __ldg(x4 + i);
    take(v.x, mn, mx, nan);
    take(v.y, mn, mx, nan);
    take(v.z, mn, mx, nan);
    take(v.w, mn, mx, nan);
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) take(__ldg(x + i), mn, mx, nan);
  block_range(mn, mx, nan);
  const unsigned nb = gridDim.x;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = mn;
    partials[nb + blockIdx.x] = mx;
    partials[2 * nb + blockIdx.x] = nan ? 1.f : 0.f;
  }
#if QUANTIZE_STOP == 1
  return;
#endif
  cg::this_grid().sync();

  // every block: the whole range from the partials
  mn = INFINITY;
  mx = -INFINITY;
  nan = false;
  for (unsigned b = threadIdx.x; b < nb; b += kThreads) {
    mn = fminf(mn, __ldcg(partials + b));
    mx = fmaxf(mx, __ldcg(partials + nb + b));
    nan = nan || __ldcg(partials + 2 * nb + b) != 0.f;
  }
  block_range(mn, mx, nan);
  const float qnan = __int_as_float(0x7fffffff);
  const float lo = __fadd_rn(nan ? qnan : mn, 0.f);
  const float hi = __fadd_rn(nan ? qnan : fmaxf(mx, __fadd_rn(lo, 1e-12f)), 0.f);
  if (tid == 0) {
    *lo_out = lo;
    *hi_out = hi;
  }
  const float span = hi - lo;
#if QUANTIZE_STOP == 2
  return;
#endif

  // phase 2: the codes, 4 a thread
  for (long long i = tid; i < n4; i += stride) {
    const float4 v = __ldg(x4 + i);
    const uint32_t p = static_cast<uint32_t>(4 * i);
    const uint32_t c[4] = {code_of(v.x, lo, span, levels, p, seed),
                           code_of(v.y, lo, span, levels, p + 1, seed),
                           code_of(v.z, lo, span, levels, p + 2, seed),
                           code_of(v.w, lo, span, levels, p + 3, seed)};
    store4(q, 4 * i, c);
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    q[i] = static_cast<Q>(code_of(__ldg(x + i), lo, span, levels, static_cast<uint32_t>(i), seed));
  }
}

template <typename Q>
int launch(const float* x, long long n, float levels, uint32_t seed, void* q, float* lo,
           float* hi, float* partials, int partial_blocks, cudaStream_t s) {
  static int per_sm = 0;
  long long need = (n / 4 + kThreads - 1) / kThreads;
  if (need > partial_blocks) need = partial_blocks;
  const unsigned blocks = persistent_blocks(quantize_kernel<Q>, kThreads, 0, need, per_sm);
  Q* qq = static_cast<Q*>(q);
  void* args[] = {&x, &n, &levels, &seed, &qq, &lo, &hi, &partials};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(quantize_kernel<Q>), dim3(blocks), dim3(kThreads), args, 0,
      s));
}

}  // namespace

// C entry point for ctypes: x float32 [n] (16-byte aligned) -> q uint8 or
// uint16 [n], lo and hi float32 [1]; partials float32 [3 * partial_blocks]
// of scratch, which caps the grid. Returns the CUDA error code of the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int quantize_launch(const float* x, long long n, int num_bytes, unsigned int seed,
                               void* q, float* lo, float* hi, float* partials, int partial_blocks,
                               void* stream) {
  if (n <= 0 || partial_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_bytes == 1) {
    return launch<uint8_t>(x, n, 255.0f, seed, q, lo, hi, partials, partial_blocks, s);
  }
  return launch<uint16_t>(x, n, 65535.0f, seed, q, lo, hi, partials, partial_blocks, s);
}
