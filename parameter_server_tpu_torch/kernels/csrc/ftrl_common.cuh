// Shared device code of the two FTRL kernels: the FTRL-proximal step,
// the dither hash and the bf16 narrowing. Each function repeats the
// arithmetic of its plain PyTorch twin in ops/ftrl.py operation for
// operation. The kernels are built with --fmad=false, so no multiply
// and add are contracted into one FMA: every operation rounds once, as
// each eager PyTorch op does, and a kernel matches its plain version
// bit for bit. A later performance change may drop the flag and hold
// the kernels to a tolerance instead.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct FtrlParams {
  float alpha, beta, l1, l2;
};

// ops/ftrl.py::dither_hash_u32 -- the counter hash of (index, seed)
__device__ __forceinline__ uint32_t dither_hash_u32(uint32_t i, uint32_t seed) {
  uint32_t h = (i * 2654435761u) ^ (seed * 0x9E3779B9u);
  h = (h ^ (h >> 15)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// ops/ftrl.py::_ftrl_math -- the FTRL-proximal step on f32 operands
__device__ __forceinline__ void ftrl_math(float z, float n, float g,
                                          const FtrlParams& p, float* z_new,
                                          float* n_new) {
  float eta = p.alpha / (n + p.beta);
  float zt = -z * eta;
  float sgn = zt > 0.f ? 1.f : (zt < 0.f ? -1.f : 0.f);
  float shrunk = fabsf(zt) - p.l1 * eta;
  shrunk = shrunk < 0.f ? 0.f : shrunk;
  float w = sgn * shrunk / (1.f + p.l2 * eta);
  float nn = sqrtf(n * n + g * g);
  float sigma = (nn - n) / p.alpha;
  *z_new = z + g - sigma * w;
  *n_new = nn;
}

// bf16 storage is handled as raw 16-bit patterns: widening is exact
__device__ __forceinline__ float bf16_bits_to_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// f32 -> bf16 bits. With a seed: ops/ftrl.py::stochastic_round_bf16,
// dither indexed by `pos`. Without: round to nearest even, as
// Tensor.to(torch.bfloat16) does.
__device__ __forceinline__ uint16_t narrow_bf16(float x, bool dither,
                                                uint32_t pos, uint32_t seed) {
  uint32_t bits = __float_as_uint(x);
  if (dither) {
    uint32_t rnd = dither_hash_u32(pos, seed) & 0xFFFFu;
    return static_cast<uint16_t>((bits + rnd) >> 16);
  }
  if ((bits & 0x7FFFFFFFu) > 0x7F800000u) {  // NaN: PyTorch's canonical one
    return 0x7FC0u;
  }
  uint32_t lsb = (bits >> 16) & 1u;
  return static_cast<uint16_t>((bits + 0x7FFFu + lsb) >> 16);
}

// one launch shape for both kernels: 256 threads, at most one full wave
// of resident blocks, grid-stride loops for the rest
inline unsigned int ftrl_grid_blocks(long long n) {
  long long blocks = (n + 255) / 256;
  const long long cap = 132LL * 8;  // H100: 132 SMs x (2048 / 256) resident blocks
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned int>(blocks < 1 ? 1 : blocks);
}
