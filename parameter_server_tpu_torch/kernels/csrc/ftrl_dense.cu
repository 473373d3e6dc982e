// ftrl_dense_kernel: the FTRL-proximal step over a whole 1-D slot
// shard, in place.
//
// Replaces the Pallas kernel parameter_server_tpu/ops/ftrl.py::
// ftrl_update (bodies _kernel, _kernel_nomask, _kernel_bf16,
// _kernel_bf16_nomask). Plain version: ops/ftrl.py::ftrl_update_ref.
//
// Bound on the card: HBM bytes. The step does about 20 flops per
// touched slot and moves 4 B of gradient per slot (plus 1 B of mask
// when a mask is given) and, for each touched slot, z and sqrt_n read
// and written: 16 B in f32, 12 B with bf16 sqrt_n. At 3.35 TB/s that
// is far below the card's compute rate, so the design is a single
// coalesced pass: one thread per slot in a grid-stride loop, the
// gradient (or mask) read first and z/sqrt_n touched only where the
// slot is a member, so untouched slots cost 4-5 B instead of 20.
//
// Membership: touched[i] != 0 when a mask is given, else g[i] != 0 (the
// unquantized-push contract). The bf16 sqrt_n narrow dithers with
// dither_hash_u32(flat position, seed) -- the TPU kernel used its
// on-core PRNG per block, which no other device can reproduce; the
// flat-position hash makes this kernel bit-exact against its plain
// version at any launch shape.
#include "ftrl_common.cuh"

template <bool BF16, bool MASK>
__global__ void ftrl_dense_kernel(float* __restrict__ z, void* __restrict__ n_ptr,
                                  const float* __restrict__ g,
                                  const uint8_t* __restrict__ touched,
                                  long long p, FtrlParams prm, bool dither,
                                  uint32_t seed) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < p; i += stride) {
    const float gi = g[i];
    const bool keep = MASK ? (touched[i] != 0) : (gi != 0.f);
    if (!keep) continue;  // untouched slots pass through unchanged
    float ni;
    if (BF16) {
      ni = bf16_bits_to_float(static_cast<const uint16_t*>(n_ptr)[i]);
    } else {
      ni = static_cast<const float*>(n_ptr)[i];
    }
    float zn, nn;
    ftrl_math(z[i], ni, gi, prm, &zn, &nn);
    z[i] = zn;
    if (BF16) {
      static_cast<uint16_t*>(n_ptr)[i] =
          narrow_bf16(nn, dither, static_cast<uint32_t>(i), seed);
    } else {
      static_cast<float*>(n_ptr)[i] = nn;
    }
  }
}

// C entry point for ctypes. Returns the CUDA error code of the launch
// (0 on success); the Python wrapper raises on anything else.
extern "C" int ftrl_dense_launch(float* z, void* sqrt_n, int n_is_bf16,
                                 const float* g, const uint8_t* touched,
                                 long long p, float alpha, float beta, float l1,
                                 float l2, int has_seed, unsigned int seed,
                                 void* stream) {
  if (p <= 0) return 0;
  const FtrlParams prm{alpha, beta, l1, l2};
  const unsigned int blocks = ftrl_grid_blocks(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dither = has_seed != 0;
  if (n_is_bf16) {
    if (touched) {
      ftrl_dense_kernel<true, true><<<blocks, 256, 0, s>>>(z, sqrt_n, g, touched, p, prm, dither, seed);
    } else {
      ftrl_dense_kernel<true, false><<<blocks, 256, 0, s>>>(z, sqrt_n, g, touched, p, prm, dither, seed);
    }
  } else {
    if (touched) {
      ftrl_dense_kernel<false, true><<<blocks, 256, 0, s>>>(z, sqrt_n, g, touched, p, prm, dither, seed);
    } else {
      ftrl_dense_kernel<false, false><<<blocks, 256, 0, s>>>(z, sqrt_n, g, touched, p, prm, dither, seed);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
