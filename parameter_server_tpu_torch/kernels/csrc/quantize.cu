// quantize_kernel: stochastic fixed-point quantization of a 1-D float32
// array into uint8 or uint16 codes.
//
// Replaces the Pallas kernel parameter_server_tpu/ops/quantize.py::
// _quantize_pallas (body _kernel). Plain version:
// filter/fixing_float.py::quantize_codes.
//
// code = clip(floor((x - lo) / (hi - lo) * levels + u), 0, levels),
// levels = 2^(8b) - 1, u = top 24 bits of dither_hash_u32(i, seed) times
// 2^-24. lo and hi are reduced outside (torch.aminmax in the wrapper)
// and read here from device memory, so the caller never syncs on them.
// Where hi == lo the quotient is NaN; the code is then 0, as in the
// plain version.
//
// Bound on the card: HBM bytes. Each element reads 4 B of x and writes b
// B of code for ~15 operations, far below the card's compute rate. So
// one coalesced pass, one thread per element in a grid-stride loop,
// writing the narrow code directly (the TPU kernel wrote f32 codes and
// cast them in a second pass). The TPU kernel's 2048x128 VMEM blocks
// and the padding to whole blocks were layout choices and are gone: the
// grid-stride loop takes any length.
#include "ftrl_common.cuh"

template <typename Q>
__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ lo_ptr,
                                const float* __restrict__ hi_ptr,
                                Q* __restrict__ q, long long n, float levels,
                                uint32_t seed) {
  const float lo = *lo_ptr;
  const float span = *hi_ptr - lo;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float scaled = (x[i] - lo) / span * levels;
    const float u = static_cast<float>(dither_hash_u32(static_cast<uint32_t>(i), seed) >> 8) *
                    (1.0f / 16777216.0f);
    float v = floorf(scaled + u);
    v = v >= 0.f ? v : 0.f;  // negatives, and NaN where hi == lo
    v = v <= levels ? v : levels;
    q[i] = static_cast<Q>(v);
  }
}

// C entry point for ctypes. Returns the CUDA error code of the launch
// (0 on success); the Python wrapper raises on anything else.
extern "C" int quantize_launch(const float* x, const float* lo, const float* hi,
                               void* q, int num_bytes, long long n,
                               unsigned int seed, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = ftrl_grid_blocks(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_bytes == 1) {
    quantize_kernel<uint8_t><<<blocks, 256, 0, s>>>(x, lo, hi, static_cast<uint8_t*>(q), n,
                                                    255.0f, seed);
  } else {
    quantize_kernel<uint16_t><<<blocks, 256, 0, s>>>(x, lo, hi, static_cast<uint16_t*>(q), n,
                                                     65535.0f, seed);
  }
  return static_cast<int>(cudaGetLastError());
}
