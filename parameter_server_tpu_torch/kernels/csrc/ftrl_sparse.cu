// ftrl_sparse_kernel: fused gather -> FTRL-proximal step -> scatter
// over a batch's deduplicated touched slots, in place.
//
// Replaces the Pallas kernel parameter_server_tpu/ops/ftrl_sparse.py::
// ftrl_sparse_update (body _sparse_body via _kernel_f32, _kernel_bf16,
// _kernel_bf16_dither; prep _row_gradient). Plain version:
// ops/ftrl_sparse.py::ftrl_sparse_rows_ref.
//
// Bound on the card: HBM bytes. Per u-position the kernel reads rel
// (4 B), ok (1 B) and g (4 B); for each live entry (ok and g != 0) it
// gathers z and sqrt_n and scatters them back: 16 B in f32, 12 B with
// bf16 sqrt_n. The gathers and scatters are random 4-byte accesses, so
// each costs a 32-byte sector of DRAM traffic: the design keeps the
// index streams coalesced (one thread per u-position, neighbouring
// threads on neighbouring entries) and touches table memory only for
// live entries. The TPU kernel's 128-lane row decomposition and its
// double-buffered row DMAs were layout choices of that chip and are
// not carried over.
//
// Contracts kept from the TPU kernel:
// - ok entries of rel are duplicate-free (host prep dedups at slot
//   level), so each slot is written by at most one thread; non-ok
//   entries (clipped sentinels that point at a real slot) write nothing;
// - the bf16 narrow dithers with dither_hash_u32(u-position, seed), the
//   stream its plain version draws over the gathered vector.
#include "ftrl_common.cuh"

template <bool BF16>
__global__ void ftrl_sparse_kernel(float* __restrict__ z, void* __restrict__ n_ptr,
                                   const int32_t* __restrict__ rel,
                                   const uint8_t* __restrict__ ok,
                                   const float* __restrict__ g_u, long long u,
                                   FtrlParams prm, bool dither, uint32_t seed) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < u; j += stride) {
    if (!ok[j]) continue;
    const float g = g_u[j];
    if (g == 0.f) continue;  // membership: the unquantized-push contract
    const long long r = rel[j];
    float ni;
    if (BF16) {
      ni = bf16_bits_to_float(static_cast<const uint16_t*>(n_ptr)[r]);
    } else {
      ni = static_cast<const float*>(n_ptr)[r];
    }
    float zn, nn;
    ftrl_math(z[r], ni, g, prm, &zn, &nn);
    z[r] = zn;
    if (BF16) {
      static_cast<uint16_t*>(n_ptr)[r] =
          narrow_bf16(nn, dither, static_cast<uint32_t>(j), seed);
    } else {
      static_cast<float*>(n_ptr)[r] = nn;
    }
  }
}

// C entry point for ctypes. Returns the CUDA error code of the launch
// (0 on success); the Python wrapper raises on anything else.
extern "C" int ftrl_sparse_launch(float* z, void* sqrt_n, int n_is_bf16,
                                  const int32_t* rel, const uint8_t* ok,
                                  const float* g_u, long long u, float alpha,
                                  float beta, float l1, float l2, int has_seed,
                                  unsigned int seed, void* stream) {
  if (u <= 0) return 0;
  const FtrlParams prm{alpha, beta, l1, l2};
  const unsigned int blocks = ftrl_grid_blocks(u);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dither = has_seed != 0;
  if (n_is_bf16) {
    ftrl_sparse_kernel<true><<<blocks, 256, 0, s>>>(z, sqrt_n, rel, ok, g_u, u, prm, dither, seed);
  } else {
    ftrl_sparse_kernel<false><<<blocks, 256, 0, s>>>(z, sqrt_n, rel, ok, g_u, u, prm, dither, seed);
  }
  return static_cast<int>(cudaGetLastError());
}
