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
// each costs a 32-byte sector of DRAM traffic; the floor is the index
// streams plus every sector of z and sqrt_n that a live entry touches,
// read and written (benchmarks/ftrl_bytes.py counts both). The TPU
// kernel's 128-lane row decomposition and its double-buffered row DMAs
// were layout choices of that chip and are not carried over.
//
// Design: one u-position a lane, a warp over 32 consecutive positions, so
// each gather and scatter instruction of a warp runs over neighbouring
// slots (rel comes sorted from host prep, which only helps speed:
// correctness does not depend on it). Eight lanes load the warp's streams,
// 16 bytes of rel and of g and 4 bytes of ok each, with no branch between
// the loads; shuffles hand each lane its entry; then the gather (asking L2
// for the whole 128-byte line), the math and the scatter at a live entry.
// The grid is persistent (as many blocks as the SMs hold). Positions
// before the first index where the three streams are aligned (views at
// odd offsets; all of them if no such index exists) and past the last
// whole warp tile take a scalar route in the same kernel.
//
// Measured against it on an H100 (benchmarks/ftrl_ab.py, PERF.md): four
// consecutive positions a thread, its gathers 4 positions apart across a
// warp, ran 40% slower than the kernel it replaced; the same four turned
// through shared memory into one position a lane, 4-byte stream loads,
// and a producer warp streaming rel, g and ok by cp.async.bulk into a
// shared-memory ring all ran level with it. The sectors the gathers touch,
// not the streams, bound this kernel.
//
// Contracts kept from the TPU kernel:
// - ok entries of rel are duplicate-free (host prep dedups at slot
//   level), so each slot is written by at most one thread; non-ok
//   entries (clipped sentinels that point at a real slot) write nothing;
// - the bf16 narrow dithers with dither_hash_u32(u-position, seed), the
//   stream its plain version draws over the gathered vector.
#include "ftrl_common.cuh"

namespace {

constexpr int kWarpTile = 32;  // u-positions a warp takes at a time, one a lane
constexpr int kThreads = 256;

// one u-position on the scalar route
template <bool BF16>
__device__ __forceinline__ void scalar_pos(float* z, void* n, const int32_t* rel,
                                           const uint8_t* ok, const float* g_u, long long j,
                                           const FtrlParams& prm, bool dither, uint32_t seed) {
  if (!ok[j]) return;
  const float g = g_u[j];
  if (g == 0.f) return;  // membership: the unquantized-push contract
  const long long r = rel[j];
  float zn, nn;
  ftrl_math(z[r], load_n<BF16>(n, r), g, prm, &zn, &nn);
  store_slot<BF16>(z, n, r, zn, nn, dither, static_cast<uint32_t>(j), seed);
}

// the scalar route: positions [0, head) and [body_end, u), spread over the grid
template <bool BF16>
__device__ __forceinline__ void scalar_positions(float* z, void* n, const int32_t* rel,
                                                 const uint8_t* ok, const float* g_u, long long u,
                                                 long long head, long long body_end, long long t,
                                                 long long nt, const FtrlParams& prm, bool dither,
                                                 uint32_t seed) {
  const long long n_scalar = head + (u - body_end);
  for (long long s = t; s < n_scalar; s += nt) {
    scalar_pos<BF16>(z, n, rel, ok, g_u, s < head ? s : body_end + (s - head), prm, dither, seed);
  }
}

// Lane `lane`'s position j0 + lane of the warp tile at j0: its rel, g and
// ok. Eight lanes load the tile's streams, 16 bytes of rel and of g and 4
// of ok each; shuffles hand each lane its own.
struct Entry {
  int32_t r;
  float g;
  uint32_t ok;
};

__device__ __forceinline__ Entry load_entry(const int32_t* rel, const uint8_t* ok,
                                            const float* g_u, long long j0, int lane) {
  Entry e;
  int4 r4 = make_int4(0, 0, 0, 0);
  float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);
  uint32_t ok4 = 0;
  if (lane < kWarpTile / 4) {
    r4 = __ldg(reinterpret_cast<const int4*>(rel + j0) + lane);
    g4 = __ldg(reinterpret_cast<const float4*>(g_u + j0) + lane);
    ok4 = __ldg(reinterpret_cast<const unsigned int*>(ok + j0) + lane);
  }
  const unsigned all = 0xFFFFFFFFu;
  const int src = lane / 4, k = lane % 4;
  const int32_t r[4] = {__shfl_sync(all, r4.x, src), __shfl_sync(all, r4.y, src),
                        __shfl_sync(all, r4.z, src), __shfl_sync(all, r4.w, src)};
  const float g[4] = {__shfl_sync(all, g4.x, src), __shfl_sync(all, g4.y, src),
                      __shfl_sync(all, g4.z, src), __shfl_sync(all, g4.w, src)};
  // a select, not an index: a register array indexed at run time would
  // live in local memory
  e.r = k == 0 ? r[0] : (k == 1 ? r[1] : (k == 2 ? r[2] : r[3]));
  e.g = k == 0 ? g[0] : (k == 1 ? g[1] : (k == 2 ? g[2] : g[3]));
  e.ok = (__shfl_sync(all, ok4, src) >> (8 * k)) & 0xFFu;
  return e;
}

// Gathers that ask L2 to fetch the whole 128-byte line around the slot:
// rel comes sorted, so the next warps' gathers land in the same lines,
// which then come from DRAM once, whole, instead of sector by sector
// (measured: 1.5% off f32, 4.5% off bf16; 256-byte lines the same, 64-byte
// lines half that).
__device__ __forceinline__ float gather_f32(const float* p) {
  float v;
  asm volatile("ld.global.L2::128B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

template <bool BF16>
__device__ __forceinline__ float gather_n(const void* n, long long i) {
  if (BF16) {
    unsigned short h;
    asm volatile("ld.global.L2::128B.u16 %0, [%1];"
                 : "=h"(h)
                 : "l"(static_cast<const uint16_t*>(n) + i));
    return bf16_bits_to_float(h);
  }
  return gather_f32(static_cast<const float*>(n) + i);
}

// (at least 4 blocks an SM: the compiler may take up to 64 registers a
// thread rather than spill to reach 8)
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 4)
    ftrl_sparse_kernel(float* __restrict__ z, void* __restrict__ n,
                       const int32_t* __restrict__ rel, const uint8_t* __restrict__ ok,
                       const float* __restrict__ g_u, long long u, long long head,
                       long long tiles, FtrlParams prm, bool dither, uint32_t seed) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * blockDim.x;
  scalar_positions<BF16>(z, n, rel, ok, g_u, u, head, head + tiles * kWarpTile, t, nt, prm,
                         dither, seed);
  const int lane = threadIdx.x & 31;
  for (long long w = t / 32; w < tiles; w += nt / 32) {
    const long long j = head + w * kWarpTile + lane;
    const Entry e = load_entry(rel, ok, g_u, j - lane, lane);
    if (e.ok == 0 || e.g == 0.f) continue;  // membership: the unquantized-push contract
    float zn, nn;
    ftrl_math(gather_f32(z + e.r), gather_n<BF16>(n, e.r), e.g, prm, &zn, &nn);
    store_slot<BF16>(z, n, e.r, zn, nn, dither, static_cast<uint32_t>(j), seed);
  }
}

template <bool BF16>
cudaError_t launch(float* z, void* n, const int32_t* rel, const uint8_t* ok, const float* g_u,
                   long long u, const FtrlParams& prm, bool dither, uint32_t seed,
                   cudaStream_t s) {
  // the first position where every stream's loads are aligned; past it,
  // whole warp tiles
  const Stream streams[3] = {{rel, 4, 16}, {g_u, 4, 16}, {ok, 1, 4}};
  const long long head = aligned_head(streams, u);
  const long long tiles = (u - head) / kWarpTile;
  const long long scalar_blocks = (u - tiles * kWarpTile + kThreads - 1) / kThreads;
  const long long tile_blocks = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  static int per_sm = 0;
  auto kernel = ftrl_sparse_kernel<BF16>;
  const unsigned int blocks = persistent_blocks(
      kernel, kThreads, 0, tile_blocks > scalar_blocks ? tile_blocks : scalar_blocks, per_sm);
  kernel<<<blocks, kThreads, 0, s>>>(z, n, rel, ok, g_u, u, head, tiles, prm, dither, seed);
  return cudaGetLastError();
}

}  // namespace

// C entry point for ctypes. Returns the CUDA error code of the launch
// (0 on success); the Python wrapper raises on anything else.
extern "C" int ftrl_sparse_launch(float* z, void* sqrt_n, int n_is_bf16,
                                  const int32_t* rel, const uint8_t* ok,
                                  const float* g_u, long long u, float alpha,
                                  float beta, float l1, float l2, int has_seed,
                                  unsigned int seed, void* stream) {
  if (u <= 0) return 0;
  const FtrlParams prm{alpha, beta, l1, l2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dither = has_seed != 0;
  const cudaError_t err =
      n_is_bf16 ? launch<true>(z, sqrt_n, rel, ok, g_u, u, prm, dither, seed, s)
                : launch<false>(z, sqrt_n, rel, ok, g_u, u, prm, dither, seed, s);
  return static_cast<int>(err);
}
