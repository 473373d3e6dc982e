// ftrl_dense_kernel: the FTRL-proximal step over a whole 1-D slot
// shard, in place.
//
// Replaces the Pallas kernel parameter_server_tpu/ops/ftrl.py::
// ftrl_update (bodies _kernel, _kernel_nomask, _kernel_bf16,
// _kernel_bf16_nomask). Plain version: ops/ftrl.py::ftrl_update_ref.
//
// Bound on the card: HBM bytes. The step does about 20 flops per
// member slot. What the inputs need: the membership stream (the whole
// gradient, 4 B a slot, or the mask, 1 B a slot) and, at each member,
// z and sqrt_n read and written (and, with a mask, its gradient read):
// 16 B in f32, 12 B with bf16 sqrt_n. The members' 4-byte accesses land
// in 32-byte DRAM sectors, so the floor is the stream plus every sector
// of z and sqrt_n (and g with a mask) that holds a member, read and
// written (benchmarks/ftrl_bytes.py counts both).
//
// Design: a streaming pass that keeps bytes in flight and runs every warp
// instruction over neighbouring slots. A warp takes tiles; a lane's share
// of a tile is one 16-byte stream load: a quad (4 slots) of g, lanes on
// neighbouring quads, or 16 bytes of the mask, which shuffles turn into
// the membership of 4 quads 128 slots apart, lanes again on neighbouring
// quads. Without a mask a
// warp takes two tiles an iteration, and each iteration's stream loads
// are issued before the previous iteration's gathers. A quad with a member
// loads z and sqrt_n (and, with a mask, g) whole, 16 bytes (8 for bf16
// sqrt_n), all before the math, and is stored whole: its other slots get
// back the bits they had, so untouched slots stay unchanged bit for bit.
// A quad with no member costs its stream bytes only. The grid is
// persistent (as many blocks as the SMs hold). Slots before the first
// index where the stream, z and sqrt_n are all aligned to their loads (a
// view at an odd offset; all of them if no such index exists) and past the
// last whole tile take a scalar route in the same kernel.
//
// Measured against it on an H100 (benchmarks/ftrl_ab.py, PERF.md): 16
// consecutive slots a thread with scalar gathers ran slower than the
// kernel it replaced (each gather instruction over 32 scattered sectors),
// and so did a lane's 16 mask bytes taken as its own 4 quads at a dense
// mask; more quads a lane cost occupancy; a producer warp streaming
// the mask or g by cp.async.bulk into a shared-memory ring was slower
// everywhere but level with a sparse mask; and the math run at every slot
// of a quad, kept at the members only, was slower in every case
// measured.
//
// Membership: touched[i] != 0 when a mask is given, else g[i] != 0 (the
// unquantized-push contract). The bf16 sqrt_n narrow dithers with
// dither_hash_u32(flat position, seed) -- the TPU kernel used its
// on-core PRNG per block, which no other device can reproduce; the
// flat-position hash makes this kernel bit-exact against its plain
// version at any launch shape.
#include "ftrl_common.cuh"

namespace {

constexpr int kThreads = 256;

// one slot on the scalar route
template <bool BF16, bool MASK>
__device__ __forceinline__ void scalar_slot(float* z, void* n, const float* g,
                                            const uint8_t* touched, long long i,
                                            const FtrlParams& prm, bool dither, uint32_t seed) {
  float gi = MASK ? 0.f : g[i];
  const bool keep = MASK ? touched[i] != 0 : gi != 0.f;
  if (!keep) return;  // untouched slots pass through unchanged
  if (MASK) gi = g[i];
  float zn, nn;
  ftrl_math(z[i], load_n<BF16>(n, i), gi, prm, &zn, &nn);
  store_slot<BF16>(z, n, i, zn, nn, dither, static_cast<uint32_t>(i), seed);
}

// the scalar route: slots [0, head) and [body_end, p), spread over the grid
template <bool BF16, bool MASK>
__device__ __forceinline__ void scalar_slots(float* z, void* n, const float* g,
                                             const uint8_t* touched, long long p, long long head,
                                             long long body_end, long long t, long long nt,
                                             const FtrlParams& prm, bool dither, uint32_t seed) {
  const long long n_scalar = head + (p - body_end);
  for (long long s = t; s < n_scalar; s += nt) {
    scalar_slot<BF16, MASK>(z, n, g, touched, s < head ? s : body_end + (s - head), prm, dither,
                            seed);
  }
}

// A lane's share of a warp's tile is one 16-byte stream load, 512 bytes a
// warp: without a mask a quad (4 slots) of g, with one 16 mask bytes (4
// quads' worth). Either way lane l then works on quads l, 32 + l, ... of
// the tile, so that each gather and store instruction of the warp runs
// over 128 neighbouring slots: with a mask, shuffles hand each lane the
// mask bytes of its quads. Without a mask a warp takes two tiles an
// iteration, both loads before either is used; with one a single tile
// (the gathers of its 4 quads fill the registers).
template <bool MASK>
__host__ __device__ constexpr int tiles_per_iteration() {
  return MASK ? 1 : 2;
}

template <bool MASK>
__host__ __device__ constexpr int quads() {
  return MASK ? 4 : 1;
}

template <bool MASK>
__host__ __device__ constexpr long long tile_slots() {
  return 32LL * 4 * quads<MASK>();
}

// first slot of quad q of lane `lane` in the tile at t0
__device__ __forceinline__ long long quad_slot(long long t0, int lane, int q) {
  return t0 + 128 * q + 4 * lane;
}

__device__ __forceinline__ void unpack4(const float4& v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return ((w & 0xFFu) != 0) | (((w >> 8) & 0xFFu) != 0) << 1 | (((w >> 16) & 0xFFu) != 0) << 2 |
         ((w >> 24) != 0) << 3;
}

// The quads of one lane in the tile at t0 whose members `bits` (bit 4q + e:
// slot e of quad q) it holds: each quad with a member loads z and sqrt_n
// (and g, with a mask) whole; then the math at the members; the quad is
// stored whole, its other slots' bits as they were read.
template <bool BF16, bool MASK, int Q>
__device__ __forceinline__ void update_quads(float* z, void* n, const float* g, long long t0,
                                             int lane, uint64_t bits, float (&gc)[Q][4],
                                             const FtrlParams& prm, bool dither, uint32_t seed) {
  float zc[Q][4], nc[Q][4];
  uint2 nraw[Q];  // bf16 sqrt_n as stored
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    nraw[q] = make_uint2(0, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) zc[q][e] = nc[q][e] = 0.f;
    if ((bits >> (4 * q)) & 0xFu) {
      const long long s = quad_slot(t0, lane, q);
      if (MASK) unpack4(__ldg(reinterpret_cast<const float4*>(g + s)), gc[q]);
      unpack4(*reinterpret_cast<const float4*>(z + s), zc[q]);
      if (BF16) {
        nraw[q] = *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(n) + s);
        nc[q][0] = __uint_as_float(nraw[q].x << 16);
        nc[q][1] = __uint_as_float(nraw[q].x & 0xFFFF0000u);
        nc[q][2] = __uint_as_float(nraw[q].y << 16);
        nc[q][3] = __uint_as_float(nraw[q].y & 0xFFFF0000u);
      } else {
        unpack4(*reinterpret_cast<const float4*>(static_cast<const float*>(n) + s), nc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (!((bits >> (4 * q)) & 0xFu)) continue;
    const long long s = quad_slot(t0, lane, q);
    uint32_t nb[4] = {nraw[q].x & 0xFFFFu, nraw[q].x >> 16, nraw[q].y & 0xFFFFu, nraw[q].y >> 16};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((bits >> (4 * q + e)) & 1u) {
        float zn, nn;
        ftrl_math(zc[q][e], nc[q][e], gc[q][e], prm, &zn, &nn);
        zc[q][e] = zn;
        nc[q][e] = nn;
        if (BF16) nb[e] = narrow_bf16(nn, dither, static_cast<uint32_t>(s + e), seed);
      }
    }
    *reinterpret_cast<float4*>(z + s) = make_float4(zc[q][0], zc[q][1], zc[q][2], zc[q][3]);
    if (BF16) {
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(n) + s) =
          make_uint2(nb[0] | (nb[1] << 16), nb[2] | (nb[3] << 16));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(n) + s) =
          make_float4(nc[q][0], nc[q][1], nc[q][2], nc[q][3]);
    }
  }
}

template <bool BF16, bool MASK>
__global__ void __launch_bounds__(kThreads)
    ftrl_dense_kernel(float* __restrict__ z, void* __restrict__ n, const float* __restrict__ g,
                      const uint8_t* __restrict__ touched, long long p, long long head,
                      long long tiles, FtrlParams prm, bool dither, uint32_t seed) {
  constexpr int Q = quads<MASK>();
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * blockDim.x;
  scalar_slots<BF16, MASK>(z, n, g, touched, p, head, head + tiles * tile_slots<MASK>(), t, nt,
                           prm, dither, seed);
  const int lane = threadIdx.x & 31;
  const long long nw = nt / 32;
  constexpr int kTiles = tiles_per_iteration<MASK>();
  // this lane's stream of a tile: mask bytes, or a quad of g
  auto load = [&](long long tile, uint4& m, float4& gq) {
    const bool here = tile < tiles;
    const long long t0 = head + tile * tile_slots<MASK>();
    if (MASK) {
      m = here ? __ldg(reinterpret_cast<const uint4*>(touched + t0) + lane) : make_uint4(0, 0, 0, 0);
    } else {
      gq = here ? __ldg(reinterpret_cast<const float4*>(g + quad_slot(t0, lane, 0)))
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // kTiles tiles a warp an iteration, nw tiles apart; the next iteration's
  // stream loads are issued before this one's gathers
  uint4 m[kTiles], m_next[kTiles];
  float4 gq[kTiles], gq_next[kTiles];
  long long w = t / 32;
#pragma unroll
  for (int h = 0; h < kTiles; ++h) load(w + h * nw, m[h], gq[h]);
  for (; w < tiles; w += kTiles * nw) {
#pragma unroll
    for (int h = 0; h < kTiles; ++h) load(w + (kTiles + h) * nw, m_next[h], gq_next[h]);
#pragma unroll
    for (int h = 0; h < kTiles; ++h) {
      float gc[Q][4];
      uint64_t bits = 0;
      if (MASK) {
        // quad q of this lane is word lane % 4 of lane 8q + lane / 4's load
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int src = 8 * q + lane / 4;
          const uint32_t x = __shfl_sync(0xFFFFFFFFu, m[h].x, src);
          const uint32_t y = __shfl_sync(0xFFFFFFFFu, m[h].y, src);
          const uint32_t zw = __shfl_sync(0xFFFFFFFFu, m[h].z, src);
          const uint32_t ww = __shfl_sync(0xFFFFFFFFu, m[h].w, src);
          const int k = lane % 4;
          bits |= static_cast<uint64_t>(nonzero_bytes(k == 0 ? x : (k == 1 ? y : (k == 2 ? zw : ww))))
                  << (4 * q);
        }
      } else {
        unpack4(gq[h], gc[0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) bits |= static_cast<uint64_t>(gc[0][e] != 0.f) << e;
      }
      // most tiles have no member where a mask is given
      if (bits != 0) {
        update_quads<BF16, MASK, Q>(z, n, g, head + (w + h * nw) * tile_slots<MASK>(), lane,
                                    bits, gc, prm, dither, seed);
      }
      m[h] = m_next[h];
      gq[h] = gq_next[h];
    }
  }
}

template <bool BF16, bool MASK>
cudaError_t launch(float* z, void* n, const float* g, const uint8_t* touched, long long p,
                   const FtrlParams& prm, bool dither, uint32_t seed, cudaStream_t s) {
  static int per_sm = 0;
  // the first slot where the stream and every array a quad loads whole are
  // aligned to their loads' widths; past it, whole tiles
  const Stream streams[4] = {{g, 4, 16},
                             {MASK ? static_cast<const void*>(touched) : static_cast<const void*>(g), 1,
                              MASK ? 16 : 1},
                             {z, 4, 16},
                             {n, BF16 ? 2 : 4, BF16 ? 8 : 16}};
  const long long head = aligned_head(streams, p);
  const long long tiles = (p - head) / tile_slots<MASK>();
  const long long scalar = p - tiles * tile_slots<MASK>();
  const long long per_block = tiles_per_iteration<MASK>() * (kThreads / 32);
  const long long tile_blocks = (tiles + per_block - 1) / per_block;
  const long long scalar_blocks = (scalar + kThreads - 1) / kThreads;
  auto kernel = ftrl_dense_kernel<BF16, MASK>;
  const unsigned int blocks = persistent_blocks(
      kernel, kThreads, 0, tile_blocks > scalar_blocks ? tile_blocks : scalar_blocks, per_sm);
  kernel<<<blocks, kThreads, 0, s>>>(z, n, g, touched, p, head, tiles, prm, dither, seed);
  return cudaGetLastError();
}

}  // namespace

// C entry point for ctypes. Returns the CUDA error code of the launch
// (0 on success); the Python wrapper raises on anything else.
extern "C" int ftrl_dense_launch(float* z, void* sqrt_n, int n_is_bf16,
                                 const float* g, const uint8_t* touched,
                                 long long p, float alpha, float beta, float l1,
                                 float l2, int has_seed, unsigned int seed,
                                 void* stream) {
  if (p <= 0) return 0;
  const FtrlParams prm{alpha, beta, l1, l2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dither = has_seed != 0;
  cudaError_t err;
  if (n_is_bf16) {
    err = touched ? launch<true, true>(z, sqrt_n, g, touched, p, prm, dither, seed, s)
                  : launch<true, false>(z, sqrt_n, g, touched, p, prm, dither, seed, s);
  } else {
    err = touched ? launch<false, true>(z, sqrt_n, g, touched, p, prm, dither, seed, s)
                  : launch<false, false>(z, sqrt_n, g, touched, p, prm, dither, seed, s);
  }
  return static_cast<int>(err);
}
