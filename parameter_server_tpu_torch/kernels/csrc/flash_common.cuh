// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu).
//
// For the float32 kernels on the CUDA cores: the 64 x 64 tile, the JAX
// package's _block_live tile skip and per-element mask, the staging of
// float32 tiles, quad reductions.
//
// For the bf16 kernels on Hopper's tensor cores (sm_90a, on hopper.cuh):
// the warp-specialised block that both share. A block owns 64 rows of one
// side (flash_fwd, flash_bwd_dq: query rows; flash_bwd_dkv: keys) for each
// of its kWG consumer warpgroups (Block). Warpgroup 0 gives its registers up
// (setmaxnreg) and one of its warps produces: it loads the block's own
// tiles once (load_own) and streams the other side's tiles through TMA into
// a ring of stages with full / empty mbarriers (produce). Warpgroups 1..kWG
// consume, 64 own rows each, and release a slot with one arrive a warp. Each computes once the
// run of streamed tiles live for its rows and the run it can take without
// the per-element mask (both are runs: tile_live and "no element masked"
// are monotone along a row of tiles); the mask on the others is a
// branch-free select over each row's kept range (keys_kept, kept).
//
// Race probe: a source that defines FLASH_RACE_PROBE before including this
// header gets PROBE_POISON (fill a shared tile with NaN, then a barrier) and
// PROBE_SKEW (a seeded pseudo-random sleep of up to ~1 us per thread) for
// the float32 kernels' hand-over points, RING_POISON (NaN over a ring slot
// between its release and its refill) and RING_SKEW (the sleep, then the
// warp back in step) for the ring's, and the device symbol probe_seed;
// otherwise all four macros are empty. FLASH_RING_NO_LOAD (the ring's
// barriers arrive without loading) and FLASH_RING_CLOCKS (consumer cycles
// by phase, summed into ring_clocks) are timing diagnostics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;  // query rows and keys of a float32 tile

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

// two f32 rounded to bf16, the first in the low half (the lower index)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows r0..r0+63 of two float32 [n, D] matrices into two shared
// tiles of strides sa and sb (rows padded against bank conflicts), one
// element a thread and step; rows past n are zeros...
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

// ...and of one.
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

// NaN over `bytes` of shared memory, 16 bytes a thread from `lane` of
// `lanes`, ordered before the TMA writes that follow
__device__ __forceinline__ void ring_poison(unsigned char* p, int bytes, int lane, int lanes,
                                           uint32_t word) {
  for (int i = lane * 16; i < bytes; i += lanes * 16)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(word, word, word, word);
  hopper::fence_proxy_async();
}
#define PROBE_SKEW(site, kt) flash::probe_skew(site, kt)
#define PROBE_POISON(p, n) flash::probe_poison(p, n)
// a seeded per-thread sleep, then the warp back in step for the
// warp-synchronous instructions that follow
#define RING_SKEW(site, i)       \
  do {                           \
    flash::probe_skew(site, i);  \
    __syncwarp();                \
  } while (0)
#define RING_POISON(p, bytes, lane, lanes, word) flash::ring_poison(p, bytes, lane, lanes, word)
#else
#define PROBE_SKEW(site, kt)
#define PROBE_POISON(p, n)
#define RING_SKEW(site, i)
#define RING_POISON(p, bytes, lane, lanes, word)
#endif
constexpr uint32_t kNanBf16x2 = 0x7fc07fc0u, kNanF32 = 0x7fc00000u;

// ---------------------------------------------------------------------------
// bf16 on Hopper: the warp-specialised block and its ring of tiles
// ---------------------------------------------------------------------------

// A block of kWG consumer warpgroups of 64 own rows each and a producer
// warpgroup: the registers setmaxnreg leaves the producer and gives each
// consumer thread (producer x 128 + consumers x 128 kWG <= 65,536), and
// what the compiler must give each thread so that the block gets the whole
// register file at launch (65,536 over its threads, down to a multiple of
// 8): kWG 2, 384 threads, 168 (consumers 240); kWG 3, 512, 128 (160).
template <int kWG_>
struct Block {
  static constexpr int kWG = kWG_, kOwnRows = 64 * kWG, kThreads = 128 * (kWG + 1);
  static constexpr int kConsumerWarps = 4 * kWG;  // each releases a ring slot once
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = (65536 - 128 * kProducerRegs) / (128 * kWG) / 8 * 8;
  static constexpr int kWholeFileRegs = 65536 / kThreads / 8 * 8;
};

#ifdef FLASH_RING_NO_LOAD
constexpr bool kNoLoad = true;
#else
constexpr bool kNoLoad = false;
#endif

// The block (Block<kWG>) and its shared memory, in bytes from a
// 1024-byte-aligned base: kOwnTiles own tiles of kOwnRows rows, the ring's
// kStages stages of kStreamed tiles of kRows rows each, then (kStatBytes >
// 0) each stage's float32 statistics, then the barriers full[s], empty[s],
// own.
template <int D, int kWG, int kOwnTiles_, int kRows_, int kStreamed, int kStages_, int kStatBytes_>
struct Layout : Block<kWG> {
  static constexpr int kOwnTiles = kOwnTiles_, kRows = kRows_, kStages = kStages_;
  static constexpr int kOwnTile = Block<kWG>::kOwnRows * D * 2;
  static constexpr int kStreamTile = kRows * D * 2;
  static constexpr int kStageBytes = kStreamed * kStreamTile;
  static constexpr int kOwnA = 0, kOwnB = kOwnTile;
  static constexpr int kRing = kOwnTiles * kOwnTile;          // stage s: its kStreamed tiles
  static constexpr int kStats = kRing + kStages * kStageBytes;
  static constexpr int kStatBytes = kStatBytes_;
  static constexpr int kBars = kStats + kStages * kStatBytes;  // full[s], empty[s], own
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
};

// The block's matrix and the rank of its own tile, rank 0 the tile with the
// most live tiles of the other side (causal: a query side's last tile, a
// key side's first): ranks in order, matrices fastest, so the longest
// blocks start first.
__device__ __forceinline__ void block_tile(int n_own, int& head, int& rank) {
  const int n_heads = gridDim.x / n_own;
  head = blockIdx.x % n_heads;
  rank = blockIdx.x / n_heads;
}

template <int N>
__device__ __forceinline__ int floor_div(int x) {
  return x >= 0 ? x / N : -((N - 1 - x) / N);
}

// Key-tile ranges [x, y] of a consumer warpgroup, kC keys a tile, computed
// once a block: the tiles live for query rows w..w+63 (none if w >= Sq),
// and those where no element needs the mask (no query row past Sq, no key
// past Sk, not crossing the causal diagonal or the window's edge).
template <int kC, class A>
__device__ __forceinline__ int2 key_tiles_live(const A& a, int w, int n_tiles) {
  if (w >= a.sq) return make_int2(0, -1);
  if (!a.causal) return make_int2(0, n_tiles - 1);
  int2 r = make_int2(0, min(n_tiles - 1, floor_div<kC>(a.q_off + w + 63 - a.k_off)));
  if (a.window > 0) r.x = max(0, floor_div<kC>(a.q_off + w - a.k_off - kC + 1 - a.window) + 1);
  return r;
}

template <int kC, class A>
__device__ __forceinline__ int2 key_tiles_full(const A& a, int w) {
  if (w + 64 > a.sq) return make_int2(0, -1);
  int2 r = make_int2(0, floor_div<kC>(a.sk - kC));
  if (a.causal) {
    r.y = min(r.y, floor_div<kC>(a.q_off + w - a.k_off - kC + 1));
    if (a.window > 0) r.x = max(r.x, floor_div<kC>(a.q_off + w + 63 - a.k_off - a.window) + 1);
  }
  return r;
}

__device__ __forceinline__ bool in(int i, int2 r) { return i >= r.x && i <= r.y; }

// the tiles the block streams: those live for either warpgroup (one run)
__device__ __forceinline__ int2 either(int2 r0, int2 r1) {
  if (r1.y < r1.x) return r0;
  if (r0.y < r0.x) return r1;
  return make_int2(min(r0.x, r1.x), max(r0.y, r1.y));
}

// The key indices query row q keeps, as [x, y] (key_valid, and no key of
// a row past Sq).
template <class A>
__device__ __forceinline__ int2 keys_kept(const A& a, int q) {
  if (q >= a.sq) return make_int2(0, -1);
  int2 r = make_int2(0, a.sk - 1);
  if (a.causal) {
    const int q_pos = a.q_off + q;
    r.y = min(r.y, q_pos - a.k_off);
    if (a.window > 0) r.x = max(r.x, q_pos - a.window + 1 - a.k_off);
  }
  return r;
}

// Whether element 4j + e of a thread's accumulator fragment is kept: its
// column col0 + 8j + e % 2 lies in the range of its row e / 2 (always,
// when the tile is not masked). Branch-free: a select, not a jump.
template <bool kMasked>
__device__ __forceinline__ bool kept(const int2 (&range)[2], int col0, int j, int e) {
  if (!kMasked) return true;
  const int col = col0 + 8 * j + (e & 1);
  const int2 r = range[e >> 1];
  return (col >= r.x) & (col <= r.y);
}

// 2^x on the MUFU unit (about 2 ulp), subnormal results flushed to zero
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the A fragments of the N / 16 16-column slices of a 64 x N accumulator
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&f)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_f32(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

// acc[64 x D] += A[64 x K].B, A in registers, B a streamed tile of K rows
// read MN-major (db: its descriptor at k-step 0)
template <int D, int K>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2], const uint32_t (&f)[K / 16][4],
                                           uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t d = hopper::desc_advance(db, kk * 16 * 128);
    if constexpr (D == 64) {
      hopper::wgmma_rs_n64(acc, f[kk], d, 1);
    } else {
      hopper::wgmma_rs_n128(acc, f[kk], d, 1);
    }
  }
}

// s[64 x N] = A.B^T, A 64 rows of an own tile (kOwnRows rows), B a
// streamed tile of N rows, both K-major over the D columns (da, db: their
// descriptors at k-step 0)
template <int D, int N, int kOwnRows>
__device__ __forceinline__ void product_ss(float (&s)[N / 2], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = (kk & 3) * 32;  // bytes into a 128-byte row of a 64-column half
    const uint64_t a = hopper::desc_advance(da, (kk >> 2) * kOwnRows * 128 + col);
    const uint64_t b = hopper::desc_advance(db, (kk >> 2) * N * 128 + col);
    if constexpr (N == 64) {
      hopper::wgmma_ss_n64(s, a, b, kk);
    } else {
      hopper::wgmma_ss_n128(s, a, b, kk);
    }
  }
}

// The block's smem base (1024-byte aligned) and its generic pointer.
__device__ __forceinline__ uint32_t smem_base(unsigned char* raw_ptr, unsigned char*& smem) {
  const uint32_t raw = hopper::smem_u32(raw_ptr);
  const uint32_t base = (raw + 1023u) & ~1023u;
  smem = raw_ptr + (base - raw);
  return base;
}

// Barrier set-up, and (probe) the own tiles poisoned; every thread.
template <class L>
__device__ __forceinline__ void block_setup(unsigned char* smem, uint32_t full, uint32_t empty,
                                            uint32_t own) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, L::kConsumerWarps);
    }
    hopper::mbar_init(own, 1);
    hopper::fence_barrier_init();
  }
  RING_POISON(smem + L::kOwnA, L::kOwnTiles * L::kOwnTile, threadIdx.x, L::kThreads, kNanBf16x2);
  __syncthreads();
}

// The producer's load of the block's own tiles (lane 0 of warp 0): rows
// r0.. of matrix n of map_a (and map_b, with two own tiles).
template <class L, int D>
__device__ __forceinline__ void load_own(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                         uint32_t base, uint32_t own, int r0, int n) {
  if (kNoLoad) return hopper::mbar_arrive(own);
  hopper::mbar_expect_tx(own, L::kOwnTiles * L::kOwnTile);
#pragma unroll
  for (int h = 0; h < D / 64; ++h) {
    hopper::tma_load_3d(base + L::kOwnA + h * L::kOwnRows * 128, map_a, own, 64 * h, r0, n);
    if constexpr (L::kOwnTiles == 2)
      hopper::tma_load_3d(base + L::kOwnB + h * L::kOwnRows * 128, map_b, own, 64 * h, r0, n);
  }
}

// The producer's loop (warp 0 of warpgroup 0): for each tile i of `tiles`
// (of each of the `heads` matrices from n0 on), wait for its ring slot to
// be released, (probe) poison it, and load rows kRows i.. of both streamed
// maps into it; with statistics (L::kStatBytes > 0: flash_bwd_dkv), also
// the kRows lse and c from flat index kRows i + n sq.
template <class L, int D>
__device__ __forceinline__ void produce(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                        const CUtensorMap* map_lse, const CUtensorMap* map_c,
                                        int sq, unsigned char* smem, uint32_t base, uint32_t full,
                                        uint32_t empty, int2 tiles, int n0, int heads) {
  constexpr int kRows = L::kRows;
  const int lane = threadIdx.x;
  int stage = 0;
  uint32_t phase = 0;
  for (int n = n0; n < n0 + heads; ++n) {
    for (int i = tiles.x; i <= tiles.y; ++i) {
      RING_SKEW(4, i);
      hopper::mbar_wait(empty + 8 * stage, phase ^ 1);
      RING_POISON(smem + L::kRing + stage * L::kStageBytes, L::kStageBytes, lane, 32, kNanBf16x2);
      if constexpr (L::kStatBytes > 0)
        RING_POISON(smem + L::kStats + stage * L::kStatBytes, L::kStatBytes, lane, 32, kNanF32);
      __syncwarp();
      RING_SKEW(5, i);
      if (lane == 0) {
        const uint32_t f = full + 8 * stage;
        if (kNoLoad) {
          hopper::mbar_arrive(f);
        } else {
          const uint32_t slot = base + L::kRing + stage * L::kStageBytes;
          hopper::mbar_expect_tx(f, L::kStageBytes + L::kStatBytes);
#pragma unroll
          for (int h = 0; h < D / 64; ++h) {
            hopper::tma_load_3d(slot + h * kRows * 128, map_a, f, 64 * h, kRows * i, n);
            hopper::tma_load_3d(slot + L::kStreamTile + h * kRows * 128, map_b, f, 64 * h,
                                kRows * i, n);
          }
          if constexpr (L::kStatBytes > 0) {
            const uint32_t st = base + L::kStats + stage * L::kStatBytes;
            hopper::tma_load_1d(st, map_lse, f, n * sq + kRows * i);
            hopper::tma_load_1d(st + kRows * 4, map_c, f, n * sq + kRows * i);
          }
        }
      }
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// Launch a kernel of layout L (L::kThreads threads, L::kBytes of dynamic
// shared memory): refused, as hopper::kRegsRefused + its registers a
// thread, unless it was compiled to the whole register file that its
// setmaxnreg hand-off needs (read once a kernel, before its first launch).
template <auto kKernel, class L, class P>
int launch_ring(dim3 grid, const P& p, cudaStream_t s) {
  const int refused = hopper::check_regs<kKernel>(L::kWholeFileRegs);
  if (refused != 0) return refused;
  cudaError_t err =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kKernel<<<grid, L::kThreads, L::kBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Consumer cycle counts (FLASH_RING_CLOCKS): thread 0 of each consumer
// warpgroup sums, into ring_clocks (read and reset by the library's
// *_clocks entry point), the cycles it spends in each phase; each kernel
// names its phases. [4] counts its computed tiles, [5] is its whole life
// (from taking its registers to its last store), [6] counts warpgroups.
constexpr int kClocks = 12;
#ifdef FLASH_RING_CLOCKS
__device__ unsigned long long ring_clocks[kClocks];
#define CLK_DECL                     \
  long long clk[kClocks] = {};       \
  long long t_gap = 0;               \
  const long long t_life = clock64()
#define CLK_MARK() t_gap = clock64()
#define CLK_GAP(i, v) \
  if (t_gap != 0) clk[i] += (v) - t_gap
#define CLK(v) const long long v = clock64()
#define CLK_ADD(i, v) clk[i] += clock64() - (v)
#define CLK_TILE() ++clk[4]
#define CLK_FLUSH()                                                         \
  clk[5] = clock64() - t_life;                                             \
  clk[6] = 1;                                                              \
  if ((threadIdx.x & 127) == 0)                                            \
    for (int i = 0; i < kClocks; ++i)                                      \
      atomicAdd(&flash::ring_clocks[i], static_cast<unsigned long long>(clk[i]))
#define CLOCKS_ENTRY(fn)                                                                    \
  extern "C" int fn(unsigned long long* out) {                                              \
    cudaError_t err = cudaMemcpyFromSymbol(out, flash::ring_clocks, sizeof(flash::ring_clocks)); \
    if (err != cudaSuccess) return static_cast<int>(err);                                   \
    const unsigned long long zeros[flash::kClocks] = {};                                    \
    return static_cast<int>(cudaMemcpyToSymbol(flash::ring_clocks, zeros, sizeof(zeros)));  \
  }
#else
#define CLK_DECL
#define CLK_MARK()
#define CLK_GAP(i, v)
#define CLK(v)
#define CLK_ADD(i, v)
#define CLK_TILE()
#define CLK_FLUSH()
#define CLOCKS_ENTRY(fn)
#endif

}  // namespace flash
