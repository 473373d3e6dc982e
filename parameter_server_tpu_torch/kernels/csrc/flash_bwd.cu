// flash_bwd: the FlashAttention-2 backward over head-major [BH, S, D]
// tensors, as two kernels.
//
// Replaces the Pallas kernels parameter_server_tpu/ops/flash_attention.py::
// _bwd_pallas: flash_bwd_dq for _bwd_dq_kernel, flash_bwd_dkv for
// _bwd_dkv_kernel. Plain version: ops/flash_attention.py::
// flash_attention_bwd_ref. Inputs: q [BH, Sq, D], k and v [BH / group, Sk,
// D], the output gradient do [BH, Sq, D] (all one dtype), the forward's lse
// [BH, Sq] and c = rowsum(do * out) - dlse [BH, Sq] (both float32, made by
// the wrapper). P is recomputed from lse, dP = dO.V^T, dS = P (dP - c)
// scale; dQ = dS.K, dV = P^T.dO, dK = dS^T.Q, written in the input dtype.
// Query row bh reads K/V row bh / group, and dK/dV of a K/V row sum the
// gradients of its `group` query heads (grouped-query attention).
//
// Precision, as the TPU kernels': products of input-dtype operands summed
// in f32, softmax statistics in f32, P cast to do's dtype before P^T.dO,
// dS cast to k's (q's) dtype before dS.K (dS^T.Q). Not bit-equal to the
// plain version (other summation order), so built without --fmad=false.
//
// No atomics: flash_bwd_dq owns a tile of query rows and loops over the
// live key tiles; flash_bwd_dkv owns a tile of keys and loops over the
// group's query heads and their live query tiles. Each output element is
// summed by one thread in a fixed order, so the gradients are bit-identical
// from run to run. Like the JAX split, both kernels recompute S and dP:
// seven products over the live pairs where the gradients need five.
// Whole 64 x 64 tiles outside the causal or window band are skipped
// (_block_live), so sliding-window training stays O(window) a query.
//
// Bound on the card: operations. At the LM training shape (BH 32, S 8192,
// D 64, bf16, causal) the gradients need 10 D FLOP over each of the 1.074e9
// (query, key) pairs the mask keeps, 6.87e11 FLOP, 0.695 ms at the 989
// TFLOP/s bf16 tensor-core rate; their ~270 MB of inputs and outputs take
// ~0.08 ms at 3.35 TB/s.
//
// What the bf16 design does about it (Hopper, sm_90a; helpers in
// hopper.cuh). A block is three warpgroups. Warpgroup 0 gives up its
// registers (setmaxnreg) and one of its warps produces: it loads the
// block's own 128 rows once (dq: Q and dO; dkv: K and V) and streams the
// other side's 64-row tiles (dq: K and V; dkv: Q, dO and their lse and c)
// through TMA into a ring of 4 (D 64) or 3 (D 128) stages with full/empty
// mbarriers, so the next tiles load while this one is computed.
// Warpgroups 1 and 2 consume, 64 own rows each, with wgmma: S and dP (dkv:
// S^T = K.Q^T, dP^T = V.dO^T) read both operands from shared memory
// K-major, as two groups, so that P is computed while dP's products run;
// P and dS (P^T, dS^T) are rounded to bf16 in registers and are the A
// operands of dQ += dS.K (dV += P^T.dO, dK += dS^T.Q), whose B tile is read
// MN-major: no operand is transposed or gathered by hand. Each warp
// releases a slot with one arrive. The tile loop is lean, because on an
// H100 (700 W) a few dozen scalar instructions between the products cost
// hundreds of cycles a tile (benchmarks/flash_bwd_ab.py --variant
// FLASH_BWD_CLOCKS measures the phases; PERF.md has the numbers): each
// warpgroup computes once the run of tiles live for it and
// the run it can take without the per-element mask (tile_live and the
// mask are monotone along a row of tiles), the wgmma descriptors of slot 0
// once, and the loop only adds offsets; the mask (key tail, query tail,
// causal diagonal, window edge) is a branch-free select on the tiles
// that cross one; P = 2^(S scale log2(e) - lse log2(e)) on the MUFU unit.
// The grid starts the longest blocks first (dq: the last query tiles; dkv:
// the first key tiles). What bounds it now: the softmax gradient between
// a warpgroup's products (MUFU and FP32 work, overlapped only across the
// two warpgroups). Not yet: overlapping one tile's softmax with the next
// tile's products inside a warpgroup (two sets of score registers fit only
// dq at D 64), a persistent grid, or one kernel that shares S and dP
// between the two gradients (it needs dQ summed across blocks). At D 128,
// flash_bwd_dkv spills (its dK and dV take 128 registers a thread).
//
// f32 inputs take two kernels on the CUDA cores (scalar FMA; the tensor
// cores would round the operands to TF32): 4 threads a row, each scoring
// 16 of a tile's 64 columns and owning D/4 gradient columns.
//
// Built with -DFLASH_BWD_RACE_PROBE (a diagnostic build, never the one the
// port runs), shared tiles are NaN before each load (a ring slot after its
// consumers release it, before the producer refills it) and each thread
// sleeps a seeded pseudo-random while before every mbarrier arrive and
// wait and at every hand-over through shared memory (flash_common.cuh);
// the gradients must stay bit-identical to the normal build's
// (tests/test_torch_kernels_cuda.py).
#ifdef FLASH_BWD_RACE_PROBE
#define FLASH_RACE_PROBE
#endif
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* c;
  void* dq;
  void* dk;
  void* dv;
  int sq, sk, group, q_off, k_off, causal, window;  // window 0: none
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: wgmma, a TMA ring of tiles, a producer warp
// ---------------------------------------------------------------------------

constexpr int kOwn = 128;      // rows a block owns: two consumer warpgroups of 64
constexpr int kStream = 64;    // rows of a streamed tile
constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumerWarps = 8;  // each releases a ring slot once
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-byte-aligned base: the two own tiles,
// the ring's tile pairs, the ring's lse and c (dkv), the barriers.
template <int D>
struct Layout {
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kOwnTile = kOwn * D * 2;
  static constexpr int kStreamTile = kStream * D * 2;
  static constexpr int kOwnA = 0, kOwnB = kOwnTile;
  static constexpr int kRing = 2 * kOwnTile;                        // stage s: tile A, tile B
  static constexpr int kStats = kRing + kStages * 2 * kStreamTile;  // stage s: lse[64], c[64]
  static constexpr int kStatBytes = 2 * kStream * 4;
  static constexpr int kBars = kStats + kStages * kStatBytes;       // full[s], empty[s], own
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
};

struct TmaArgs {
  Args a;
  CUtensorMap own_a, own_b;  // the block's own tiles (dq: Q, dO; dkv: K, V), 128-row boxes
  CUtensorMap str_a, str_b;  // the streamed tiles (dq: K, V; dkv: Q, dO), 64-row boxes
  CUtensorMap lse, c;        // dkv: lse and c as flat float32 vectors, 64-element boxes
};

#ifdef FLASH_BWD_RACE_PROBE
// a seeded per-thread sleep, then the warp back in step for the
// warp-synchronous instructions that follow
#define BWD_SKEW(site, i) \
  do {                      \
    flash::probe_skew(site, i); \
    __syncwarp();           \
  } while (0)
// NaN over `bytes` of shared memory, 16 bytes a thread from `lane` of
// `lanes`, ordered before the TMA writes that follow
__device__ __forceinline__ void bwd_poison(unsigned char* p, int bytes, int lane, int lanes,
                                           uint32_t word) {
  for (int i = lane * 16; i < bytes; i += lanes * 16)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(word, word, word, word);
  hopper::fence_proxy_async();
}
#define BWD_POISON(p, bytes, lane, lanes, word) bwd_poison(p, bytes, lane, lanes, word)
#else
#define BWD_SKEW(site, i)
#define BWD_POISON(p, bytes, lane, lanes, word)
#endif
constexpr uint32_t kNanBf16x2 = 0x7fc07fc0u, kNanF32 = 0x7fc00000u;

// Timing diagnostics (builds whose gradients are wrong, for
// benchmarks/flash_bwd_ab.py --variant): FLASH_BWD_NO_LOAD arrives on the
// ring's barriers without loading (the consumers compute on stale tiles),
// FLASH_BWD_NO_MATH has the consumers wait and release without computing.
#ifdef FLASH_BWD_NO_LOAD
constexpr bool kNoLoad = true;
#else
constexpr bool kNoLoad = false;
#endif
#ifdef FLASH_BWD_NO_MATH
constexpr bool kMath = false;
#else
constexpr bool kMath = true;
#endif
// FLASH_BWD_CLOCKS: thread 0 of each consumer warpgroup sums, into
// bwd_clocks (read and reset by flash_bwd_clocks), the cycles it spends
// [0] waiting for tiles, [1] in S and dP, [2] in the softmax gradient, [3]
// in the gradient products, [5] in its whole life (from taking its
// registers to its last store), [7] releasing slots, [8] waiting for the
// own tiles, [9] from a release to the next wait and [10] from a wait to
// the products; [4] counts its computed tiles and [6] the warpgroups.
#ifdef FLASH_BWD_CLOCKS
constexpr int kClocks = 11;
__device__ unsigned long long bwd_clocks[kClocks];
#define BWD_CLK_DECL                 \
  long long clk[kClocks] = {};       \
  long long t_gap = 0;               \
  const long long t_life = clock64()
#define BWD_CLK_MARK() t_gap = clock64()
#define BWD_CLK_GAP(i, v) \
  if (t_gap != 0) clk[i] += (v) - t_gap
#define BWD_CLK(v) const long long v = clock64()
#define BWD_CLK_ADD(i, v) clk[i] += clock64() - (v)
#define BWD_CLK_TILE() ++clk[4]
#define BWD_CLK_FLUSH()                                                                 \
  clk[5] = clock64() - t_life;                                                         \
  clk[6] = 1;                                                                          \
  if ((threadIdx.x & 127) == 0)                                                        \
    for (int i = 0; i < kClocks; ++i) atomicAdd(&bwd_clocks[i], static_cast<unsigned long long>(clk[i]))
#else
#define BWD_CLK_DECL
#define BWD_CLK_MARK()
#define BWD_CLK_GAP(i, v)
#define BWD_CLK(v)
#define BWD_CLK_ADD(i, v)
#define BWD_CLK_TILE()
#define BWD_CLK_FLUSH()
#endif

// The block's head and the rank of its own tile, rank 0 the tile with the
// most live tiles of the other side (causal: dq's last query tile, dkv's
// first key tile): ranks in order, heads fastest, so the longest blocks
// start first.
__device__ __forceinline__ void block_tile(int n_own, int& head, int& rank) {
  const int n_heads = gridDim.x / n_own;
  head = blockIdx.x % n_heads;
  rank = blockIdx.x / n_heads;
}

__device__ __forceinline__ int floor64(int x) { return x >= 0 ? x / 64 : -((63 - x) / 64); }

// Tile ranges [x, y] of a consumer warpgroup, computed once a block: along
// a row (or a column) of 64 x 64 tiles both tile_live and "no element
// masked" are monotone, so each holds on one run of tiles. dq: the key
// tiles live for query rows w..w+63 (none if w >= Sq), and those where no
// element needs the mask (no query row past Sq, no key past Sk, not
// crossing the causal diagonal or the window's edge)...
__device__ __forceinline__ int2 dq_live_tiles(const Args& a, int w, int n_tiles) {
  if (w >= a.sq) return make_int2(0, -1);
  if (!a.causal) return make_int2(0, n_tiles - 1);
  int2 r = make_int2(0, min(n_tiles - 1, floor64(a.q_off + w + kStream - 1 - a.k_off)));
  if (a.window > 0) r.x = max(0, floor64(a.q_off + w - a.k_off - kStream + 1 - a.window) + 1);
  return r;
}

__device__ __forceinline__ int2 dq_full_tiles(const Args& a, int w) {
  if (w + kStream > a.sq) return make_int2(0, -1);
  int2 r = make_int2(0, floor64(a.sk - kStream));
  if (a.causal) {
    r.y = min(r.y, floor64(a.q_off + w - a.k_off - kStream + 1));
    if (a.window > 0) r.x = max(r.x, floor64(a.q_off + w + kStream - 1 - a.k_off - a.window) + 1);
  }
  return r;
}

// ...dkv: the query tiles live for keys w..w+63 (none if w >= Sk), and
// those with no element masked
__device__ __forceinline__ int2 dkv_live_tiles(const Args& a, int w, int n_tiles) {
  if (w >= a.sk) return make_int2(0, -1);
  if (!a.causal) return make_int2(0, n_tiles - 1);
  int2 r = make_int2(max(0, floor64(a.k_off + w - a.q_off)), n_tiles - 1);
  if (a.window > 0) r.y = min(r.y, floor64(a.window + a.k_off + w + kStream - 2 - a.q_off));
  return r;
}

__device__ __forceinline__ int2 dkv_full_tiles(const Args& a, int w) {
  if (w + kStream > a.sk) return make_int2(0, -1);
  int2 r = make_int2(0, floor64(a.sq - kStream));
  if (a.causal) {
    r.x = max(r.x, floor64(a.k_off + w + 2 * kStream - 2 - a.q_off));
    if (a.window > 0) r.y = min(r.y, floor64(a.window + a.k_off + w - kStream - a.q_off));
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
// a row past Sq)...
__device__ __forceinline__ int2 keys_kept(const Args& a, int q) {
  if (q >= a.sq) return make_int2(0, -1);
  int2 r = make_int2(0, a.sk - 1);
  if (a.causal) {
    const int q_pos = a.q_off + q;
    r.y = min(r.y, q_pos - a.k_off);
    if (a.window > 0) r.x = max(r.x, q_pos - a.window + 1 - a.k_off);
  }
  return r;
}

// ...and the query indices key kp is kept by
__device__ __forceinline__ int2 queries_kept(const Args& a, int kp) {
  if (kp >= a.sk) return make_int2(0, -1);
  int2 r = make_int2(0, a.sq - 1);
  if (a.causal) {
    const int k_pos = a.k_off + kp;
    r.x = max(r.x, k_pos - a.q_off);
    if (a.window > 0) r.y = min(r.y, k_pos + a.window - 1 - a.q_off);
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

// P = 2^(S scale log2e - lse log2e) over a thread's fragment of a 64 x 64
// tile, in place, zero where not kept (columns col0 + 8j + e % 2). lse2:
// the log2e lse of each element's row (dq: 2 rows a thread) or column
// (dkv: lse2[j][e % 2]).
template <bool kMasked, class Lse>
__device__ __forceinline__ void softmax(float (&s)[32], const int2 (&range)[2], int col0,
                                        float scale_log2, Lse lse2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = exp2_approx(fmaf(s[4 * j + e], scale_log2, -lse2(j, e)));
      s[4 * j + e] = kept<kMasked>(range, col0, j, e) ? pv : 0.f;
    }
  }
}

// dS = P (dP - c) scale, as P (dP scale - c scale): in place of dp. cs2:
// c scale of each element's row or column, as lse2 above. (With D 64 the
// scale is 1/8, a power of two: the same bits as the left-hand form.)
template <class C>
__device__ __forceinline__ void softmax_grad(float (&dp)[32], const float (&p)[32], float scale,
                                             C cs2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      dp[i] = p[i] * fmaf(dp[i], scale, -cs2(j, e));
    }
  }
}

// the A fragments of the four 16-column slices of a 64 x 64 accumulator
__device__ __forceinline__ void pack_a(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_f32(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

// acc[64 x D] += A[64 x 64].B, A in registers, B a streamed tile MN-major
// (db: its descriptor at k-step 0)
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2], const uint32_t (&f)[4][4],
                                           uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d = hopper::desc_advance(db, kk * 16 * 128);
    if constexpr (D == 64) {
      hopper::wgmma_rs_n64(acc, f[kk], d, 1);
    } else {
      hopper::wgmma_rs_n128(acc, f[kk], d, 1);
    }
  }
}

// s[64 x 64] = A.B^T, A 64 rows of an own tile, B a streamed tile, both
// K-major over the D columns (da, db: their descriptors at k-step 0)
template <int D>
__device__ __forceinline__ void product_ss(float (&s)[32], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = (kk & 3) * 32;  // bytes into a 128-byte row of a 64-column half
    hopper::wgmma_ss_n64(s, hopper::desc_advance(da, (kk >> 2) * kOwn * 128 + col),
                         hopper::desc_advance(db, (kk >> 2) * kStream * 128 + col), kk);
  }
}

// Barrier set-up, and (probe) the own tiles poisoned; every thread.
template <int D>
__device__ __forceinline__ void block_setup(unsigned char* smem, uint32_t full, uint32_t empty,
                                            uint32_t own) {
  using L = Layout<D>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    hopper::mbar_init(own, 1);
    hopper::fence_barrier_init();
  }
  BWD_POISON(smem + L::kOwnA, 2 * L::kOwnTile, threadIdx.x, kThreads, kNanBf16x2);
  __syncthreads();
}

// The producer's load of the block's own tiles (lane 0 of warp 0), rows r0..
// of matrix n of both maps.
template <int D>
__device__ __forceinline__ void load_own(const TmaArgs& p, uint32_t base, uint32_t own, int r0,
                                         int n) {
  using L = Layout<D>;
  if (kNoLoad) return hopper::mbar_arrive(own);
  hopper::mbar_expect_tx(own, 2 * L::kOwnTile);
#pragma unroll
  for (int h = 0; h < D / 64; ++h) {
    hopper::tma_load_3d(base + L::kOwnA + h * kOwn * 128, &p.own_a, own, 64 * h, r0, n);
    hopper::tma_load_3d(base + L::kOwnB + h * kOwn * 128, &p.own_b, own, 64 * h, r0, n);
  }
}

// The producer's loop (warp 0 of warpgroup 0): for each tile of `tiles`
// (of each of the `heads` matrices from n0 on), wait for its ring slot to
// be released, (probe) poison it, and load rows 64 i.. of both streamed
// maps into it; with `stats` (dkv), also the 64 lse and c from flat index
// 64 i + n Sq.
template <int D>
__device__ __forceinline__ void produce(const TmaArgs& p, unsigned char* smem, uint32_t base,
                                        uint32_t full, uint32_t empty, int2 tiles, int n0, int heads,
                                        bool stats) {
  using L = Layout<D>;
  const int lane = threadIdx.x;
  int stage = 0;
  uint32_t phase = 0;
  for (int n = n0; n < n0 + heads; ++n) {
    for (int i = tiles.x; i <= tiles.y; ++i) {
      BWD_SKEW(4, i);
      hopper::mbar_wait(empty + 8 * stage, phase ^ 1);
      BWD_POISON(smem + L::kRing + stage * 2 * L::kStreamTile, 2 * L::kStreamTile, lane, 32,
                 kNanBf16x2);
      BWD_POISON(smem + L::kStats + stage * L::kStatBytes, L::kStatBytes, lane, 32, kNanF32);
      __syncwarp();
      BWD_SKEW(5, i);
      if (lane == 0) {
        const uint32_t f = full + 8 * stage;
        if (kNoLoad) {
          hopper::mbar_arrive(f);
        } else {
          const uint32_t slot = base + L::kRing + stage * 2 * L::kStreamTile;
          hopper::mbar_expect_tx(f, 2 * L::kStreamTile + (stats ? L::kStatBytes : 0));
#pragma unroll
          for (int h = 0; h < D / 64; ++h) {
            hopper::tma_load_3d(slot + h * kStream * 128, &p.str_a, f, 64 * h, kStream * i, n);
            hopper::tma_load_3d(slot + L::kStreamTile + h * kStream * 128, &p.str_b, f, 64 * h,
                                kStream * i, n);
          }
          if (stats) {
            const uint32_t st = base + L::kStats + stage * L::kStatBytes;
            hopper::tma_load_1d(st, &p.lse, f, n * p.a.sq + kStream * i);
            hopper::tma_load_1d(st + kStream * 4, &p.c, f, n * p.a.sq + kStream * i);
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

// One block: query rows q0..q0+127 of query row bh (warpgroup 1 the first
// 64, warpgroup 2 the next); per live key tile, K and V through the ring.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_bf16(const __grid_constant__ TmaArgs p) {
  using L = Layout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const Args& a = p.a;
  const uint32_t full = base + L::kBars, empty = full + 8 * L::kStages, own = empty + 8 * L::kStages;
  const int n_own = (a.sq + kOwn - 1) / kOwn, n_tiles = (a.sk + kStream - 1) / kStream;
  int bh, rank;
  block_tile(n_own, bh, rank);
  const int q0 = (n_own - 1 - rank) * kOwn;
  const int2 tiles = either(dq_live_tiles(a, q0, n_tiles), dq_live_tiles(a, q0 + 64, n_tiles));
  const int wg = threadIdx.x >> 7;
  block_setup<D>(smem, full, empty, own);

  if (wg == 0) {  // producer
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      BWD_SKEW(3, -1);
      if (threadIdx.x == 0) load_own<D>(p, base, own, q0, bh);
      produce<D>(p, smem, base, full, empty, tiles, bh / a.group, 1, false);
    }
    return;
  }

  // consumers
  hopper::regs_inc<kConsumerRegs>();
  BWD_CLK_DECL;
  const int cw = wg - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int w0 = q0 + 64 * cw;                     // the warpgroup's first query row
  const int r0 = w0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const int2 live = dq_live_tiles(a, w0, n_tiles), unmasked = dq_full_tiles(a, w0);
  const size_t q_row = static_cast<size_t>(bh) * a.sq;
  const float scale = a.scale, scale_log2 = scale * kLog2e;
  // the log2e lse and the scaled c of the two rows
  const float lse2[2] = {r0 < a.sq ? a.lse[q_row + r0] * kLog2e : 0.f,
                         r1 < a.sq ? a.lse[q_row + r1] * kLog2e : 0.f};
  const float cs2[2] = {r0 < a.sq ? a.c[q_row + r0] * scale : 0.f,
                        r1 < a.sq ? a.c[q_row + r1] * scale : 0.f};
  const auto row_lse = [&](int, int e) { return lse2[e >> 1]; };
  const auto row_c = [&](int, int e) { return cs2[e >> 1]; };
  const int2 range[2] = {keys_kept(a, r0), keys_kept(a, r1)};
  // descriptors: the warpgroup's rows of Q and dO; K (and V) of ring slot
  // 0, K-major and MN-major
  const uint64_t d_q = hopper::desc_k(base + L::kOwnA, kOwn, 64 * cw, 0);
  const uint64_t d_do = hopper::desc_k(base + L::kOwnB, kOwn, 64 * cw, 0);
  const uint64_t d_k = hopper::desc_k(base + L::kRing, kStream, 0, 0);
  const uint64_t d_k_mn = hopper::desc_mn(base + L::kRing, kStream, 0);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  hopper::mbar_wait(own, 0);
  BWD_CLK_ADD(8, t_life);
  BWD_SKEW(0, -1);

  int stage = 0;
  uint32_t phase = 0;
  for (int kt = tiles.x; kt <= tiles.y; ++kt) {
    BWD_SKEW(1, kt);
    BWD_CLK(t0_clk);
    BWD_CLK_GAP(9, t0_clk);
    hopper::mbar_wait(full + 8 * stage, phase);
    BWD_CLK_ADD(0, t0_clk);
    BWD_CLK_MARK();
    if (kMath && in(kt, live)) {
      BWD_CLK(t1_clk);
      BWD_CLK_GAP(10, t1_clk);
      const uint32_t slot = stage * 2 * L::kStreamTile;
      // S = Q.K^T and dP = dO.V^T, 64 rows x 64 keys each, as two groups
      // (the first k-step overwrites: no value goes in); P while dP runs
      float s[32], dp[32];
      hopper::wgmma_fence();
      product_ss<D>(s, d_q, hopper::desc_advance(d_k, slot));
      hopper::wgmma_commit();
      product_ss<D>(dp, d_do, hopper::desc_advance(d_k, slot + L::kStreamTile));
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
      BWD_CLK_ADD(1, t1_clk);
      BWD_CLK(t2_clk);
      if (in(kt, unmasked)) {
        softmax<false>(s, range, kStream * kt + 2 * t, scale_log2, row_lse);
      } else {
        softmax<true>(s, range, kStream * kt + 2 * t, scale_log2, row_lse);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      softmax_grad(dp, s, scale, row_c);
      // dQ += dS.K, dS in bf16 as the A operand, K's tile MN-major
      uint32_t ds[4][4];
      pack_a(ds, dp);
      BWD_CLK_ADD(2, t2_clk);
      BWD_CLK(t3_clk);
      hopper::wgmma_fence();
      product_rs<D>(acc, ds, hopper::desc_advance(d_k_mn, slot));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      BWD_CLK_ADD(3, t3_clk);
      BWD_CLK_TILE();
    }
    BWD_CLK(t4_clk);
    BWD_SKEW(2, kt);
    __syncwarp();  // the warp's reads of the slot are done
    if (lane == 0) hopper::mbar_arrive(empty + 8 * stage);
    BWD_CLK_ADD(7, t4_clk);
    BWD_CLK_MARK();
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  auto* dq = static_cast<__nv_bfloat16*>(a.dq) + q_row * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < a.sq) *reinterpret_cast<uint32_t*>(dq + static_cast<size_t>(r0) * D + col) = pack_f32(acc[4 * j], acc[4 * j + 1]);
    if (r1 < a.sq) *reinterpret_cast<uint32_t*>(dq + static_cast<size_t>(r1) * D + col) = pack_f32(acc[4 * j + 2], acc[4 * j + 3]);
  }
  BWD_CLK_FLUSH();
}

// One block: keys k0..k0+127 of K/V row kvh (warpgroup 1 the first 64,
// warpgroup 2 the next); per query head of the group and live query tile,
// Q, dO, lse and c through the ring. The products run transposed (keys as
// rows): S^T = K.Q^T, dP^T = V.dO^T; lse and c are per column.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_bf16(const __grid_constant__ TmaArgs p) {
  using L = Layout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const Args& a = p.a;
  const uint32_t full = base + L::kBars, empty = full + 8 * L::kStages, own = empty + 8 * L::kStages;
  const int n_tiles = (a.sq + kStream - 1) / kStream;
  int kvh, rank;
  block_tile((a.sk + kOwn - 1) / kOwn, kvh, rank);
  const int k0 = rank * kOwn;
  const int2 tiles = either(dkv_live_tiles(a, k0, n_tiles), dkv_live_tiles(a, k0 + 64, n_tiles));
  const int wg = threadIdx.x >> 7;
  block_setup<D>(smem, full, empty, own);

  if (wg == 0) {  // producer
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      BWD_SKEW(3, -1);
      if (threadIdx.x == 0) load_own<D>(p, base, own, k0, kvh);
      produce<D>(p, smem, base, full, empty, tiles, kvh * a.group, a.group, true);
    }
    return;
  }

  // consumers
  hopper::regs_inc<kConsumerRegs>();
  BWD_CLK_DECL;
  const int cw = wg - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int w0 = k0 + 64 * cw;                        // the warpgroup's first key
  const int kr0 = w0 + warp * 16 + g, kr1 = kr0 + 8;  // this thread's two keys
  const int2 live = dkv_live_tiles(a, w0, n_tiles), unmasked = dkv_full_tiles(a, w0);
  const int2 range[2] = {queries_kept(a, kr0), queries_kept(a, kr1)};
  const float scale = a.scale, scale_log2 = scale * kLog2e;
  // descriptors: the warpgroup's keys of K and V; Q (and dO) of ring slot
  // 0, K-major and MN-major
  const uint64_t d_k = hopper::desc_k(base + L::kOwnA, kOwn, 64 * cw, 0);
  const uint64_t d_v = hopper::desc_k(base + L::kOwnB, kOwn, 64 * cw, 0);
  const uint64_t d_q = hopper::desc_k(base + L::kRing, kStream, 0, 0);
  const uint64_t d_q_mn = hopper::desc_mn(base + L::kRing, kStream, 0);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  hopper::mbar_wait(own, 0);
  BWD_CLK_ADD(8, t_life);
  BWD_SKEW(0, -1);

  int stage = 0;
  uint32_t phase = 0;
  for (int hg = 0; hg < a.group; ++hg) {
    for (int qt = tiles.x; qt <= tiles.y; ++qt) {
      BWD_SKEW(1, qt);
      BWD_CLK(t0_clk);
      BWD_CLK_GAP(9, t0_clk);
      hopper::mbar_wait(full + 8 * stage, phase);
      BWD_CLK_ADD(0, t0_clk);
      BWD_CLK_MARK();
      if (kMath && in(qt, live)) {
        BWD_CLK(t1_clk);
        BWD_CLK_GAP(10, t1_clk);
        const uint32_t slot = stage * 2 * L::kStreamTile;
        // S^T = K.Q^T and dP^T = V.dO^T, 64 keys x 64 queries each, as two
        // groups; P^T while dP^T runs; then dV += P^T.dO and dK += dS^T.Q
        // (P^T and dS^T in bf16 as the A operands, dO's and Q's tiles
        // MN-major)
        float s[32], dp[32];
        hopper::wgmma_fence();
        product_ss<D>(s, d_k, hopper::desc_advance(d_q, slot));
        hopper::wgmma_commit();
        product_ss<D>(dp, d_v, hopper::desc_advance(d_q, slot + L::kStreamTile));
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
        BWD_CLK_ADD(1, t1_clk);
        BWD_CLK(t2_clk);
        // this thread's columns 8j + 2t, 8j + 2t + 1 of the tile's lse and c
        const auto* stats = reinterpret_cast<const float2*>(smem + L::kStats + stage * L::kStatBytes) + t;
        const auto col_lse = [&](int j, int e) {
          const float2 v = stats[4 * j];
          return ((e & 1) ? v.y : v.x) * kLog2e;
        };
        const auto col_c = [&](int j, int e) {
          const float2 v = stats[kStream / 2 + 4 * j];
          return ((e & 1) ? v.y : v.x) * scale;
        };
        if (in(qt, unmasked)) {
          softmax<false>(s, range, kStream * qt + 2 * t, scale_log2, col_lse);
        } else {
          softmax<true>(s, range, kStream * qt + 2 * t, scale_log2, col_lse);
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
        softmax_grad(dp, s, scale, col_c);
        uint32_t pa[4][4], sa[4][4];
        pack_a(pa, s);
        pack_a(sa, dp);
        BWD_CLK_ADD(2, t2_clk);
        BWD_CLK(t3_clk);
        hopper::wgmma_fence();
        product_rs<D>(dv, pa, hopper::desc_advance(d_q_mn, slot + L::kStreamTile));
        product_rs<D>(dk, sa, hopper::desc_advance(d_q_mn, slot));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
        BWD_CLK_ADD(3, t3_clk);
        BWD_CLK_TILE();
      }
      BWD_CLK(t4_clk);
      BWD_SKEW(2, qt);
      __syncwarp();  // the warp's reads of the slot are done
      if (lane == 0) hopper::mbar_arrive(empty + 8 * stage);
      BWD_CLK_ADD(7, t4_clk);
      BWD_CLK_MARK();
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  const size_t kv_row = static_cast<size_t>(kvh) * a.sk * D;
  auto* dkp = static_cast<__nv_bfloat16*>(a.dk) + kv_row;
  auto* dvp = static_cast<__nv_bfloat16*>(a.dv) + kv_row;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (kr0 < a.sk) {
      *reinterpret_cast<uint32_t*>(dkp + static_cast<size_t>(kr0) * D + col) = pack_f32(dk[4 * j], dk[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dvp + static_cast<size_t>(kr0) * D + col) = pack_f32(dv[4 * j], dv[4 * j + 1]);
    }
    if (kr1 < a.sk) {
      *reinterpret_cast<uint32_t*>(dkp + static_cast<size_t>(kr1) * D + col) = pack_f32(dk[4 * j + 2], dk[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dvp + static_cast<size_t>(kr1) * D + col) = pack_f32(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
  BWD_CLK_FLUSH();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, 4 threads a row
// ---------------------------------------------------------------------------

template <int D>
constexpr int f32_smem_bytes() {
  return (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile) * 4;
}

// One block: 64 query rows. Thread c of row r scores keys c, c+4, ... of
// each tile and owns dQ columns c, c+4, ...
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dq_f32(Args a) {
  extern __shared__ float fsmem[];
  constexpr int kS = D + 1, kP = kTile + 1;  // padded row strides
  constexpr int kCols = D / 4;
  float* qs = fsmem;             // [64][D+1]
  float* dos = qs + kTile * kS;  // [64][D+1]
  float* ks = dos + kTile * kS;  // [64][D+1]
  float* vs = ks + kTile * kS;   // [64][D+1]
  float* dss = vs + kTile * kS;  // [64][65]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const size_t q_row = static_cast<size_t>(bh) * a.sq;
  const size_t kv_row = static_cast<size_t>(bh / a.group) * a.sk * D;
  const float* k = static_cast<const float*>(a.k) + kv_row;
  const float* v = static_cast<const float*>(a.v) + kv_row;
  const bool in = q0 + r < a.sq;
  const int qp = a.q_off + q0 + r;
  const float lse = in ? a.lse[q_row + q0 + r] : 0.f, cr = in ? a.c[q_row + q0 + r] : 0.f;

  PROBE_POISON(qs, 2 * kTile * kS);
  stage2_f32<D>(qs, kS, dos, kS, static_cast<const float*>(a.q) + q_row * D,
                static_cast<const float*>(a.dout) + q_row * D, q0, a.sq);
  PROBE_SKEW(0, -1);
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  const int n_tiles = (a.sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_live(a, q0, k0)) continue;
    __syncthreads();
    PROBE_POISON(ks, 2 * kTile * kS);
    PROBE_POISON(dss, kTile * kP);
    PROBE_SKEW(1, kt);
    stage2_f32<D>(ks, kS, vs, kS, k, v, k0, a.sk);
    __syncthreads();
    PROBE_SKEW(2, kt);

    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * kS + d], dv = dos[r * kS + d];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s[i] = fmaf(qv, ks[(c + 4 * i) * kS + d], s[i]);
        dp[i] = fmaf(dv, vs[(c + 4 * i) * kS + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p = in && key_valid(a, qp, k0 + c + 4 * i) ? expf(s[i] * a.scale - lse) : 0.f;
      dss[r * kP + c + 4 * i] = p * (dp[i] - cr) * a.scale;
    }
    __syncwarp();  // a row's 4 threads share one warp
    PROBE_SKEW(3, kt);
    for (int j = 0; j < kTile; ++j) {
      const float ds = dss[r * kP + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(ds, ks[j * kS + c + 4 * i], acc[i]);
    }
  }
  if (in) {
    float* dq = static_cast<float*>(a.dq) + (q_row + q0 + r) * D;
#pragma unroll
    for (int i = 0; i < kCols; ++i) dq[c + 4 * i] = acc[i];
  }
}

// One block: 64 keys. Thread c of key row r scores queries c, c+4, ... of
// each query tile and owns dK and dV columns c, c+4, ...
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dkv_f32(Args a) {
  extern __shared__ float fsmem[];
  constexpr int kS = D + 1, kP = kTile + 1;
  constexpr int kCols = D / 4;
  float* ks = fsmem;             // [64][D+1]
  float* vs = ks + kTile * kS;   // [64][D+1]
  float* qs = vs + kTile * kS;   // [64][D+1]
  float* dos = qs + kTile * kS;  // [64][D+1]
  float* ps = dos + kTile * kS;  // [64][65]
  float* dss = ps + kTile * kP;  // [64][65]
  float* lse_s = dss + kTile * kP;
  float* c_s = lse_s + kTile;

  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const size_t kv_row = static_cast<size_t>(kvh) * a.sk * D;
  const int kr = k0 + r;

  PROBE_POISON(ks, 2 * kTile * kS);
  stage2_f32<D>(ks, kS, vs, kS, static_cast<const float*>(a.k) + kv_row,
                static_cast<const float*>(a.v) + kv_row, k0, a.sk);
  PROBE_SKEW(0, -1);
  float dk[kCols], dv[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) dk[i] = dv[i] = 0.f;

  const int n_tiles = (a.sq + kTile - 1) / kTile;
  for (int hg = 0; hg < a.group; ++hg) {
    const size_t q_row = (static_cast<size_t>(kvh) * a.group + hg) * a.sq;
    const float* q = static_cast<const float*>(a.q) + q_row * D;
    const float* dout = static_cast<const float*>(a.dout) + q_row * D;
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_live(a, q0, k0)) continue;
      __syncthreads();
      PROBE_POISON(qs, 2 * kTile * kS);
      PROBE_POISON(ps, 2 * kTile * kP + 2 * kTile);
      PROBE_SKEW(1, qt);
      stage2_f32<D>(qs, kS, dos, kS, q, dout, q0, a.sq);
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const bool in = q0 + i < a.sq;
        lse_s[i] = in ? a.lse[q_row + q0 + i] : 0.f;
        c_s[i] = in ? a.c[q_row + q0 + i] : 0.f;
      }
      __syncthreads();
      PROBE_SKEW(2, qt);

      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = ks[r * kS + d], vv = vs[r * kS + d];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          s[i] = fmaf(kv, qs[(c + 4 * i) * kS + d], s[i]);
          dp[i] = fmaf(vv, dos[(c + 4 * i) * kS + d], dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int qi = c + 4 * i;
        const bool valid = q0 + qi < a.sq && key_valid(a, a.q_off + q0 + qi, kr);
        const float p = valid ? expf(s[i] * a.scale - lse_s[qi]) : 0.f;
        ps[r * kP + qi] = p;
        dss[r * kP + qi] = p * (dp[i] - c_s[qi]) * a.scale;
      }
      __syncwarp();
      PROBE_SKEW(3, qt);
      for (int j = 0; j < kTile; ++j) {
        const float p = ps[r * kP + j], ds = dss[r * kP + j];
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          dv[i] = fmaf(p, dos[j * kS + c + 4 * i], dv[i]);
          dk[i] = fmaf(ds, qs[j * kS + c + 4 * i], dk[i]);
        }
      }
    }
  }
  if (kr < a.sk) {
    float* dkp = static_cast<float*>(a.dk) + kv_row + static_cast<size_t>(kr) * D;
    float* dvp = static_cast<float*>(a.dv) + kv_row + static_cast<size_t>(kr) * D;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      dkp[c + 4 * i] = dk[i];
      dvp[c + 4 * i] = dv[i];
    }
  }
}



template <class K>
cudaError_t launch_one(K kernel, dim3 grid, int threads, int bytes, const Args& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <class K>
cudaError_t launch_tma(K kernel, dim3 grid, int bytes, const TmaArgs& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, int bh, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    TmaArgs p{};
    p.a = a;
    const int kvn = bh / a.group;
    if (!hopper::map_bf16_rows(&p.own_a, a.q, D, a.sq, bh, kOwn) ||
        !hopper::map_bf16_rows(&p.own_b, a.dout, D, a.sq, bh, kOwn) ||
        !hopper::map_bf16_rows(&p.str_a, a.k, D, a.sk, kvn, kStream) ||
        !hopper::map_bf16_rows(&p.str_b, a.v, D, a.sk, kvn, kStream))
      return cudaErrorInvalidValue;
    const dim3 grid(bh * ((a.sq + kOwn - 1) / kOwn));
    return launch_tma(flash_bwd_dq_bf16<D>, grid, Layout<D>::kBytes, p, s);
  }
  const dim3 grid((a.sq + kTile - 1) / kTile, bh);
  return launch_one(flash_bwd_dq_f32<D>, grid, 256, f32_smem_bytes<D>(), a, s);
}

template <int D>
cudaError_t launch_dkv(const Args& a, int bh, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    TmaArgs p{};
    p.a = a;
    const int kvn = bh / a.group;
    const long long stats = static_cast<long long>(bh) * a.sq;
    if (!hopper::map_bf16_rows(&p.own_a, a.k, D, a.sk, kvn, kOwn) ||
        !hopper::map_bf16_rows(&p.own_b, a.v, D, a.sk, kvn, kOwn) ||
        !hopper::map_bf16_rows(&p.str_a, a.q, D, a.sq, bh, kStream) ||
        !hopper::map_bf16_rows(&p.str_b, a.dout, D, a.sq, bh, kStream) ||
        !hopper::map_f32_flat(&p.lse, a.lse, stats, kStream) ||
        !hopper::map_f32_flat(&p.c, a.c, stats, kStream))
      return cudaErrorInvalidValue;
    const dim3 grid(kvn * ((a.sk + kOwn - 1) / kOwn));
    return launch_tma(flash_bwd_dkv_bf16<D>, grid, Layout<D>::kBytes, p, s);
  }
  const dim3 grid((a.sk + kTile - 1) / kTile, bh / a.group);
  return launch_one(flash_bwd_dkv_f32<D>, grid, 256, f32_smem_bytes<D>(), a, s);
}

bool bad_args(int bh, int d, int dtype, int group) {
  return (d != 64 && d != 128) || (dtype != 0 && dtype != 1) || group < 1 || bh % group != 0;
}

}  // namespace

#ifdef FLASH_BWD_CLOCKS
// the consumer cycle sums of the launches since the last call, then zeros
extern "C" int flash_bwd_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, bwd_clocks, sizeof(bwd_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zeros[kClocks] = {};
  return static_cast<int>(cudaMemcpyToSymbol(bwd_clocks, zeros, sizeof(zeros)));
}
#endif

#ifdef FLASH_BWD_RACE_PROBE
extern "C" int flash_bwd_probe_seed(unsigned seed) {
  return static_cast<int>(cudaMemcpyToSymbol(flash::probe_seed, &seed, sizeof(seed)));
}
#endif

// C entry points for ctypes. dtype: 0 float32, 1 bfloat16; d: 64 or 128;
// window 0: none; bh counts query rows (k and v hold bh / group rows).
// Each returns the CUDA error code of its launch (0 on success,
// cudaErrorInvalidValue for a shape or dtype it is not built for); the
// Python wrapper raises on anything else.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* c, void* dq, int bh, int sq,
                                   int sk, int d, int group, int q_off, int k_off, int causal,
                                   int window, float scale, int dtype, void* stream) {
  if (bad_args(bh, d, dtype, group)) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || sq <= 0) return 0;
  const Args a{q, k, v, dout, lse, c, dq, nullptr, nullptr, sq, sk, group, q_off, k_off, causal,
               window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 64 ? launch_dq<64>(a, bh, dtype, s) : launch_dq<128>(a, bh, dtype, s));
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const float* lse, const float* c, void* dk, void* dv, int bh,
                                    int sq, int sk, int d, int group, int q_off, int k_off,
                                    int causal, int window, float scale, int dtype, void* stream) {
  if (bad_args(bh, d, dtype, group)) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || sk <= 0) return 0;
  const Args a{q, k, v, dout, lse, c, nullptr, dk, dv, sq, sk, group, q_off, k_off, causal,
               window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 64 ? launch_dkv<64>(a, bh, dtype, s) : launch_dkv<128>(a, bh, dtype, s));
}
