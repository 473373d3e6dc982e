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
// What the bf16 design does about it (Hopper, sm_90a; the block, its ring
// and its producer are flash_common.cuh's, shared with flash_fwd, on
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
// hundreds of cycles a tile (benchmarks/flash_ab.py --kernel bwd --variant
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
#ifdef FLASH_BWD_NO_LOAD
#define FLASH_RING_NO_LOAD
#endif
#ifdef FLASH_BWD_CLOCKS
#define FLASH_RING_CLOCKS
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
// bf16: wgmma, a TMA ring of tiles, a producer warp (flash_common.cuh)
// ---------------------------------------------------------------------------

constexpr int kStream = 64;  // rows of a streamed tile

// Shared memory: the two own tiles, the ring's tile pairs, (dkv) the
// ring's lse and c, the barriers.
template <int D>
using DqLayout = Layout<D, 2, 2, kStream, 2, D == 64 ? 4 : 3, 0>;
template <int D>
using DkvLayout = Layout<D, 2, 2, kStream, 2, D == 64 ? 4 : 3, 2 * kStream * 4>;
constexpr int kOwn = DqLayout<64>::kOwnRows;  // 128 rows a block owns

struct TmaArgs {
  Args a;
  CUtensorMap own_a, own_b;  // the block's own tiles (dq: Q, dO; dkv: K, V), 128-row boxes
  CUtensorMap str_a, str_b;  // the streamed tiles (dq: K, V; dkv: Q, dO), 64-row boxes
  CUtensorMap lse, c;        // dkv: lse and c as flat float32 vectors, 64-element boxes
};

// Timing diagnostics (builds whose gradients are wrong, for
// benchmarks/flash_ab.py --variant): FLASH_BWD_NO_LOAD arrives on the
// ring's barriers without loading (the consumers compute on stale tiles),
// FLASH_BWD_NO_MATH has the consumers wait and release without computing.
#ifdef FLASH_BWD_NO_MATH
constexpr bool kMath = false;
#else
constexpr bool kMath = true;
#endif
// FLASH_BWD_CLOCKS: the consumer cycles (flash_common.cuh) [0] waiting for
// tiles, [1] in S and dP, [2] in the softmax gradient, [3] in the gradient
// products, [7] releasing slots, [8] waiting for the own tiles, [9] from a
// release to the next wait and [10] from a wait to the products.

// Tile ranges [x, y] of a consumer warpgroup of flash_bwd_dkv, computed
// once a block (dq's are key_tiles_live and key_tiles_full of
// flash_common.cuh): the query tiles live for keys w..w+63 (none if w >=
// Sk), and those with no element masked
__device__ __forceinline__ int2 dkv_live_tiles(const Args& a, int w, int n_tiles) {
  if (w >= a.sk) return make_int2(0, -1);
  if (!a.causal) return make_int2(0, n_tiles - 1);
  int2 r = make_int2(max(0, floor_div<64>(a.k_off + w - a.q_off)), n_tiles - 1);
  if (a.window > 0) r.y = min(r.y, floor_div<64>(a.window + a.k_off + w + kStream - 2 - a.q_off));
  return r;
}

__device__ __forceinline__ int2 dkv_full_tiles(const Args& a, int w) {
  if (w + kStream > a.sk) return make_int2(0, -1);
  int2 r = make_int2(0, floor_div<64>(a.sq - kStream));
  if (a.causal) {
    r.x = max(r.x, floor_div<64>(a.k_off + w + 2 * kStream - 2 - a.q_off));
    if (a.window > 0) r.y = min(r.y, floor_div<64>(a.window + a.k_off + w - kStream - a.q_off));
  }
  return r;
}

// The query indices key kp is kept by, as [x, y] (flash_common.cuh's
// keys_kept seen from the key)
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

// One block: query rows q0..q0+127 of query row bh (warpgroup 1 the first
// 64, warpgroup 2 the next); per live key tile, K and V through the ring.
template <int D>
__global__ void __launch_bounds__(DqLayout<D>::kThreads, 1) flash_bwd_dq_bf16(const __grid_constant__ TmaArgs p) {
  using L = DqLayout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = smem_base(smem_raw, smem);
  const Args& a = p.a;
  const uint32_t full = base + L::kBars, empty = full + 8 * L::kStages, own = empty + 8 * L::kStages;
  const int n_own = (a.sq + kOwn - 1) / kOwn, n_tiles = (a.sk + kStream - 1) / kStream;
  int bh, rank;
  block_tile(n_own, bh, rank);
  const int q0 = (n_own - 1 - rank) * kOwn;
  const int2 tiles = either(key_tiles_live<kStream>(a, q0, n_tiles), key_tiles_live<kStream>(a, q0 + 64, n_tiles));
  const int wg = threadIdx.x >> 7;
  block_setup<L>(smem, full, empty, own);

  if (wg == 0) {  // producer
    hopper::regs_dec<L::kProducerRegs>();
    if (threadIdx.x < 32) {
      RING_SKEW(3, -1);
      if (threadIdx.x == 0) load_own<L, D>(&p.own_a, &p.own_b, base, own, q0, bh);
      produce<L, D>(&p.str_a, &p.str_b, nullptr, nullptr, a.sq, smem, base, full, empty, tiles,
                    bh / a.group, 1);
    }
    return;
  }

  // consumers
  hopper::regs_inc<L::kConsumerRegs>();
  CLK_DECL;
  const int cw = wg - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int w0 = q0 + 64 * cw;                     // the warpgroup's first query row
  const int r0 = w0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const int2 live = key_tiles_live<kStream>(a, w0, n_tiles), unmasked = key_tiles_full<kStream>(a, w0);
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
  CLK_ADD(8, t_life);
  RING_SKEW(0, -1);

  int stage = 0;
  uint32_t phase = 0;
  for (int kt = tiles.x; kt <= tiles.y; ++kt) {
    RING_SKEW(1, kt);
    CLK(t0_clk);
    CLK_GAP(9, t0_clk);
    hopper::mbar_wait(full + 8 * stage, phase);
    CLK_ADD(0, t0_clk);
    CLK_MARK();
    if (kMath && in(kt, live)) {
      CLK(t1_clk);
      CLK_GAP(10, t1_clk);
      const uint32_t slot = stage * L::kStageBytes;
      // S = Q.K^T and dP = dO.V^T, 64 rows x 64 keys each, as two groups
      // (the first k-step overwrites: no value goes in); P while dP runs
      float s[32], dp[32];
      hopper::wgmma_fence();
      product_ss<D, kStream, kOwn>(s, d_q, hopper::desc_advance(d_k, slot));
      hopper::wgmma_commit();
      product_ss<D, kStream, kOwn>(dp, d_do, hopper::desc_advance(d_k, slot + L::kStreamTile));
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
      CLK_ADD(1, t1_clk);
      CLK(t2_clk);
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
      pack_a<kStream>(ds, dp);
      CLK_ADD(2, t2_clk);
      CLK(t3_clk);
      hopper::wgmma_fence();
      product_rs<D, kStream>(acc, ds, hopper::desc_advance(d_k_mn, slot));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      CLK_ADD(3, t3_clk);
      CLK_TILE();
    }
    CLK(t4_clk);
    RING_SKEW(2, kt);
    __syncwarp();  // the warp's reads of the slot are done
    if (lane == 0) hopper::mbar_arrive(empty + 8 * stage);
    CLK_ADD(7, t4_clk);
    CLK_MARK();
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
  CLK_FLUSH();
}

// One block: keys k0..k0+127 of K/V row kvh (warpgroup 1 the first 64,
// warpgroup 2 the next); per query head of the group and live query tile,
// Q, dO, lse and c through the ring. The products run transposed (keys as
// rows): S^T = K.Q^T, dP^T = V.dO^T; lse and c are per column.
template <int D>
__global__ void __launch_bounds__(DkvLayout<D>::kThreads, 1) flash_bwd_dkv_bf16(const __grid_constant__ TmaArgs p) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = smem_base(smem_raw, smem);
  const Args& a = p.a;
  const uint32_t full = base + L::kBars, empty = full + 8 * L::kStages, own = empty + 8 * L::kStages;
  const int n_tiles = (a.sq + kStream - 1) / kStream;
  int kvh, rank;
  block_tile((a.sk + kOwn - 1) / kOwn, kvh, rank);
  const int k0 = rank * kOwn;
  const int2 tiles = either(dkv_live_tiles(a, k0, n_tiles), dkv_live_tiles(a, k0 + 64, n_tiles));
  const int wg = threadIdx.x >> 7;
  block_setup<L>(smem, full, empty, own);

  if (wg == 0) {  // producer
    hopper::regs_dec<L::kProducerRegs>();
    if (threadIdx.x < 32) {
      RING_SKEW(3, -1);
      if (threadIdx.x == 0) load_own<L, D>(&p.own_a, &p.own_b, base, own, k0, kvh);
      produce<L, D>(&p.str_a, &p.str_b, &p.lse, &p.c, a.sq, smem, base, full, empty, tiles,
                    kvh * a.group, a.group);
    }
    return;
  }

  // consumers
  hopper::regs_inc<L::kConsumerRegs>();
  CLK_DECL;
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
  CLK_ADD(8, t_life);
  RING_SKEW(0, -1);

  int stage = 0;
  uint32_t phase = 0;
  for (int hg = 0; hg < a.group; ++hg) {
    for (int qt = tiles.x; qt <= tiles.y; ++qt) {
      RING_SKEW(1, qt);
      CLK(t0_clk);
      CLK_GAP(9, t0_clk);
      hopper::mbar_wait(full + 8 * stage, phase);
      CLK_ADD(0, t0_clk);
      CLK_MARK();
      if (kMath && in(qt, live)) {
        CLK(t1_clk);
        CLK_GAP(10, t1_clk);
        const uint32_t slot = stage * L::kStageBytes;
        // S^T = K.Q^T and dP^T = V.dO^T, 64 keys x 64 queries each, as two
        // groups; P^T while dP^T runs; then dV += P^T.dO and dK += dS^T.Q
        // (P^T and dS^T in bf16 as the A operands, dO's and Q's tiles
        // MN-major)
        float s[32], dp[32];
        hopper::wgmma_fence();
        product_ss<D, kStream, kOwn>(s, d_k, hopper::desc_advance(d_q, slot));
        hopper::wgmma_commit();
        product_ss<D, kStream, kOwn>(dp, d_v, hopper::desc_advance(d_q, slot + L::kStreamTile));
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
        CLK_ADD(1, t1_clk);
        CLK(t2_clk);
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
        pack_a<kStream>(pa, s);
        pack_a<kStream>(sa, dp);
        CLK_ADD(2, t2_clk);
        CLK(t3_clk);
        hopper::wgmma_fence();
        product_rs<D, kStream>(dv, pa, hopper::desc_advance(d_q_mn, slot + L::kStreamTile));
        product_rs<D, kStream>(dk, sa, hopper::desc_advance(d_q_mn, slot));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
        CLK_ADD(3, t3_clk);
        CLK_TILE();
      }
      CLK(t4_clk);
      RING_SKEW(2, qt);
      __syncwarp();  // the warp's reads of the slot are done
      if (lane == 0) hopper::mbar_arrive(empty + 8 * stage);
      CLK_ADD(7, t4_clk);
      CLK_MARK();
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
  CLK_FLUSH();
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

template <int D>
int launch_dq_f32(const Args& a, int bh, cudaStream_t s) {
  const dim3 grid((a.sq + kTile - 1) / kTile, bh);
  return static_cast<int>(launch_one(flash_bwd_dq_f32<D>, grid, 256, f32_smem_bytes<D>(), a, s));
}

template <int D>
int launch_dkv_f32(const Args& a, int bh, cudaStream_t s) {
  const dim3 grid((a.sk + kTile - 1) / kTile, bh / a.group);
  return static_cast<int>(launch_one(flash_bwd_dkv_f32<D>, grid, 256, f32_smem_bytes<D>(), a, s));
}

template <int D>
int launch_dq(const Args& a, int bh, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    TmaArgs p{};
    p.a = a;
    const int kvn = bh / a.group;
    if (!hopper::map_bf16_rows(&p.own_a, a.q, D, a.sq, bh, kOwn) ||
        !hopper::map_bf16_rows(&p.own_b, a.dout, D, a.sq, bh, kOwn) ||
        !hopper::map_bf16_rows(&p.str_a, a.k, D, a.sk, kvn, kStream) ||
        !hopper::map_bf16_rows(&p.str_b, a.v, D, a.sk, kvn, kStream))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(bh * ((a.sq + kOwn - 1) / kOwn));
    return launch_ring<flash_bwd_dq_bf16<D>, DqLayout<D>>(grid, p, s);
  }
  return launch_dq_f32<D>(a, bh, s);
}

template <int D>
int launch_dkv(const Args& a, int bh, int dtype, cudaStream_t s) {
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
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(kvn * ((a.sk + kOwn - 1) / kOwn));
    return launch_ring<flash_bwd_dkv_bf16<D>, DkvLayout<D>>(grid, p, s);
  }
  return launch_dkv_f32<D>(a, bh, s);
}

// d 64 or 128 on both routes; float32 also 16 or 32 (the f32 kernels are
// generic in D; the small LMs of the serve CLI's decode lane have heads of 16)
bool bad_args(int bh, int d, int dtype, int group) {
  const bool wide = d == 64 || d == 128, narrow = d == 16 || d == 32;
  return !(dtype == 1 ? wide : dtype == 0 && (wide || narrow)) || group < 1 || bh % group != 0;
}

}  // namespace

// (FLASH_BWD_CLOCKS) the consumer cycle sums of the launches since the
// last call, then zeros
CLOCKS_ENTRY(flash_bwd_clocks)

#ifdef FLASH_BWD_RACE_PROBE
extern "C" int flash_bwd_probe_seed(unsigned seed) {
  return static_cast<int>(cudaMemcpyToSymbol(flash::probe_seed, &seed, sizeof(seed)));
}
#endif

// C entry points for ctypes. dtype: 0 float32, 1 bfloat16; d: 64 or 128
// (float32 also 16 or 32); window 0: none; bh counts query rows (k and v hold bh / group rows).
// Each returns the CUDA error code of its launch (0 on success,
// cudaErrorInvalidValue for a shape or dtype it is not built for), or
// hopper::kRegsRefused + r for a bf16 kernel compiled to r registers a
// thread, which it does not launch; the Python wrapper raises on anything
// but 0.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* c, void* dq, int bh, int sq,
                                   int sk, int d, int group, int q_off, int k_off, int causal,
                                   int window, float scale, int dtype, void* stream) {
  if (bad_args(bh, d, dtype, group)) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || sq <= 0) return 0;
  const Args a{q, k, v, dout, lse, c, dq, nullptr, nullptr, sq, sk, group, q_off, k_off, causal,
               window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_dq_f32<16>(a, bh, s);
    case 32: return launch_dq_f32<32>(a, bh, s);
    case 64: return launch_dq<64>(a, bh, dtype, s);
    default: return launch_dq<128>(a, bh, dtype, s);
  }
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
  switch (d) {
    case 16: return launch_dkv_f32<16>(a, bh, s);
    case 32: return launch_dkv_f32<32>(a, bh, s);
    case 64: return launch_dkv<64>(a, bh, dtype, s);
    default: return launch_dkv<128>(a, bh, dtype, s);
  }
}
