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
// f32 inputs take two other kernels, flash_bwd_dq_f32 and
// flash_bwd_dkv_f32, on the tensor cores in 3xTF32 (mma.sync m16n8k8, as
// flash_fwd_f32): each operand x is split as hi = tf32(x), lo = tf32(x -
// hi) by integer ops and each product summed as lo.hi + hi.lo + hi.hi in
// f32, within ~2^-22 of the f32 product (one TF32 pass misses the 1e-5
// tolerance ~30-100 times over: tests/test_torch_flash_bwd_tf32_split.py).
// Bound on the card: operations. dq makes three products and dkv four, of
// 2 D FLOP a kept pair each, three passes each; at B*H 64 x S 2048 x D 64
// causal that is 0.3125 and 0.4167 ms at the 495 TFLOP/s TF32 rate, but
// mma.sync alone issues TF32 at ~310 TFLOP/s on an H100 (700 W), so 0.50
// and 0.67 ms; bytes and exponentials take under 0.05 ms each. The design
// keeps the products fed: a block is up to four warps of 16 MT own rows
// (dq: query rows, the last first; dkv: keys, the first first), its own
// rows in shared memory (dq: Q and dO; dkv: K and V), the other side's
// tiles (dq: K, V; dkv: Q, dO, lse, c) double-buffered by cp.async; P and
// dS (P^T, dS^T) stay in registers and are the A operands of the gradient
// products as their accumulators stand (the k index permuted), so the
// streamed tiles are read both ways, at a row stride of 4 mod 16 that
// serves both without bank conflicts; dQ, dK and dV take each k-step's
// products by a float add (the tensor cores' own f32 sums truncate, and a
// gradient sums thousands of k-steps). The mask test runs once a score on
// tiles that cross an edge; whole tiles and a warp's 8-row blocks outside
// the band are skipped; exponentials on the MUFU unit.
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
#ifdef FLASH_BWD_F32_ONE_PASS
#define FLASH_F32_ONE_PASS
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
// FLASH_BWD_NO_MATH has the consumers wait and release without computing,
// FLASH_BWD_F32_ONE_PASS runs the f32 products in one TF32 pass.
// FLASH_BWD_F32_SUM_IN_MMA sums the f32 gradients inside the products
// (for benchmarks/flash_ab.py to show the drift that the float adds
// avoid).
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
// f32: 3xTF32 on the tensor cores (mma.sync m16n8k8)
// ---------------------------------------------------------------------------

// Row stride of every f32 tile in shared memory, in floats: 4 mod 16, so
// that both ways a tile is read are free of bank conflicts: as the B
// fragment of a product over D (row g, words t and t + 4: g stride + t
// takes 32 distinct banks) and as the B fragment of a product over the
// tile's rows with the permuted k index (rows 2t and 2t + 1, word g: 2t
// stride + g does too).
template <int D>
__host__ __device__ constexpr int f32_stride() {
  return D + 4;
}
// Rows of a streamed tile (dq: keys, dkv: queries): 16 at D 128 (shared
// memory for two blocks an SM), else as many as keep S and dP (S^T and
// dP^T) at 32 registers a thread: 32 with two m-tiles a warp or D 64, 64
// otherwise.
template <int D, int MT>
__host__ __device__ constexpr int f32_rows() {
  return D >= 128 ? 16 : (MT == 2 || D >= 64) ? 32 : 64;
}
// m-tiles a warp at most: two at D <= 64 in dq (each K/V fragment, loaded
// and split once, feeds both), at D <= 32 in dkv (whose dK and dV take 2 D
// registers a thread an m-tile)
constexpr int dq_max_mt(int d) { return d <= 64 ? 2 : 1; }
constexpr int dkv_max_mt(int d) { return d <= 32 ? 2 : 1; }
// blocks an SM the compiler must leave registers for: two (255 a thread)
// where the gradients and scores take 128 or more, else three (168)
template <int D, int MT, bool kDkv>
__host__ __device__ constexpr int f32_min_blocks() {
  return (kDkv ? MT * D : MT * D / 2) + MT * f32_rows<D, MT>() >= 128 ? 2 : 3;
}
// Shared memory of a block, in floats: its own rows (two matrices of 16
// MT rows a warp, of at most kF32Warps warps), then two stages of streamed
// tiles (two matrices of f32_rows rows; dkv also the rows' lse and c).
template <int D, int MT>
__host__ __device__ constexpr int f32_own_floats() {
  return 16 * MT * kF32Warps * f32_stride<D>();
}
template <int D, int MT, bool kDkv>
__host__ __device__ constexpr int f32_stage_floats() {
  return f32_rows<D, MT>() * (2 * f32_stride<D>() + (kDkv ? 2 : 0));
}
template <int D, int MT, bool kDkv>
__host__ __device__ constexpr int f32_smem_bytes() {
  return (2 * f32_own_floats<D, MT>() + 2 * f32_stage_floats<D, MT, kDkv>()) * 4;
}

// The backward's splits leave lo as it is (tf32_split<false>): as right
// to the tolerance as a rounded lo on the card, and 6% faster (PERF.md).
__device__ __forceinline__ Tf32Pair split(float x) { return tf32_split<false>(x); }

// acc += a.b in 3xTF32, the products summed on their own and added to acc
// by a float add: the tensor cores' f32 sums truncate, and a gradient sums
// thousands of k-steps. FLASH_BWD_F32_SUM_IN_MMA (a diagnostic build)
// sums inside the products instead.
__device__ __forceinline__ void add_3xtf32(float (&acc)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], Tf32Pair b0, Tf32Pair b1) {
#ifdef FLASH_BWD_F32_SUM_IN_MMA
  mma_3xtf32(acc, ah, al, b0, b1);
#else
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(c, ah, al, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
#endif
}

// The A fragment of rows r..r+15 of a tile of stride S, k-step kk, with
// the k index as it stands (a0, a1: column 8 kk + t of rows r, r + 8; a2,
// a3: column 8 kk + t + 4), split
template <int S>
__device__ __forceinline__ void a_rows(const float* tile, int r, int kk, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* p = tile + (r + g) * S + 8 * kk + t;
  const float x[4] = {p[0], p[8 * S], p[4], p[8 * S + 4]};
  tf32_split4<false>(x, hi, lo);
}

// The A fragment of k-step kk of a 16 x 8 NB accumulator (P, dS, P^T,
// dS^T), split, with the k index permuted: slot t is column 8 kk + 2t
// (x[kk][0], row g; x[kk][2], row g + 8), slot t + 4 column 2t + 1
// (x[kk][1], x[kk][3]). Its B operand is read with the same permutation.
template <int NB>
__device__ __forceinline__ void a_acc(const float (&x)[NB][4], int kk, uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
  const float f[4] = {x[kk][0], x[kk][2], x[kk][1], x[kk][3]};
  tf32_split4<false>(f, hi, lo);
}

// P and dS from S and dP in a thread's fragments (rows g, g + 8 of its
// m-tile; columns col0 + 8 nb + e % 2), in place: P = 2^(S scale log2e -
// lse log2e), zero where not kept (kMasked), on the MUFU unit; dS = P (dP
// scale - c scale). lse2(nb, e), cs(nb, e): the element's lse log2e and c
// scale (dq: its row's; dkv: its column's).
template <int NB, bool kMasked, class Lse, class C>
__device__ __forceinline__ void p_and_ds(float (&s)[NB][4], float (&dp)[NB][4],
                                         const int2 (&range)[2], int col0, float scale_log2,
                                         float scale, Lse lse2, C cs) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(s[nb][e], scale_log2, -lse2(nb, e)));
      s[nb][e] = kept<kMasked>(range, col0, nb, e) ? p : 0.f;
      dp[nb][e] = s[nb][e] * fmaf(dp[nb][e], scale, -cs(nb, e));
    }
  }
}

// One block: blockDim.x / 32 warps of 16 MT query rows of query row bh
// (the last rows first); its Q and dO rows in shared memory, copied with
// the first live K/V tile, and the live K/V tiles of KT keys
// double-buffered by cp.async (tile kt + 1 copied while tile kt is
// computed). Each warp computes S = Q.K^T and dP = dO.V^T of its rows,
// then P and dS in registers, then dQ += dS.K, all with mma.sync m16n8k8
// in 3xTF32; each K/V fragment, loaded and split once, feeds all MT
// m-tiles. dS.K takes dS's accumulator as its A fragment as it stands
// (a_acc), so K is read both ways (f32_stride).
template <int D, int MT>
__global__ void __launch_bounds__(128, f32_min_blocks<D, MT, false>()) flash_bwd_dq_f32(Args a) {
  constexpr int KT = f32_rows<D, MT>(), S = f32_stride<D>();
  constexpr int NB = KT / 8;  // 8-key blocks of S and dP, k-steps of dS.K
  constexpr int DK = D / 8;   // k-steps of S and dP, 8-column blocks of dQ
  constexpr int kOwn = f32_own_floats<D, MT>(), kStage = f32_stage_floats<D, MT, false>();
  extern __shared__ __align__(16) float smem_f32[];

  const int bm = 16 * MT * (blockDim.x >> 5);  // query rows of the block
  const int n_own = (a.sq + bm - 1) / bm;
  int bh, rank;
  block_tile(n_own, bh, rank);
  const int q0 = (n_own - 1 - rank) * bm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w0 = q0 + 16 * MT * warp;  // the warp's first row; m-tile m's row g: w0 + 16 m + g

  // the key tiles live for the block's rows, [t_lo, t_hi] (whole tiles out
  // of the causal or window band skipped: all their P are 0)
  const int n_tiles = (a.sk + KT - 1) / KT;
  int t_lo = 0, t_hi = n_tiles - 1;
  if (a.causal) {
    t_hi = min(t_hi, floor_div<KT>(a.q_off + min(q0 + bm, a.sq) - 1 - a.k_off));
    if (a.window > 0) t_lo = max(0, floor_div<KT>(a.q_off + q0 - a.window + 1 - a.k_off));
  }
  // the keys some row of the warp keeps, [kx, ky], and those all rows of
  // m-tile m keep, [fx[m], fy[m]]
  const bool w_live = w0 < a.sq;
  int kx = 0, ky = a.sk - 1, fx[MT], fy[MT];
  if (a.causal) {
    ky = min(ky, a.q_off + min(w0 + 16 * MT - 1, a.sq - 1) - a.k_off);
    if (a.window > 0) kx = a.q_off + w0 - a.window + 1 - a.k_off;
  }
  const size_t q_row = static_cast<size_t>(bh) * a.sq;
  const float scale = a.scale, scale_log2 = scale * kLog2e;
  int2 range[MT][2];
  float lse2[MT][2], cs[MT][2];  // lse log2e and c scale of rows g and g + 8
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int m0 = w0 + 16 * m, ml = min(m0 + 15, a.sq - 1);
    fx[m] = 0;
    fy[m] = a.sk - 1;
    if (a.causal) {
      fy[m] = min(fy[m], a.q_off + m0 - a.k_off);
      if (a.window > 0) fx[m] = a.q_off + ml - a.window + 1 - a.k_off;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h;
      range[m][h] = keys_kept(a, r);
      lse2[m][h] = r < a.sq ? a.lse[q_row + r] * kLog2e : 0.f;
      cs[m][h] = r < a.sq ? a.c[q_row + r] * scale : 0.f;
    }
  }

  const float* qg = static_cast<const float*>(a.q) + q_row * D;
  const float* dog = static_cast<const float*>(a.dout) + q_row * D;
  const size_t kv_row = static_cast<size_t>(bh / a.group) * a.sk * D;
  const float* kg = static_cast<const float*>(a.k) + kv_row;
  const float* vg = static_cast<const float*>(a.v) + kv_row;
  float* qs = smem_f32;  // the block's Q rows, then its dO rows
  float* dos = qs + kOwn;
  float* stages = dos + kOwn;
  // K/V tile kt into stage `buf` (rows past Sk zero-filled), 16 bytes a
  // copy; one commit group
  auto load = [&](int kt, int buf) {
    float* ks = stages + buf * kStage;
    float* vs = ks + KT * S;
    const int k0 = kt * KT;
    for (int i = threadIdx.x; i < KT * (D / 4); i += blockDim.x) {
      const int row = i / (D / 4), col = 4 * (i % (D / 4));
      const bool ok = k0 + row < a.sk;
      const size_t off = ok ? static_cast<size_t>(k0 + row) * D + col : 0;
      cp_async16(ks + row * S + col, kg + off, ok);
      cp_async16(vs + row * S + col, vg + off, ok);
    }
    cp_async_commit();
  };

  float acc[MT][DK][4];  // dQ: rows g (0, 1) and g + 8 (2, 3), columns 8 nb + 2t + e % 2
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nb = 0; nb < DK; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nb][e] = 0.f;

  if (t_lo <= t_hi) {  // the block's Q and dO rows (past Sq zero-filled) and tile t_lo
    PROBE_POISON(smem_f32, 2 * kOwn + kStage);
    for (int i = threadIdx.x; i < bm * (D / 4); i += blockDim.x) {
      const int row = i / (D / 4), col = 4 * (i % (D / 4));
      const bool ok = q0 + row < a.sq;
      const size_t off = ok ? static_cast<size_t>(q0 + row) * D + col : 0;
      cp_async16(qs + row * S + col, qg + off, ok);
      cp_async16(dos + row * S + col, dog + off, ok);
    }
    load(t_lo, 0);
  }
  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int buf = (kt - t_lo) & 1;
    PROBE_SKEW(1, kt);
    cp_async_wait_all();
    // tile kt is in place for every warp, and every warp is done with
    // tile kt - 1, whose stage the next copy overwrites
    __syncthreads();
    PROBE_SKEW(2, kt);
    if (kt < t_hi) {
      PROBE_POISON(stages + (buf ^ 1) * kStage, kStage);
      load(kt + 1, buf ^ 1);
    }
    PROBE_SKEW(3, kt);
    const int k0 = kt * KT;
    // the warp's live 8-key blocks of the tile, [lo8, hi8)
    const int lo8 = max(0, kx - k0) >> 3, hi8 = (max(0, min(KT, ky - k0 + 1)) + 7) >> 3;
    if (!w_live || lo8 >= hi8) continue;
    const float* ks = stages + buf * kStage;
    const float* vs = ks + KT * S;

    // S = Q.K^T and dP = dO.V^T over the D columns
    float s[MT][NB][4], dp[MT][NB][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][nb][e] = dp[m][nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qh[MT][4], ql[MT][4], oh[MT][4], ol[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        a_rows<S>(qs, w0 - q0 + 16 * m, kk, g, t, qh[m], ql[m]);
        a_rows<S>(dos, w0 - q0 + 16 * m, kk, g, t, oh[m], ol[m]);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb < lo8 || nb >= hi8) continue;
        // B = K^T (V^T): k-slots t, t + 4 are key 8 nb + g's columns 8 kk + t, + 4
        const float* kr = ks + (8 * nb + g) * S + 8 * kk + t;
        const float* vr = vs + (8 * nb + g) * S + 8 * kk + t;
        const Tf32Pair k0p = split(kr[0]), k1p = split(kr[4]);
        const Tf32Pair v0p = split(vr[0]), v1p = split(vr[4]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_3xtf32(s[m][nb], qh[m], ql[m], k0p, k1p);
          mma_3xtf32(dp[m][nb], oh[m], ol[m], v0p, v1p);
        }
      }
    }

#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const auto row_lse = [&](int, int e) { return lse2[m][e >> 1]; };
      const auto row_c = [&](int, int e) { return cs[m][e >> 1]; };
      if (fx[m] <= k0 && k0 + KT - 1 <= fy[m]) {
        p_and_ds<NB, false>(s[m], dp[m], range[m], k0 + 2 * t, scale_log2, scale, row_lse, row_c);
      } else {
        p_and_ds<NB, true>(s[m], dp[m], range[m], k0 + 2 * t, scale_log2, scale, row_lse, row_c);
      }
    }

    // dQ += dS.K over the tile's keys (dS 0 outside [lo8, hi8))
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      if (kk < lo8 || kk >= hi8) continue;
      uint32_t dh[MT][4], dl[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) a_acc<NB>(dp[m], kk, dh[m], dl[m]);
      // B = K: k-slots t, t + 4 are keys 8 kk + 2t, + 1; column 8 nb + g
      const float* kr = ks + (8 * kk + 2 * t) * S + g;
#pragma unroll
      for (int nb = 0; nb < DK; ++nb) {
        const Tf32Pair b0 = split(kr[8 * nb]), b1 = split(kr[S + 8 * nb]);
#pragma unroll
        for (int m = 0; m < MT; ++m) add_3xtf32(acc[m][nb], dh[m], dl[m], b0, b1);
      }
    }
  }

  if (!w_live) return;
  float* dq = static_cast<float*>(a.dq) + q_row * D;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = w0 + 16 * m + g, r1 = r0 + 8;
#pragma unroll
    for (int nb = 0; nb < DK; ++nb) {
      const int col = 8 * nb + 2 * t;
      if (r0 < a.sq)
        *reinterpret_cast<float2*>(dq + static_cast<size_t>(r0) * D + col) =
            make_float2(acc[m][nb][0], acc[m][nb][1]);
      if (r1 < a.sq)
        *reinterpret_cast<float2*>(dq + static_cast<size_t>(r1) * D + col) =
            make_float2(acc[m][nb][2], acc[m][nb][3]);
    }
  }
}

// One block: blockDim.x / 32 warps of 16 MT keys of K/V row kvh (the first
// keys first); its K and V rows in shared memory, copied with the first
// live query tile, and for each of the group's query heads its live tiles
// of QT queries of Q and dO, with their lse and c, double-buffered by
// cp.async (one run over the heads' tiles). Each warp computes S^T = K.Q^T
// and dP^T = V.dO^T of its keys, then P^T and dS^T in registers (lse and
// c are per column), then dV += P^T.dO and dK += dS^T.Q, all with mma.sync
// m16n8k8 in 3xTF32; P^T and dS^T are the A fragments of the last two as
// their accumulators stand (a_acc), so Q and dO are each read both ways
// (f32_stride).
template <int D, int MT>
__global__ void __launch_bounds__(128, f32_min_blocks<D, MT, true>()) flash_bwd_dkv_f32(Args a) {
  constexpr int QT = f32_rows<D, MT>(), S = f32_stride<D>();
  constexpr int NB = QT / 8;  // 8-query blocks of S^T and dP^T, k-steps of dV and dK
  constexpr int DK = D / 8;   // k-steps of S^T and dP^T, 8-column blocks of dK and dV
  constexpr int kOwn = f32_own_floats<D, MT>(), kStage = f32_stage_floats<D, MT, true>();
  extern __shared__ __align__(16) float smem_f32[];

  const int bn = 16 * MT * (blockDim.x >> 5);  // keys of the block
  const int n_own = (a.sk + bn - 1) / bn;
  int kvh, rank;
  block_tile(n_own, kvh, rank);
  const int k0 = rank * bn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w0 = k0 + 16 * MT * warp;  // the warp's first key; m-tile m's key g: w0 + 16 m + g

  // the query tiles live for the block's keys, [t_lo, t_hi], the same for
  // each query head of the group
  const int n_tiles = (a.sq + QT - 1) / QT;
  int t_lo = 0, t_hi = n_tiles - 1;
  if (a.causal) {
    t_lo = max(0, floor_div<QT>(a.k_off + k0 - a.q_off));
    if (a.window > 0)
      t_hi = min(t_hi, floor_div<QT>(a.k_off + min(k0 + bn, a.sk) - 2 + a.window - a.q_off));
  }
  const int n_live = max(0, t_hi - t_lo + 1), n_iter = a.group * n_live;
  // the queries that keep some key of the warp, [qx, qy], and those that
  // keep every key of m-tile m, [gx[m], gy[m]] (none where it has a key
  // past Sk)
  const bool w_live = w0 < a.sk;
  int qx = 0, qy = a.sq - 1, gx[MT], gy[MT];
  if (a.causal) {
    qx = a.k_off + w0 - a.q_off;
    if (a.window > 0) qy = min(qy, a.k_off + min(w0 + 16 * MT, a.sk) - 2 + a.window - a.q_off);
  }
  int2 range[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int m0 = w0 + 16 * m;
    gx[m] = 0;
    gy[m] = m0 + 15 < a.sk ? a.sq - 1 : -1;
    if (a.causal) {
      gx[m] = a.k_off + m0 + 15 - a.q_off;
      if (a.window > 0) gy[m] = min(gy[m], a.k_off + m0 + a.window - 1 - a.q_off);
    }
    range[m][0] = queries_kept(a, m0 + g);
    range[m][1] = queries_kept(a, m0 + g + 8);
  }
  const float scale = a.scale, scale_log2 = scale * kLog2e;

  const size_t kv_row = static_cast<size_t>(kvh) * a.sk * D;
  const float* kg = static_cast<const float*>(a.k) + kv_row;
  const float* vg = static_cast<const float*>(a.v) + kv_row;
  const float* qg = static_cast<const float*>(a.q);
  const float* dog = static_cast<const float*>(a.dout);
  float* ks = smem_f32;  // the block's K rows, then its V rows
  float* vs = ks + kOwn;
  float* stages = vs + kOwn;
  // step i (query head i / n_live of the group, its tile t_lo + i %
  // n_live) into stage `buf`: the tile's Q and dO rows and their lse and c
  // (past Sq zero-filled); one commit group
  auto load = [&](int i, int buf) {
    float* qs = stages + buf * kStage;
    float* dos = qs + QT * S;
    float* stats = dos + QT * S;
    const size_t q_row = (static_cast<size_t>(kvh) * a.group + i / n_live) * a.sq;
    const int q0 = (t_lo + i % n_live) * QT;
    for (int j = threadIdx.x; j < QT * (D / 4); j += blockDim.x) {
      const int row = j / (D / 4), col = 4 * (j % (D / 4));
      const bool ok = q0 + row < a.sq;
      const size_t off = ok ? (q_row + q0 + row) * D + col : 0;
      cp_async16(qs + row * S + col, qg + off, ok);
      cp_async16(dos + row * S + col, dog + off, ok);
    }
    for (int j = threadIdx.x; j < QT; j += blockDim.x) {
      const bool ok = q0 + j < a.sq;
      const size_t off = ok ? q_row + q0 + j : 0;
      cp_async4(stats + j, a.lse + off, ok);
      cp_async4(stats + QT + j, a.c + off, ok);
    }
    cp_async_commit();
  };

  float dk[MT][DK][4], dv[MT][DK][4];  // keys g (0, 1) and g + 8 (2, 3), columns 8 nb + 2t + e % 2
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nb = 0; nb < DK; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[m][nb][e] = dv[m][nb][e] = 0.f;

  if (n_iter > 0) {  // the block's K and V rows (past Sk zero-filled) and step 0
    PROBE_POISON(smem_f32, 2 * kOwn + kStage);
    for (int i = threadIdx.x; i < bn * (D / 4); i += blockDim.x) {
      const int row = i / (D / 4), col = 4 * (i % (D / 4));
      const bool ok = k0 + row < a.sk;
      const size_t off = ok ? static_cast<size_t>(k0 + row) * D + col : 0;
      cp_async16(ks + row * S + col, kg + off, ok);
      cp_async16(vs + row * S + col, vg + off, ok);
    }
    load(0, 0);
  }
  for (int i = 0; i < n_iter; ++i) {
    const int buf = i & 1;
    PROBE_SKEW(1, i);
    cp_async_wait_all();
    // step i is in place for every warp, and every warp is done with step
    // i - 1, whose stage the next copy overwrites
    __syncthreads();
    PROBE_SKEW(2, i);
    if (i + 1 < n_iter) {
      PROBE_POISON(stages + (buf ^ 1) * kStage, kStage);
      load(i + 1, buf ^ 1);
    }
    PROBE_SKEW(3, i);
    const int q0 = (t_lo + i % n_live) * QT;
    // the warp's live 8-query blocks of the tile, [lo8, hi8)
    const int lo8 = max(0, qx - q0) >> 3, hi8 = (max(0, min(QT, qy - q0 + 1)) + 7) >> 3;
    if (!w_live || lo8 >= hi8) continue;
    const float* qs = stages + buf * kStage;
    const float* dos = qs + QT * S;
    const float* stats = dos + QT * S;

    // S^T = K.Q^T and dP^T = V.dO^T over the D columns
    float st[MT][NB][4], dpt[MT][NB][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[m][nb][e] = dpt[m][nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t kh[MT][4], kl[MT][4], vh[MT][4], vl[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        a_rows<S>(ks, w0 - k0 + 16 * m, kk, g, t, kh[m], kl[m]);
        a_rows<S>(vs, w0 - k0 + 16 * m, kk, g, t, vh[m], vl[m]);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb < lo8 || nb >= hi8) continue;
        // B = Q^T (dO^T): k-slots t, t + 4 are query 8 nb + g's columns 8 kk + t, + 4
        const float* qr = qs + (8 * nb + g) * S + 8 * kk + t;
        const float* dr = dos + (8 * nb + g) * S + 8 * kk + t;
        const Tf32Pair q0p = split(qr[0]), q1p = split(qr[4]);
        const Tf32Pair d0p = split(dr[0]), d1p = split(dr[4]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_3xtf32(st[m][nb], kh[m], kl[m], q0p, q1p);
          mma_3xtf32(dpt[m][nb], vh[m], vl[m], d0p, d1p);
        }
      }
    }

    // this thread's columns 8 nb + 2t, + 1 of the tile's lse and c
    const float2* lse_c = reinterpret_cast<const float2*>(stats) + t;
    const auto col_lse = [&](int nb, int e) {
      const float2 x = lse_c[4 * nb];
      return ((e & 1) ? x.y : x.x) * kLog2e;
    };
    const auto col_c = [&](int nb, int e) {
      const float2 x = lse_c[QT / 2 + 4 * nb];
      return ((e & 1) ? x.y : x.x) * scale;
    };
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (gx[m] <= q0 && q0 + QT - 1 <= gy[m]) {
        p_and_ds<NB, false>(st[m], dpt[m], range[m], q0 + 2 * t, scale_log2, scale, col_lse, col_c);
      } else {
        p_and_ds<NB, true>(st[m], dpt[m], range[m], q0 + 2 * t, scale_log2, scale, col_lse, col_c);
      }
    }

    // dV += P^T.dO and dK += dS^T.Q over the tile's queries (P^T and dS^T 0
    // outside [lo8, hi8))
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      if (kk < lo8 || kk >= hi8) continue;
      uint32_t ph[MT][4], pl[MT][4], sh[MT][4], sl[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        a_acc<NB>(st[m], kk, ph[m], pl[m]);
        a_acc<NB>(dpt[m], kk, sh[m], sl[m]);
      }
      // B = dO (Q): k-slots t, t + 4 are queries 8 kk + 2t, + 1; column 8 nb + g
      const float* dr = dos + (8 * kk + 2 * t) * S + g;
      const float* qr = qs + (8 * kk + 2 * t) * S + g;
#pragma unroll
      for (int nb = 0; nb < DK; ++nb) {
        const Tf32Pair o0 = split(dr[8 * nb]), o1 = split(dr[S + 8 * nb]);
        const Tf32Pair x0 = split(qr[8 * nb]), x1 = split(qr[S + 8 * nb]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          add_3xtf32(dv[m][nb], ph[m], pl[m], o0, o1);
          add_3xtf32(dk[m][nb], sh[m], sl[m], x0, x1);
        }
      }
    }
  }

  if (!w_live) return;
  float* dkp = static_cast<float*>(a.dk) + kv_row;
  float* dvp = static_cast<float*>(a.dv) + kv_row;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = w0 + 16 * m + g, r1 = r0 + 8;
#pragma unroll
    for (int nb = 0; nb < DK; ++nb) {
      const int col = 8 * nb + 2 * t;
      if (r0 < a.sk) {
        *reinterpret_cast<float2*>(dkp + static_cast<size_t>(r0) * D + col) =
            make_float2(dk[m][nb][0], dk[m][nb][1]);
        *reinterpret_cast<float2*>(dvp + static_cast<size_t>(r0) * D + col) =
            make_float2(dv[m][nb][0], dv[m][nb][1]);
      }
      if (r1 < a.sk) {
        *reinterpret_cast<float2*>(dkp + static_cast<size_t>(r1) * D + col) =
            make_float2(dk[m][nb][2], dk[m][nb][3]);
        *reinterpret_cast<float2*>(dvp + static_cast<size_t>(r1) * D + col) =
            make_float2(dv[m][nb][2], dv[m][nb][3]);
      }
    }
  }
}

template <auto kKernel, int D, int MT, bool kDkv>
int launch_f32(const Args& a, int heads, int rows, int nw, cudaStream_t s) {
  const dim3 grid(heads * ((rows + 16 * MT * nw - 1) / (16 * MT * nw)));
  constexpr int bytes = f32_smem_bytes<D, MT, kDkv>();
  cudaError_t err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kKernel<<<grid, 32 * nw, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_f32(const Args& a, int bh, cudaStream_t s) {
  const F32Shape sh = f32_shape(bh, a.sq, dq_max_mt(D));
  if constexpr (dq_max_mt(D) == 2) {
    if (sh.mt == 2) return launch_f32<flash_bwd_dq_f32<D, 2>, D, 2, false>(a, bh, a.sq, sh.warps, s);
  }
  return launch_f32<flash_bwd_dq_f32<D, 1>, D, 1, false>(a, bh, a.sq, sh.warps, s);
}

template <int D>
int launch_dkv_f32(const Args& a, int bh, cudaStream_t s) {
  const int kvn = bh / a.group;
  const F32Shape sh = f32_shape(kvn, a.sk, dkv_max_mt(D));
  if constexpr (dkv_max_mt(D) == 2) {
    if (sh.mt == 2) return launch_f32<flash_bwd_dkv_f32<D, 2>, D, 2, true>(a, kvn, a.sk, sh.warps, s);
  }
  return launch_f32<flash_bwd_dkv_f32<D, 1>, D, 1, true>(a, kvn, a.sk, sh.warps, s);
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
