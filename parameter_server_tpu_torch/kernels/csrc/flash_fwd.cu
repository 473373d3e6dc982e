// flash_fwd: FlashAttention-2 forward over head-major [BH, S, D] tensors.
//
// Replaces the Pallas kernel parameter_server_tpu/ops/flash_attention.py::
// _fwd_pallas (body _fwd_kernel). Plain version: ops/flash_attention.py::
// flash_attention_ref. Returns out [BH, Sq, D] in the input dtype and
// lse [BH, Sq] float32; causal, sliding window and the global q/k offsets
// mask exactly as _fwd_kernel does; a fully masked row gives out = 0 and
// lse = -1e30. K/V may carry BH / group rows: query row bh reads K/V row
// bh / group (grouped-query attention without materializing the repeat).
//
// Precision, as the TPU kernel's: dot operands in the input dtype, sums
// in f32, P cast to v's dtype before P.V, softmax statistics in f32. Not
// bit-equal to the plain version (other summation order, P rounded against
// the running row max, exp on the MUFU unit), so this library is built
// without --fmad=false.
//
// Bound on the card: operations, two products (4 D FLOP) over the
// (query, key) pairs the masks keep. At the LM training shape (BH 32, S
// 8192, D 64, bf16, causal) that is 1.074e9 pairs, 0.278 ms at the 989
// TFLOP/s bf16 tensor-core rate, against ~134 MB of q/k/v/out/lse, 0.04 ms
// at 3.35 TB/s; at the serving prefill (BH 64, S 2048, GQA 4) 0.0348 ms.
// At D 64 the exponentials bind as tightly: one ex2 a kept pair, and the
// MUFU unit does 16 a clock on each of the 132 SMs, 0.26-0.29 ms at the
// training shape at 1.75-1.98 GHz. So the kernel reaches its bound only if
// the exponentials of one warpgroup run while the products of another do.
//
// What the bf16 design does about it (Hopper, sm_90a; the block, its ring
// and its producer are flash_common.cuh's, shared with flash_bwd). A block
// owns 64 query rows for each of its consumer warpgroups, three at D 64
// and two at D 128 (where O and S take 128 registers a thread), plus
// warpgroup 0, which gives up its registers (setmaxnreg); one of its warps
// loads Q once and streams 128-key tiles of K and V (GQA: K/V row bh /
// group of a 3-D tensor map, read in place) through TMA into a ring of
// stages. For key tile j a consumer warpgroup issues S_j = Q.K_j^T (wgmma,
// both operands in shared memory, K-major) and, as a second group, O = O
// corr + P_{j-1}.V_{j-1} (O rescaled while S_j runs; P in registers as
// bf16 A fragments, V read MN-major); while P.V runs it computes the
// online softmax of S_j in registers: the row max, P = 2^(S scale log2e -
// m) on the MUFU unit (ex2.approx), corr = 2^(m_old - m), the row sums;
// then it packs P for the next tile's P.V. The tensor cores are fed by the
// warpgroups running side by side, not in turns: on an H100 at 700 W a
// warpgroup waits ~1,350 cycles for its S even with no softmax at all
// (its products and its neighbours' queue on the tensor cores), so a third
// warpgroup gains ~20%, while making the warpgroups take turns at the
// tensor cores (FlashAttention-3's "ping-pong", tried on two mbarriers)
// gained nothing at two and cost ~20% at three (benchmarks/flash_ab.py;
// PERF.md has the runs). The tile loop is lean, as the backward's tuning
// found it must be: each warpgroup computes its live and unmasked tile
// runs and its descriptors once a block, the mask (key tail, query tail,
// causal diagonal, window edge) is a branch-free select on the tiles that
// cross one, and one arrive a warp releases a slot. Whole tiles outside the causal or window band are
// skipped (_block_live at 128 keys: skipping one changes no bit, since it
// would add P = 0 and scale by 1). The grid starts the longest blocks, the
// last query tiles, first. No atomics: the output is bit-identical from
// run to run.
//
// f32 inputs take a second kernel, flash_fwd_f32, on the tensor cores in
// 3xTF32 (mma.sync m16n8k8): each operand x is split as hi = tf32(x), lo =
// tf32(x - hi), rounded to nearest by integer ops, and each product summed
// as lo.hi + hi.lo + hi.hi in f32, within ~2^-22 of the f32 product (one
// TF32 pass keeps ~2^-11 and would miss the 2e-5 tolerance ~50 times over:
// tests/test_torch_flash_tf32_split.py). The tensor cores' own f32 sums
// truncate, so O takes each k-step's products by a float add, not as the
// products' accumulator: summed inside them over a row of 8192 keys, an
// output drifted 7.6e-6 from the plain version's, 1.7e-6 with the adds
// (which cost ~12% of the time). Bound on the card: the three passes' 12 D FLOP a kept pair at
// the 495 TFLOP/s TF32 rate, 0.208 ms at B*H 64 x S 2048 x D 64 causal,
// against 0.040 ms of bytes and 0.032 ms of exponentials; but mma.sync,
// measured alone, issues TF32 products at ~310 TFLOP/s (wgmma alone reaches
// the peak), so the three passes take at least 0.33 ms there. The design
// keeps the products fed and the work per product small: warps of 16 MT
// query rows (MT = 2 m-tiles at D <= 64, so that each B fragment, loaded
// and split once, feeds two m-tiles' products), four warps a block, fewer
// and one m-tile where Sq is short (a join of 8 prompt rows is one warp a
// block), the grid still a block an SM; the block's Q rows staged once in
// shared memory with its first K/V tile, and K/V tiles of 32 keys (64
// where a warp's O is small) double-buffered by cp.async, rows padded so
// that the fragment loads have no bank conflicts; the k index of both
// products permuted so that S's accumulator is P's A fragment as it stands
// (no shuffle, no pass through shared memory) and K and Q load as 8-byte
// pairs; a warp's dead 8-key blocks of a tile skipped beside the block's
// dead tiles; the mask test once a score, only on tiles that cross an
// edge; exponentials on the MUFU unit (ex2.approx). At that prefill it runs
// in ~0.75 ms, 3.8x the kernel before it and 1.6x SDPA's f32 forward;
// one TF32 pass (FLASH_FWD_F32_ONE_PASS) runs in ~0.32, so the rest of the
// loop, not the products, is half of it. Splitting K and V once a block in
// shared memory (a pass and a second barrier a tile, then bare 16-byte
// fragment loads) ran no faster. wgmma (TF32 takes B only K-major: V
// transposed in shared memory) and warp specialisation are the next steps.
//
// The TPU kernel's transposed [D, Sq] layout and its (8, 128) padding
// were Mosaic's, and its sequential k grid axis is the loop over k tiles
// here.
//
// Diagnostic builds, never the ones the port runs: -DFLASH_FWD_RACE_PROBE
// poisons every shared tile with NaN before it is filled (a ring slot
// between its release and its refill) and has each thread sleep a seeded
// pseudo-random while (up to ~1 us, `probe_seed`) before every barrier
// wait and arrive and at every hand-over through shared memory; with the
// hand-overs right, the output is bit-identical to the normal build's
// (tests/test_torch_kernels_cuda.py). For benchmarks/flash_ab.py:
// -DFLASH_FWD_CLOCKS counts the bf16 consumers' cycles by phase; and
// builds with wrong outputs that time one part alone: -DFLASH_FWD_NO_SOFTMAX,
// -DFLASH_FWD_NO_PV, -DFLASH_FWD_NO_LOAD (both routes), and
// -DFLASH_FWD_F32_ONE_PASS (the f32 route, one TF32 pass). The library
// also times mma.sync's TF32 rate alone (flash_fwd_tf32_mma_rate).
#ifdef FLASH_FWD_RACE_PROBE
#define FLASH_RACE_PROBE
#endif
#ifdef FLASH_FWD_CLOCKS
#define FLASH_RING_CLOCKS
#endif
#ifdef FLASH_FWD_NO_LOAD
#define FLASH_RING_NO_LOAD
#endif
#ifdef FLASH_FWD_F32_ONE_PASS
#define FLASH_F32_ONE_PASS
#endif
#include "flash_common.cuh"

namespace {

using namespace flash;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int sq, sk, group, q_off, k_off, causal, window;  // window 0: none
  float scale;
};

__device__ __forceinline__ float finish_lse(float m, float l) {
  return l > 0.f ? m + logf(fmaxf(l, 1e-30f)) : kNeg;
}

// ---------------------------------------------------------------------------
// bf16: wgmma, a TMA ring of K/V tiles, a producer warp
// ---------------------------------------------------------------------------

// keys of a streamed tile (64-key tiles measured ~15% slower at the
// training shape: twice the loop trips and fixed cost a tile)
constexpr int kKeys = 128;
constexpr float kLn2 = 0.6931471805599453f;
// Timing diagnostics (wrong outputs): FLASH_FWD_NO_SOFTMAX skips the
// online softmax (P is S as it is), FLASH_FWD_NO_PV the P.V products,
// FLASH_FWD_NO_LOAD the loads (the ring's barriers arrive without them).
#ifdef FLASH_FWD_NO_SOFTMAX
constexpr bool kSoftmax = false;
#else
constexpr bool kSoftmax = true;
#endif
#ifdef FLASH_FWD_NO_PV
constexpr bool kPv = false;
#else
constexpr bool kPv = true;
#endif

// consumer warpgroups a block: three at D 64 (two took ~1.2x as long at
// the training shape), two at D 128 (its O and S take 128 registers a thread,
// which three would not have)
template <int D>
constexpr int fwd_wg() {
  return D == 64 ? 3 : 2;
}

// as many stages of a K and a V tile as fit beside Q, at most 4
template <int D>
constexpr int fwd_stages() {
  constexpr int stage = 2 * kKeys * D * 2, room = 232448 - 1024 - 128 - 64 * fwd_wg<D>() * D * 2;
  return room / stage < 4 ? room / stage : 4;
}

// The block and its shared memory: Q's own rows, the ring's K/V tile
// pairs, the barriers.
template <int D>
using FwdLayout = Layout<D, fwd_wg<D>(), 1, kKeys, 2, fwd_stages<D>(), 0>;

struct TmaArgs {
  Args a;
  CUtensorMap q;     // 128-row boxes of [BH, Sq, D]
  CUtensorMap k, v;  // kKeys-row boxes of [BH / group, Sk, D]
};

// FLASH_FWD_CLOCKS: the consumer cycles (flash_common.cuh) [0] waiting for
// a tile, [1] from rescaling O and issuing the products to S, [2] in the
// online softmax, [3] then waiting for P.V, [7] releasing the slot, [11]
// packing P, [8] waiting for Q, [9] from the end of a tile to the next
// wait.

// Keeps the compiler from reusing the registers of an A operand while the
// asynchronous product that reads them runs: read-written after its wait.
template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// One key tile of the online softmax over a thread's fragment of S [64 x
// kKeys] (rows e / 2 of element 4j + e): the new row maxima m2 (in units
// of log2, scaled), corr = 2^(old m2 - new m2), which moves what was summed
// against the old maxima onto the new ones, P = 2^(S scale log2e - m2) in
// place of S, and the row sums l (this thread's columns). A masked element
// (kMasked) counts as -inf: it raises no maximum and its P is 0.
template <bool kMasked>
__device__ __forceinline__ void online_softmax(float (&s)[kKeys / 2], const int2 (&range)[2],
                                               int col0, float scale_log2, float (&m2)[2],
                                               float (&l)[2], float (&corr)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      if (kMasked) s[i] = kept<true>(range, col0, j, e) ? s[i] : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m2[r], quad_max(mx[r]) * scale_log2);
    corr[r] = exp2_approx(m2[r] - mn);
    m2[r] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -m2[r]));
    sum[r] += s[i];
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

// One block: query rows q0.. of query row bh, 64 a consumer warpgroup;
// per live key tile, K and V through the ring.
template <int D>
__global__ void __launch_bounds__(FwdLayout<D>::kThreads, 1) flash_fwd_bf16(const __grid_constant__ TmaArgs p) {
  using L = FwdLayout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = smem_base(smem_raw, smem);
  const Args& a = p.a;
  const uint32_t full = base + L::kBars, empty = full + 8 * L::kStages, own = empty + 8 * L::kStages;
  const int n_own = (a.sq + L::kOwnRows - 1) / L::kOwnRows, n_tiles = (a.sk + kKeys - 1) / kKeys;
  int bh, rank;
  block_tile(n_own, bh, rank);
  const int q0 = (n_own - 1 - rank) * L::kOwnRows;
  int2 tiles = key_tiles_live<kKeys>(a, q0, n_tiles);
#pragma unroll
  for (int c = 1; c < L::kWG; ++c) tiles = either(tiles, key_tiles_live<kKeys>(a, q0 + 64 * c, n_tiles));
  const int wg = threadIdx.x >> 7;
  block_setup<L>(smem, full, empty, own);

  if (wg == 0) {  // producer
    hopper::regs_dec<L::kProducerRegs>();
    if (threadIdx.x < 32) {
      RING_SKEW(3, -1);
      if (threadIdx.x == 0) load_own<L, D>(&p.q, nullptr, base, own, q0, bh);
      produce<L, D>(&p.k, &p.v, nullptr, nullptr, a.sq, smem, base, full, empty, tiles,
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
  const int2 live = key_tiles_live<kKeys>(a, w0, n_tiles), unmasked = key_tiles_full<kKeys>(a, w0);
  const int2 range[2] = {keys_kept(a, r0), keys_kept(a, r1)};
  const float scale_log2 = a.scale * kLog2e;
  // descriptors: the warpgroup's rows of Q; K of ring slot 0 K-major, V
  // of ring slot 0 MN-major
  const uint64_t d_q = hopper::desc_k(base + L::kOwnA, L::kOwnRows, 64 * cw, 0);
  const uint64_t d_k = hopper::desc_k(base + L::kRing, kKeys, 0, 0);
  const uint64_t d_v = hopper::desc_mn(base + L::kRing + L::kStreamTile, kKeys, 0);
  const int last = tiles.y + 1;  // the loop's P.V-only step

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m2[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float corr[2] = {1.f, 1.f};  // the last softmax's factor, due on O before its P.V
  float s[kKeys / 2];
  uint32_t pa[kKeys / 16][4];  // the previous tile's P, as A fragments
  hopper::mbar_wait(own, 0);
  CLK_ADD(8, t_life);
  RING_SKEW(0, -1);

  int stage = 0, prev = -1;  // prev: the previous tile's slot (-1: none)
  uint32_t phase = 0;
  bool pv_due = false;  // the previous tile was live: its P.V is due
  for (int kt = tiles.x; kt <= last; ++kt) {
    const bool streamed = kt < last, s_due = streamed && in(kt, live);
    CLK(t0_clk);
    CLK_GAP(9, t0_clk);
    if (streamed) {
      RING_SKEW(1, kt);
      hopper::mbar_wait(full + 8 * stage, phase);
    }
    CLK_ADD(0, t0_clk);
    CLK(t2_clk);
    // S = Q.K^T of this tile, then, as a second group, O = O corr + P.V of
    // the previous one (O rescaled while S runs)
    hopper::wgmma_fence();
    if (s_due) product_ss<D, kKeys, L::kOwnRows>(s, d_q, hopper::desc_advance(d_k, stage * L::kStageBytes));
    hopper::wgmma_commit();
    if (kPv && pv_due) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      hopper::wgmma_fence();
      product_rs<D, kKeys>(o, pa, hopper::desc_advance(d_v, prev * L::kStageBytes));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);
    CLK_ADD(1, t2_clk);
    CLK(t3_clk);
    if (kSoftmax && s_due) {
      if (in(kt, unmasked)) {
        online_softmax<false>(s, range, kKeys * kt + 2 * t, scale_log2, m2, l, corr);
      } else {
        online_softmax<true>(s, range, kKeys * kt + 2 * t, scale_log2, m2, l, corr);
      }
    }
    CLK_ADD(2, t3_clk);
    CLK(t4_clk);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    keep_regs(pa);
    CLK_ADD(3, t4_clk);
    CLK(t5_clk);
    if (prev >= 0) {  // the previous tile's slot is read for good
      RING_SKEW(2, kt);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + 8 * prev);
    }
    CLK_ADD(7, t5_clk);
    CLK(t6_clk);
    if (s_due) {
      pack_a<kKeys>(pa, s);
      CLK_TILE();
    }
    CLK_ADD(11, t6_clk);
    CLK_MARK();
    pv_due = s_due;
    prev = streamed ? stage : -1;
    if (streamed && ++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  auto* out = static_cast<__nv_bfloat16*>(a.out) + static_cast<size_t>(bh) * a.sq * D;
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < a.sq)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r0) * D + col) =
          pack_f32(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (r1 < a.sq)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r1) * D + col) =
          pack_f32(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
  if (t == 0) {
    float* lse = a.lse + static_cast<size_t>(bh) * a.sq;
    if (r0 < a.sq) lse[r0] = finish_lse(m2[0] * kLn2, l[0]);
    if (r1 < a.sq) lse[r1] = finish_lse(m2[1] * kLn2, l[1]);
  }
  CLK_FLUSH();
}


// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------

// keys of a streamed f32 tile: 32 where a warp's O takes 32 registers a
// thread or more (S's then halve), else 64
template <int D, int MT>
__host__ __device__ constexpr int f32_keys() {
  return D * MT >= 64 ? 32 : 64;
}
// blocks an SM the compiler must leave registers for (O and S take D MT /
// 2 + KT MT / 2 a thread): four of 128 threads for one m-tile at D <= 64,
// three for two, two at D 128 (as many as shared memory holds; no spills:
// 121, 164 and 200 registers at D 64, 64 and 128, kernel_report.py)
template <int D, int MT>
__host__ __device__ constexpr int f32_min_blocks() {
  return D == 128 ? 2 : MT == 2 ? 3 : 4;
}
// Padded row strides in floats. A warp reads K as 8-byte pairs, one row
// for each g of a half-warp (g * stride mod 32 distinct multiples of 8:
// stride = 8 mod 32), and V as words two rows apart, rows 2t (2t stride
// mod 32 distinct multiples of 8: stride = 4 mod 16): no bank conflicts.
template <int D>
__host__ __device__ constexpr int f32_k_stride() {
  return D + 8;
}
template <int D>
__host__ __device__ constexpr int f32_v_stride() {
  return D + 4;
}
template <int D, int MT>
__host__ __device__ constexpr int f32_stage_floats() {
  return f32_keys<D, MT>() * (f32_k_stride<D>() + f32_v_stride<D>());
}
// Shared memory of a block, in floats: its Q rows (16 MT a warp, of at
// most kF32Warps warps; stride f32_k_stride, read as K is), then the two
// K/V stages.
template <int D, int MT>
__host__ __device__ constexpr int f32_q_floats() {
  return 16 * MT * kF32Warps * f32_k_stride<D>();
}
template <int D, int MT>
__host__ __device__ constexpr int f32_smem_bytes() {
  return (f32_q_floats<D, MT>() + 2 * f32_stage_floats<D, MT>()) * 4;
}

// One tile's online softmax over a thread's fragments of S [16 x KT] (rows
// g and g + 8 of its warp: elements e / 2 of s[nb][e], keys k0 + 8 nb + 2t
// + e % 2): with kMasked, each score outside its row's kept range is
// -inf (raises no maximum, P 0). m: the rows' running maxima of q.k; l:
// this thread's share of their sums; corr: the factor that moves what was
// summed onto the new maxima; P = 2^((s - m) scale log2e) in place of S.
template <int NB, bool kMasked>
__device__ __forceinline__ void online_softmax_f32(float (&s)[NB][4], const int2 (&range)[2],
                                                   int col0, float scale_log2, float (&m)[2],
                                                   float (&l)[2], float (&corr)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMasked) {
        const int col = col0 + 8 * nb + (e & 1);
        const int2 r = range[e >> 1];
        s[nb][e] = (col >= r.x) & (col <= r.y) ? s[nb][e] : -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
    }
  }
  float m2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    corr[r] = exp2_approx((m[r] - mn) * scale_log2);
    m[r] = mn;
    m2[r] = mn * scale_log2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nb][e] = exp2_approx(fmaf(s[nb][e], scale_log2, -m2[e >> 1]));
      sum[e >> 1] += s[nb][e];
    }
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

// One block: blockDim.x / 32 warps of 16 MT query rows (MT m-tiles of 16)
// of query row bh; its Q rows in shared memory, copied with the first live
// K/V tile, and the live K/V tiles of KT keys double-buffered in shared
// memory by cp.async (tile kt + 1 copied while tile kt is computed). Each
// warp computes S = Q.K^T and O += P.V of its rows with mma.sync m16n8k8
// in 3xTF32; each B fragment, loaded and split once, feeds the products of
// all MT m-tiles. The k index of both products is permuted so that no
// fragment changes hands: k-slot t of a k-step holds column 2t and slot t
// + 4 column 2t + 1, so the S accumulator's elements (rows g, g + 8;
// columns 2t, 2t + 1) are the A fragment of P as they stand, Q's and K's
// fragments load as 8-byte pairs, and V's B fragment reads rows 2t and
// 2t + 1.
template <int D, int MT>
__global__ void __launch_bounds__(128, f32_min_blocks<D, MT>()) flash_fwd_f32(Args a) {
  constexpr int KT = f32_keys<D, MT>(), KS = f32_k_stride<D>(), VS = f32_v_stride<D>();
  constexpr int NB = KT / 8;  // 8-key column blocks of S, k-steps of P.V
  constexpr int DK = D / 8;   // k-steps of S, 8-column blocks of O
  constexpr int kStage = f32_stage_floats<D, MT>(), kQ = f32_q_floats<D, MT>();
  extern __shared__ __align__(16) float smem_f32[];

  const int bm = 16 * MT * (blockDim.x >> 5);  // query rows of the block
  const int n_own = (a.sq + bm - 1) / bm;
  int bh, rank;
  block_tile(n_own, bh, rank);
  const int q0 = (n_own - 1 - rank) * bm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w0 = q0 + 16 * MT * warp;  // the warp's first row; m-tile m's row g: w0 + 16 m + g

  // the key tiles live for the block's rows, [t_lo, t_hi] (whole tiles out
  // of the causal or window band skipped: they would add P = 0, scale by 1)
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
  int2 range[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int m0 = w0 + 16 * m, ml = min(m0 + 15, a.sq - 1);
    fx[m] = 0;
    fy[m] = a.sk - 1;
    if (a.causal) {
      fy[m] = min(fy[m], a.q_off + m0 - a.k_off);
      if (a.window > 0) fx[m] = a.q_off + ml - a.window + 1 - a.k_off;
    }
    range[m][0] = keys_kept(a, m0 + g);
    range[m][1] = keys_kept(a, m0 + g + 8);
  }
  const float scale_log2 = a.scale * kLog2e;

  const float* qg = static_cast<const float*>(a.q) + static_cast<size_t>(bh) * a.sq * D;
  const size_t kv_row = static_cast<size_t>(bh / a.group) * a.sk * D;
  const float* kg = static_cast<const float*>(a.k) + kv_row;
  const float* vg = static_cast<const float*>(a.v) + kv_row;
  float* qs = smem_f32;  // the block's Q rows
  float* stages = smem_f32 + kQ;
  // tile kt into stage `buf`: its rows up to the next multiple of 8 past
  // Sk (those past Sk zero-filled), 16 bytes a copy; one commit group
  auto load = [&](int kt, int buf) {
    float* ks = stages + buf * kStage;
    float* vs = ks + KT * KS;
    const int k0 = kt * KT, rows = min(KT, (a.sk - k0 + 7) & ~7);
    for (int i = threadIdx.x; i < (kNoLoad ? 0 : rows * (D / 4)); i += blockDim.x) {
      const int row = i / (D / 4), col = 4 * (i % (D / 4));
      const bool ok = k0 + row < a.sk;
      const size_t off = ok ? static_cast<size_t>(k0 + row) * D + col : 0;
      cp_async16(ks + row * KS + col, kg + off, ok);
      cp_async16(vs + row * VS + col, vg + off, ok);
    }
    cp_async_commit();
  };

  float o[MT][DK][4];  // O: rows g (0, 1) and g + 8 (2, 3), columns 8 nb + 2t + e % 2
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nb = 0; nb < DK; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[m][nb][e] = 0.f;
  float mx[MT][2], l[MT][2];  // the rows' running maxima of q.k, this thread's share of their sums
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    mx[m][0] = mx[m][1] = kNeg;
    l[m][0] = l[m][1] = 0.f;
  }

  if (t_lo <= t_hi) {  // the block's Q rows (past Sq zero-filled) and tile t_lo
    PROBE_POISON(smem_f32, kQ + kStage);
    for (int i = threadIdx.x; i < (kNoLoad ? 0 : bm * (D / 4)); i += blockDim.x) {
      const int row = i / (D / 4), col = 4 * (i % (D / 4));
      const bool ok = q0 + row < a.sq;
      cp_async16(qs + row * KS + col, qg + (ok ? static_cast<size_t>(q0 + row) * D + col : 0), ok);
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
    const float* vs = ks + KT * KS;

    float s[MT][NB][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      // A = Q: a0 (row g) and a1 (row g + 8) hold column 8 kk + 2t, a2 and
      // a3 column 2t + 1, read as K is
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* qr = qs + (w0 - q0 + 16 * m + g) * KS + 8 * kk + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(qr);
        const float2 x1 = *reinterpret_cast<const float2*>(qr + 8 * KS);
        const float qf[4] = {x0.x, x1.x, x0.y, x1.y};
        tf32_split4(qf, ah[m], al[m]);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb < lo8 || nb >= hi8) continue;
        // B = K^T: k-slots t, t + 4 are key 8 nb + g's columns 8 kk + 2t, + 1
        const float2 b = *reinterpret_cast<const float2*>(ks + (8 * nb + g) * KS + 8 * kk + 2 * t);
        const Tf32Pair b0 = tf32_split(b.x), b1 = tf32_split(b.y);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_3xtf32(s[m][nb], ah[m], al[m], b0, b1);
      }
    }

#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float corr[2] = {1.f, 1.f};  // FLASH_FWD_NO_SOFTMAX: P is S as it is
      if (kSoftmax && fx[m] <= k0 && k0 + KT - 1 <= fy[m]) {
        online_softmax_f32<NB, false>(s[m], range[m], k0 + 2 * t, scale_log2, mx[m], l[m], corr);
      } else if (kSoftmax) {
        online_softmax_f32<NB, true>(s[m], range[m], k0 + 2 * t, scale_log2, mx[m], l[m], corr);
      }
#pragma unroll
      for (int nb = 0; nb < DK; ++nb) {
        o[m][nb][0] *= corr[0];
        o[m][nb][1] *= corr[0];
        o[m][nb][2] *= corr[1];
        o[m][nb][3] *= corr[1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      if (!kPv || kk < lo8 || kk >= hi8) continue;  // P is 0 there
      // A = P: k-slot t is key 8 kk + 2t (s[kk][0], row g; s[kk][2], row
      // g + 8), slot t + 4 key 2t + 1 (s[kk][1], s[kk][3])
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float pf[4] = {s[m][kk][0], s[m][kk][2], s[m][kk][1], s[m][kk][3]};
        tf32_split4(pf, ph[m], pl[m]);
      }
      const float* vr = vs + (8 * kk + 2 * t) * VS + g;
#pragma unroll
      for (int nb = 0; nb < DK; ++nb) {
        const Tf32Pair b0 = tf32_split(vr[8 * nb]), b1 = tf32_split(vr[VS + 8 * nb]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // O takes the k-step's products by a float add (round to nearest),
          // not as their accumulator (the tensor cores' sums truncate)
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(c, ph[m], pl[m], b0, b1);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[m][nb][e] += c[e];
        }
      }
    }
  }

  if (!w_live) return;
  float* out = static_cast<float*>(a.out) + static_cast<size_t>(bh) * a.sq * D;
  float* lse = a.lse + static_cast<size_t>(bh) * a.sq;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = w0 + 16 * m + g, r1 = r0 + 8;
    l[m][0] = quad_sum(l[m][0]);
    l[m][1] = quad_sum(l[m][1]);
    const float d0 = fmaxf(l[m][0], 1e-30f), d1 = fmaxf(l[m][1], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < DK; ++nb) {
      const int col = 8 * nb + 2 * t;
      if (r0 < a.sq)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r0) * D + col) =
            make_float2(o[m][nb][0] / d0, o[m][nb][1] / d0);
      if (r1 < a.sq)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r1) * D + col) =
            make_float2(o[m][nb][2] / d1, o[m][nb][3] / d1);
    }
    if (t == 0) {
      if (r0 < a.sq) lse[r0] = finish_lse(mx[m][0] * a.scale, l[m][0]);
      if (r1 < a.sq) lse[r1] = finish_lse(mx[m][1] * a.scale, l[m][1]);
    }
  }
}

template <int D, int MT>
int launch_f32(const Args& a, int bh, int nw, cudaStream_t s) {
  const dim3 grid(bh * ((a.sq + 16 * MT * nw - 1) / (16 * MT * nw)));
  constexpr int bytes = f32_smem_bytes<D, MT>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_f32<D, MT><<<grid, 32 * nw, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a, int bh, cudaStream_t s) {
  const F32Shape sh = f32_shape(bh, a.sq, D <= 64 ? 2 : 1);  // two m-tiles a warp at D <= 64
  if constexpr (D <= 64) {
    if (sh.mt == 2) return launch_f32<D, 2>(a, bh, sh.warps, s);
  }
  return launch_f32<D, 1>(a, bh, sh.warps, s);
}

// The card's mma.sync m16n8k8 TF32 rate, for benchmarks/flash_ab.py: each
// warp issues `iters` rounds of eight independent products (no shared
// memory, no other work); the sums go to sink[block] so that none is dead.
__global__ void __launch_bounds__(128) tf32_mma_rate(float* sink, int iters) {
  uint32_t a[4], b0 = __float_as_uint(1e-3f), b1 = __float_as_uint(2e-3f);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.f + threadIdx.x + i);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(d[j], a, b0, b1);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (sum == 12345.f) sink[blockIdx.x] = sum;
}

template <int D>
int launch(const Args& a, int bh, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    TmaArgs p{};
    p.a = a;
    const int kvn = bh / a.group, sk = a.sk > 0 ? a.sk : 1;
    using L = FwdLayout<D>;
    if (!hopper::map_bf16_rows(&p.q, a.q, D, a.sq, bh, L::kOwnRows) ||
        !hopper::map_bf16_rows(&p.k, a.k, D, sk, kvn, kKeys) ||
        !hopper::map_bf16_rows(&p.v, a.v, D, sk, kvn, kKeys))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(bh * ((a.sq + L::kOwnRows - 1) / L::kOwnRows));
    return launch_ring<flash_fwd_bf16<D>, L>(grid, p, s);
  }
  return launch_f32<D>(a, bh, s);
}

}  // namespace

// (FLASH_FWD_CLOCKS) the consumer cycle sums of the launches since the
// last call, then zeros
CLOCKS_ENTRY(flash_fwd_clocks)

// `blocks` blocks of 4 warps, each warp 8 iters mma.sync m16n8k8 TF32
// products (2,048 FLOP each), for benchmarks/flash_ab.py
extern "C" int flash_fwd_tf32_mma_rate(float* sink, int blocks, int iters, void* stream) {
  tf32_mma_rate<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(sink, iters);
  return static_cast<int>(cudaGetLastError());
}

#ifdef FLASH_FWD_RACE_PROBE
extern "C" int flash_fwd_probe_seed(unsigned seed) {
  return static_cast<int>(cudaMemcpyToSymbol(flash::probe_seed, &seed, sizeof(seed)));
}
#endif

// C entry point for ctypes. dtype: 0 float32, 1 bfloat16; d: 64 or 128,
// and for float32 also 16 or 32 (the f32 kernel is generic in D; the
// small LMs of the serve CLI's decode lane have heads of 16); window 0: none. Returns the CUDA error code of the launch (0 on
// success, cudaErrorInvalidValue for a head dim or dtype it is not built
// for), or hopper::kRegsRefused + r for a bf16 kernel compiled to r
// registers a thread, which it does not launch; the Python wrapper raises
// on anything but 0.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                float* lse, int bh, int sq, int sk, int d, int group,
                                int q_off, int k_off, int causal, int window, float scale,
                                int dtype, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  const bool wide = d == 64 || d == 128, narrow = d == 16 || d == 32;
  if (!(dtype == 1 ? wide : dtype == 0 && (wide || narrow)) || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, lse, sq, sk, group, q_off, k_off, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_f32<16>(a, bh, s);
    case 32: return launch_f32<32>(a, bh, s);
    case 64: return launch<64>(a, bh, dtype, s);
    default: return launch<128>(a, bh, dtype, s);
  }
}
