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
// f32 inputs take a second kernel on the CUDA cores (scalar FMA; the
// tensor cores would round the operands to TF32): 4 threads per query
// row, each scoring 16 of a tile's 64 keys and owning D/4 output columns.
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
// -DFLASH_FWD_CLOCKS counts the consumers' cycles by phase; and builds
// with wrong outputs that time one part alone: -DFLASH_FWD_NO_SOFTMAX,
// -DFLASH_FWD_NO_PV, -DFLASH_FWD_NO_LOAD.
#ifdef FLASH_FWD_RACE_PROBE
#define FLASH_RACE_PROBE
#endif
#ifdef FLASH_FWD_CLOCKS
#define FLASH_RING_CLOCKS
#endif
#ifdef FLASH_FWD_NO_LOAD
#define FLASH_RING_NO_LOAD
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
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int D>
constexpr int f32_smem_bytes() {
  return (kTile * (D + 1) * 2 + kTile * D + kTile * (kTile + 1)) * 4;
}

// One block: 64 query rows, 4 threads a row. Thread c of row r scores
// keys c, c+4, ... of each tile and owns output columns c, c+4, ...
template <int D>
__global__ void __launch_bounds__(256) flash_fwd_f32(Args a) {
  extern __shared__ float smem[];
  constexpr int kQs = D + 1, kKs = D + 1, kPs = kTile + 1;  // padded row strides
  constexpr int kCols = D / 4;
  float* qs = smem;               // [64][D+1]
  float* ks = qs + kTile * kQs;   // [64][D+1]
  float* vs = ks + kTile * kKs;   // [64][D]
  float* ps = vs + kTile * D;     // [64][65]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const float* q = static_cast<const float*>(a.q) + static_cast<size_t>(bh) * a.sq * D;
  const size_t kv_row = static_cast<size_t>(bh / a.group) * a.sk * D;
  const float* k = static_cast<const float*>(a.k) + kv_row;
  const float* v = static_cast<const float*>(a.v) + kv_row;
  PROBE_POISON(qs, kTile * kQs);
  stage_f32<D>(qs, kQs, q, q0, a.sq);
  PROBE_SKEW(0, -1);
  const int qp = a.q_off + q0 + r;
  float o[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) o[i] = 0.f;
  float m = kNeg, l = 0.f;

  const int n_tiles = (a.sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_live(a, q0, k0)) continue;
    __syncthreads();
    PROBE_POISON(ks, kTile * kKs);
    PROBE_POISON(vs, kTile * D);
    PROBE_POISON(ps, kTile * kPs);
    PROBE_SKEW(1, kt);
    stage2_f32<D>(ks, kKs, vs, D, k, v, k0, a.sk);
    __syncthreads();
    PROBE_SKEW(2, kt);

    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * kQs + d];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = fmaf(qv, ks[(c + 4 * i) * kKs + d], s[i]);
    }
    float mx = kNeg;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      s[i] = key_valid(a, qp, k0 + c + 4 * i) ? s[i] * a.scale : kNeg;
      mx = fmaxf(mx, s[i]);
    }
    const float mn = fmaxf(m, quad_max(mx));
    const float corr = expf(m - mn);
    float psum = 0.f;
    PROBE_SKEW(3, kt);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p = key_valid(a, qp, k0 + c + 4 * i) ? expf(s[i] - mn) : 0.f;
      psum += p;
      ps[r * kPs + c + 4 * i] = p;
    }
    l = l * corr + psum;
    __syncwarp();  // a row's 4 threads share one warp
    PROBE_SKEW(4, kt);
    float pv[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) pv[i] = 0.f;
    for (int j = 0; j < kTile; ++j) {
      const float p = ps[r * kPs + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) pv[i] = fmaf(p, vs[j * D + c + 4 * i], pv[i]);
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) o[i] = o[i] * corr + pv[i];
    m = mn;
  }

  l = quad_sum(l);
  if (q0 + r < a.sq) {
    float* out = static_cast<float*>(a.out) + (static_cast<size_t>(bh) * a.sq + q0 + r) * D;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kCols; ++i) out[c + 4 * i] = o[i] / den;
    if (c == 0) a.lse[static_cast<size_t>(bh) * a.sq + q0 + r] = finish_lse(m, l);
  }
}


template <int D>
int launch_f32(const Args& a, int bh, cudaStream_t s) {
  const dim3 grid((a.sq + kTile - 1) / kTile, bh);
  constexpr int bytes = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_f32<D><<<grid, 256, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
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
