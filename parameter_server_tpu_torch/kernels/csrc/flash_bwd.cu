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
// No atomics: flash_bwd_dq owns a 64-row query tile and loops over the
// live key tiles; flash_bwd_dkv owns a 64-row key tile and loops over the
// group's query heads and their live query tiles. Each output element is
// summed by one thread in a fixed order, so the gradients are bit-identical
// from run to run. Like the JAX split, both kernels recompute S and dP:
// seven products over the live pairs where the gradients need five.
// Whole 64 x 64 tiles outside the causal or window band are skipped
// (_block_live), so sliding-window training stays O(window) a query; the
// key tail, causality at the global offsets and the window are masked per
// element, and query rows past Sq contribute nothing (the JAX wrapper gives
// them lse = +1e30; here a bounds check).
//
// Bound on the card: operations. At the LM training shape (BH 32, S 8192,
// D 64, bf16, causal) the gradients need 10 D FLOP over each of the 1.074e9
// (query, key) pairs the mask keeps, 6.87e11 FLOP, 0.695 ms at the 989
// TFLOP/s bf16 tensor-core rate; their ~270 MB of inputs and outputs take
// ~0.08 ms at 3.35 TB/s. What the design does about it: the five products
// run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums); P and dS
// stay in registers, their C fragments re-packed as A fragments; each block
// stages its own 64-row tile once and one 64-row tile of the other side per
// step in shared memory. Not yet: wgmma, TMA, a pipelined ring of tiles
// (one tile in flight, loads and math do not overlap), nor a fused kernel
// that shares S and dP between the two gradients.
//
// f32 inputs take two kernels on the CUDA cores (scalar FMA; the tensor
// cores would round the operands to TF32): 4 threads a row, each scoring
// 16 of a tile's 64 columns and owning D/4 gradient columns.
//
// Built with -DFLASH_BWD_RACE_PROBE (a diagnostic build, never the one the
// port runs), shared tiles are NaN before staging and each thread sleeps a
// seeded pseudo-random while at every hand-over through shared memory
// (flash_common.cuh); the gradients must stay bit-identical to the normal
// build's (tests/test_torch_kernels_cuda.py).
#ifdef FLASH_BWD_RACE_PROBE
#define FLASH_RACE_PROBE
#endif
#include "flash_common.cuh"

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
// bf16: tensor cores, 4 warps of 16 rows
// ---------------------------------------------------------------------------

template <int D>
constexpr int bf16_smem_bytes() {
  return 4 * kTile * (D + 8) * 2 + 2 * kTile * 4;
}

// One block: the 64 query rows q0.. of query row bh. Q and dO are staged
// once; per live key tile, K and V.
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(Args a) {
  constexpr int kStride = D + 8;  // smem row, in bf16 (a 16-byte pad)
  extern __shared__ __align__(16) unsigned char smem[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* dos = qs + kTile * kStride;
  auto* ks = dos + kTile * kStride;
  auto* vs = ks + kTile * kStride;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = static_cast<size_t>(bh) * a.sq;
  const size_t kv_row = static_cast<size_t>(bh / a.group) * a.sk * D;
  const auto* k = static_cast<const __nv_bfloat16*>(a.k) + kv_row;
  const auto* v = static_cast<const __nv_bfloat16*>(a.v) + kv_row;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const bool in0 = r0 < a.sq, in1 = r1 < a.sq;
  const int qp0 = a.q_off + r0, qp1 = a.q_off + r1;
  const float lse0 = in0 ? a.lse[q_row + r0] : 0.f, lse1 = in1 ? a.lse[q_row + r1] : 0.f;
  const float c0 = in0 ? a.c[q_row + r0] : 0.f, c1 = in1 ? a.c[q_row + r1] : 0.f;

  PROBE_POISON(qs, 2 * kTile * kStride);
  stage2_bf16<D>(qs, dos, kStride, static_cast<const __nv_bfloat16*>(a.q) + q_row * D,
                 static_cast<const __nv_bfloat16*>(a.dout) + q_row * D, q0, a.sq);
  PROBE_SKEW(0, -1);

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int n_tiles = (a.sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_live(a, q0, k0)) continue;  // uniform over the block
    __syncthreads();  // the previous tile's reads are done (and Q, dO staged)
    PROBE_POISON(ks, 2 * kTile * kStride);
    PROBE_SKEW(1, kt);
    stage2_bf16<D>(ks, vs, kStride, k, v, k0, a.sk);
    __syncthreads();
    PROBE_SKEW(2, kt);

    // S = Q.K^T and dP = dO.V^T: 16 rows x 64 keys, as 8 C fragments of 8 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, qs, kStride, warp * 16, kk * 16);
      load_a(da, dos, kStride, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int off = (n * 8 + g) * kStride + kk * 16 + 2 * t;
        mma_bf16(s[n], qa, *reinterpret_cast<const uint32_t*>(ks + off),
                 *reinterpret_cast<const uint32_t*>(ks + off + 8));
        mma_bf16(dp[n], da, *reinterpret_cast<const uint32_t*>(vs + off),
                 *reinterpret_cast<const uint32_t*>(vs + off + 8));
      }
    }
    // P = exp(S scale - lse) where valid, dS = P (dP - c) scale (in s)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + n * 8 + 2 * t + j;
        const float p0 = in0 && key_valid(a, qp0, kp) ? expf(s[n][j] * a.scale - lse0) : 0.f;
        const float p1 = in1 && key_valid(a, qp1, kp) ? expf(s[n][2 + j] * a.scale - lse1) : 0.f;
        s[n][j] = p0 * (dp[n][j] - c0) * a.scale;
        s[n][2 + j] = p1 * (dp[n][2 + j] - c1) * a.scale;
      }
    }
    // dQ += dS.K: dS's C fragments of keys 16j..16j+15 are the A fragment
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t sa[4] = {pack_f32(s[2 * j][0], s[2 * j][1]), pack_f32(s[2 * j][2], s[2 * j][3]),
                              pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_f32(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* kc = ks + (j * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* col = kc + dn * 8;
        mma_bf16(acc[dn], sa, pack_bf16(col[0], col[kStride]),
                 pack_bf16(col[8 * kStride], col[9 * kStride]));
      }
    }
  }

  auto* dq = static_cast<__nv_bfloat16*>(a.dq) + q_row * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (in0) *reinterpret_cast<uint32_t*>(dq + static_cast<size_t>(r0) * D + col) = pack_f32(acc[dn][0], acc[dn][1]);
    if (in1) *reinterpret_cast<uint32_t*>(dq + static_cast<size_t>(r1) * D + col) = pack_f32(acc[dn][2], acc[dn][3]);
  }
}

// One block: the 64 keys k0.. of K/V row kvh. K and V are staged once; per
// query head of the group and live query tile, Q, dO, lse and c. The
// products run transposed (keys as rows): S^T = K.Q^T, dP^T = V.dO^T.
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(Args a) {
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* vs = ks + kTile * kStride;
  auto* qs = vs + kTile * kStride;
  auto* dos = qs + kTile * kStride;
  auto* lse_s = reinterpret_cast<float*>(dos + kTile * kStride);
  auto* c_s = lse_s + kTile;

  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t kv_row = static_cast<size_t>(kvh) * a.sk * D;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;  // this thread's two keys

  PROBE_POISON(ks, 2 * kTile * kStride);
  stage2_bf16<D>(ks, vs, kStride, static_cast<const __nv_bfloat16*>(a.k) + kv_row,
                 static_cast<const __nv_bfloat16*>(a.v) + kv_row, k0, a.sk);
  PROBE_SKEW(0, -1);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dk[dn][0] = dk[dn][1] = dk[dn][2] = dk[dn][3] = 0.f;
    dv[dn][0] = dv[dn][1] = dv[dn][2] = dv[dn][3] = 0.f;
  }

  const int n_tiles = (a.sq + kTile - 1) / kTile;
  for (int hg = 0; hg < a.group; ++hg) {
    const size_t q_row = (static_cast<size_t>(kvh) * a.group + hg) * a.sq;
    const auto* q = static_cast<const __nv_bfloat16*>(a.q) + q_row * D;
    const auto* dout = static_cast<const __nv_bfloat16*>(a.dout) + q_row * D;
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_live(a, q0, k0)) continue;
      __syncthreads();  // the previous tile's reads are done (and K, V staged)
      PROBE_POISON(qs, 2 * kTile * kStride);
      PROBE_POISON(lse_s, 2 * kTile);
      PROBE_SKEW(1, qt);
      stage2_bf16<D>(qs, dos, kStride, q, dout, q0, a.sq);
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const bool in = q0 + i < a.sq;
        lse_s[i] = in ? a.lse[q_row + q0 + i] : 0.f;
        c_s[i] = in ? a.c[q_row + q0 + i] : 0.f;
      }
      __syncthreads();
      PROBE_SKEW(2, qt);

      // S^T and dP^T: 16 keys x 64 queries, as 8 C fragments of 8 queries
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, ks, kStride, warp * 16, kk * 16);
        load_a(va, vs, kStride, warp * 16, kk * 16);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int off = (n * 8 + g) * kStride + kk * 16 + 2 * t;
          mma_bf16(s[n], ka, *reinterpret_cast<const uint32_t*>(qs + off),
                   *reinterpret_cast<const uint32_t*>(qs + off + 8));
          mma_bf16(dp[n], va, *reinterpret_cast<const uint32_t*>(dos + off),
                   *reinterpret_cast<const uint32_t*>(dos + off + 8));
        }
      }
      // P^T in s, dS^T in dp
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = n * 8 + 2 * t + j;
          const bool in = q0 + qi < a.sq;
          const int q_pos = a.q_off + q0 + qi;
          const float p0 = in && key_valid(a, q_pos, kr0) ? expf(s[n][j] * a.scale - lse_s[qi]) : 0.f;
          const float p1 = in && key_valid(a, q_pos, kr1) ? expf(s[n][2 + j] * a.scale - lse_s[qi]) : 0.f;
          s[n][j] = p0;
          s[n][2 + j] = p1;
          dp[n][j] = p0 * (dp[n][j] - c_s[qi]) * a.scale;
          dp[n][2 + j] = p1 * (dp[n][2 + j] - c_s[qi]) * a.scale;
        }
      }
      // dV += P^T.dO and dK += dS^T.Q over queries 16j..16j+15
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t pa[4] = {pack_f32(s[2 * j][0], s[2 * j][1]), pack_f32(s[2 * j][2], s[2 * j][3]),
                                pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_f32(s[2 * j + 1][2], s[2 * j + 1][3])};
        const uint32_t sa[4] = {pack_f32(dp[2 * j][0], dp[2 * j][1]), pack_f32(dp[2 * j][2], dp[2 * j][3]),
                                pack_f32(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                                pack_f32(dp[2 * j + 1][2], dp[2 * j + 1][3])};
        const int base = (j * 16 + 2 * t) * kStride + g;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const __nv_bfloat16* dc = dos + base + dn * 8;
          const __nv_bfloat16* qc = qs + base + dn * 8;
          mma_bf16(dv[dn], pa, pack_bf16(dc[0], dc[kStride]), pack_bf16(dc[8 * kStride], dc[9 * kStride]));
          mma_bf16(dk[dn], sa, pack_bf16(qc[0], qc[kStride]), pack_bf16(qc[8 * kStride], qc[9 * kStride]));
        }
      }
    }
  }

  auto* dkp = static_cast<__nv_bfloat16*>(a.dk) + kv_row;
  auto* dvp = static_cast<__nv_bfloat16*>(a.dv) + kv_row;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (kr0 < a.sk) {
      *reinterpret_cast<uint32_t*>(dkp + static_cast<size_t>(kr0) * D + col) = pack_f32(dk[dn][0], dk[dn][1]);
      *reinterpret_cast<uint32_t*>(dvp + static_cast<size_t>(kr0) * D + col) = pack_f32(dv[dn][0], dv[dn][1]);
    }
    if (kr1 < a.sk) {
      *reinterpret_cast<uint32_t*>(dkp + static_cast<size_t>(kr1) * D + col) = pack_f32(dk[dn][2], dk[dn][3]);
      *reinterpret_cast<uint32_t*>(dvp + static_cast<size_t>(kr1) * D + col) = pack_f32(dv[dn][2], dv[dn][3]);
    }
  }
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
cudaError_t launch_dq(const Args& a, int bh, int dtype, cudaStream_t s) {
  const dim3 grid((a.sq + kTile - 1) / kTile, bh);
  if (dtype == 1) return launch_one(flash_bwd_dq_bf16<D>, grid, 128, bf16_smem_bytes<D>(), a, s);
  return launch_one(flash_bwd_dq_f32<D>, grid, 256, f32_smem_bytes<D>(), a, s);
}

template <int D>
cudaError_t launch_dkv(const Args& a, int bh, int dtype, cudaStream_t s) {
  const dim3 grid((a.sk + kTile - 1) / kTile, bh / a.group);
  if (dtype == 1) return launch_one(flash_bwd_dkv_bf16<D>, grid, 128, bf16_smem_bytes<D>(), a, s);
  return launch_one(flash_bwd_dkv_f32<D>, grid, 256, f32_smem_bytes<D>(), a, s);
}

bool bad_args(int bh, int d, int dtype, int group) {
  return (d != 64 && d != 128) || (dtype != 0 && dtype != 1) || group < 1 || bh % group != 0;
}

}  // namespace

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
