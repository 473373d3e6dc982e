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
// bit-equal to the plain version (other summation order), so this
// library is built without --fmad=false.
//
// Bound on the card: operations. At the serving prefill (BH = 64, S =
// 2048, D = 64, bf16, causal, K/V shared by groups of 4) attention needs
// the 2,098,176 (query, key) pairs of the causal triangle per head, 34.4
// GFLOP, 34.8 us at the 989 TFLOP/s bf16 tensor-core rate, against 42 MB
// of q/k/v/out/lse, 13 us at 3.35 TB/s. The 528 live 64x64 tiles a head
// compute 3% more, the masked pairs of the diagonal tiles (chip_smoke.py
// measures 0.44 ms on an H100 80GB HBM3 at 700 W, about 13x the bound).
// What the design does about it: the products run on the tensor cores (mma.sync m16n8k16 bf16 with
// f32 accumulation); the scores and P never leave registers (the C
// fragment of Q.K^T is re-packed as the A fragment of P.V); each 64-key
// K/V tile is staged once in shared memory per 64 query rows; whole tiles
// outside the causal or window band are skipped (_block_live), so only
// live tiles are computed. Not yet: wgmma, TMA and a pipelined ring of
// tiles (one tile in flight; loads and math do not overlap), which the
// bound needs.
//
// f32 inputs take a second kernel on the CUDA cores (scalar FMA; the
// tensor cores would round the operands to TF32): 4 threads per query
// row, each scoring 16 of a tile's 64 keys and owning D/4 output columns.
//
// The TPU kernel's transposed [D, Sq] layout and its (8, 128) padding
// were Mosaic's, and its sequential k grid axis is the loop over k tiles
// here.
//
// Built with -DFLASH_FWD_RACE_PROBE (a diagnostic build, never the one the
// port runs), every shared tile is filled with NaN before it is staged and
// each thread sleeps a pseudo-random while (up to ~1 us, seeded by
// `probe_seed`) at every point where threads hand data to one another
// through shared memory. A missing barrier then reads NaN or another
// tile's values; with the barriers right, the output is bit-identical to
// the normal build's, since each thread sums in a fixed order
// (tests/test_torch_kernels_cuda.py holds it so).
#ifdef FLASH_FWD_RACE_PROBE
#define FLASH_RACE_PROBE
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
// bf16: tensor cores
// ---------------------------------------------------------------------------

// One block: 64 query rows of one (batch, head), 4 warps of 16 rows each.
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Args a) {
  constexpr int kStride = D + 8;  // smem row, in bf16 (a 16-byte pad)
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kStride];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const auto* q = static_cast<const __nv_bfloat16*>(a.q) + static_cast<size_t>(bh) * a.sq * D;
  const size_t kv_row = static_cast<size_t>(bh / a.group) * a.sk * D;
  const auto* k = static_cast<const __nv_bfloat16*>(a.k) + kv_row;
  const auto* v = static_cast<const __nv_bfloat16*>(a.v) + kv_row;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const bool in0 = r0 < a.sq, in1 = r1 < a.sq;
  const int qp0 = a.q_off + r0, qp1 = a.q_off + r1;

  uint32_t qa[D / 16][4];  // Q as A fragments, loaded once
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = load_pair(q + static_cast<size_t>(r0) * D + c, in0);
    qa[kk][1] = load_pair(q + static_cast<size_t>(r1) * D + c, in1);
    qa[kk][2] = load_pair(q + static_cast<size_t>(r0) * D + c + 8, in0);
    qa[kk][3] = load_pair(q + static_cast<size_t>(r1) * D + c + 8, in1);
  }
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sum

  const int n_tiles = (a.sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_live(a, q0, k0)) continue;  // uniform over the block
    __syncthreads();  // the previous tile's reads are done
    PROBE_POISON(ks, kTile * kStride);
    PROBE_POISON(vs, kTile * kStride);
    PROBE_SKEW(0, kt);
    stage2_bf16<D>(ks, vs, kStride, k, v, k0, a.sk);
    __syncthreads();
    PROBE_SKEW(1, kt);

    // S = Q.K^T: 16 rows x 64 keys, as 8 C fragments of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * kStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[n], qa[kk], b0, b1);
      }
    }
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + n * 8 + 2 * t + j;
        s[n][j] = key_valid(a, qp0, kp) ? s[n][j] * a.scale : kNeg;
        s[n][2 + j] = key_valid(a, qp1, kp) ? s[n][2 + j] * a.scale : kNeg;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + n * 8 + 2 * t + j;
        s[n][j] = key_valid(a, qp0, kp) ? expf(s[n][j] - mn0) : 0.f;
        s[n][2 + j] = key_valid(a, qp1, kp) ? expf(s[n][2 + j] - mn1) : 0.f;
        ps0 += s[n][j];
        ps1 += s[n][2 + j];
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= c0;
      o[dn][1] *= c0;
      o[dn][2] *= c1;
      o[dn][3] *= c1;
    }
    // O += P.V: P's C fragments of keys 16j..16j+15 are the A fragment
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack_f32(s[2 * j][0], s[2 * j][1]), pack_f32(s[2 * j][2], s[2 * j][3]),
                              pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_f32(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* vc = vs + (j * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* col = vc + dn * 8;
        const uint32_t b0 = pack_bf16(col[0], col[kStride]);
        const uint32_t b1 = pack_bf16(col[8 * kStride], col[9 * kStride]);
        mma_bf16(o[dn], pa, b0, b1);
      }
    }
    m0 = mn0;
    m1 = mn1;
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  auto* out = static_cast<__nv_bfloat16*>(a.out) + static_cast<size_t>(bh) * a.sq * D;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (in0)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r0) * D + c) =
          pack_f32(o[dn][0] / d0, o[dn][1] / d0);
    if (in1)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r1) * D + c) =
          pack_f32(o[dn][2] / d1, o[dn][3] / d1);
  }
  if (t == 0) {
    float* lse = a.lse + static_cast<size_t>(bh) * a.sq;
    if (in0) lse[r0] = finish_lse(m0, l0);
    if (in1) lse[r1] = finish_lse(m1, l1);
  }
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
cudaError_t launch(const Args& a, int bh, int dtype, cudaStream_t s) {
  const dim3 grid((a.sq + kTile - 1) / kTile, bh);
  if (dtype == 1) {
    flash_fwd_bf16<D><<<grid, 128, 0, s>>>(a);
    return cudaGetLastError();
  }
  constexpr int bytes = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_f32<D><<<grid, 256, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

#ifdef FLASH_FWD_RACE_PROBE
extern "C" int flash_fwd_probe_seed(unsigned seed) {
  return static_cast<int>(cudaMemcpyToSymbol(flash::probe_seed, &seed, sizeof(seed)));
}
#endif

// C entry point for ctypes. dtype: 0 float32, 1 bfloat16; d: 64 or 128;
// window 0: none. Returns the CUDA error code of the launch (0 on
// success, cudaErrorInvalidValue for a head dim or dtype it is not built
// for); the Python wrapper raises on anything else.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                float* lse, int bh, int sq, int sk, int d, int group,
                                int q_off, int k_off, int causal, int window, float scale,
                                int dtype, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if ((d != 64 && d != 128) || (dtype != 0 && dtype != 1) || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, lse, sq, sk, group, q_off, k_off, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = d == 64 ? launch<64>(a, bh, dtype, s) : launch<128>(a, bh, dtype, s);
  return static_cast<int>(err);
}
