// segment_sum: the sums of the runs of a grouped segment-id vector, each
// added in entry order from +0.0.
//
// Replaces the summation of jax.ops.segment_sum in the JAX package's linear
// step (parameter_server_tpu/apps/linear/async_sgd.py:1418, :1556, :1560,
// :1643, :1647; XLA's scatter-add, which the TPU runs as a sorted segment
// reduction). Plain versions: ops/segment_sum.py::segment_sum_sorted_ref
// (after the wrapper's stable sort) and segment_sum_runs_ref (ids already
// grouped). The card's sums equal the CPU's index_add_ bit for bit, run
// after run (the atomics of index_add_ on the card sum in an order that
// changes between runs).
//
// What it computes. A run is a maximal block of consecutive entries with
// one id; the head of a run is its first nonzero entry (NaN counts as
// nonzero). For each head whose id s lies in [0, segs), out[s] = the run's
// entries from the head to the run's end, added in entry order from +0.0.
// Zeros change no such sum (a sum from +0.0 that rounds to nearest is never
// -0.0, and x + (+-0.0) == x for every other x), so that is index_add_'s sum
// of segment s whenever all nonzero entries of s lie in one run: the
// contract of the input. A sorted input meets it; so does an input whose
// ids are grouped but whose zeros sit anywhere, such as a batch's rows with
// the padding (row 0, value 0) at the end. A run with no nonzero entry
// writes nothing (out is zeroed by the caller), so such padding costs no
// adds. Entries whose id lies outside [0, segs) are never summed.
//
// Bound on the card. Bytes: ids and nonzero values read once, sums written
// once (~7-13 MB at the headline ministep, 2-4 us at 3.35 TB/s). And a
// serial floor that bit equality imposes: a run's adds depend on each
// other, so the kernel takes at least the longest run of nonzero entries
// times the latency of one dependent f32 add (the CTR data's hot keys:
// 7,452 entries in one segment of a 10,000-row minibatch).
// benchmarks/segment_bytes.py counts both; segment_sum_add_latency below
// measures the latency.
//
// Design. One pass over the ids, by warps that all start at once: the grid
// is one wave of resident blocks, and warp w sweeps a contiguous range of
// 128-entry tiles (16-byte loads of ids and values, 4 entries a lane, the
// next tile's loads in flight while one is worked). Ballots over the tile
// find the run starts and the heads (a segmented OR over the nonzero
// flags; whether the run open at the range's start already holds a nonzero
// entry comes from a look-back over the entries before it, read only once
// a nonzero entry of that run turns up in the range, so that a long run of
// zeros, a batch's padding, is never read back). A run that ends inside
// the lane holding its head is added from that lane's registers; one that
// ends in its tile, by that lane from the tile staged in shared memory
// (all lanes' such runs in one loop, side by side). A run still open at
// the tile's end goes on into the next tile; if it spans that whole tile
// too, it is long: the warp streams it with cp.async 16-byte copies of
// 512-entry chunks (ids and values) into a 2-stage ring in shared memory
// (one chunk lands while lane 0 adds the other, ~2,000 cycles of adds),
// the lanes find where the run ends in each chunk by ballot, and lane 0
// adds the chunk from shared memory, a value each dependent add, the next
// eight quads loaded while eight are added. A warp finishes the run it
// holds past its range's end (a run's sum is never split); the warps whose
// ranges start inside it see its head behind them in the look-back and
// skip it.
//
// Built with --fmad=false (kernels/__init__.py) and no flush to zero:
// every add rounds as the CPU's does.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;                // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 128;               // entries a warp tile: 4 a lane
constexpr int kChunk = 512;              // entries a streamed chunk: 4 quads a lane
constexpr int kStages = 2;               // chunks in a warp's ring
constexpr unsigned kFull = 0xffffffffu;

struct alignas(16) WarpSmem {
  float tile[kTile];
  int ids[kStages][kChunk];
  float vals[kStages][kChunk];
};

__device__ __forceinline__ bool in_range(int s, int segs) {
  return static_cast<unsigned>(s) < static_cast<unsigned>(segs);
}

// entries i..i+3 (id -1 and value 0 past m); i is a multiple of 4
__device__ __forceinline__ void load_quad(const int* __restrict__ ids,
                                          const float* __restrict__ data, long long i,
                                          long long m, int (&id)[4], float (&v)[4]) {
  if (i + 4 <= m) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(ids + i));
    const float4 b = __ldg(reinterpret_cast<const float4*>(data + i));
    id[0] = a.x, id[1] = a.y, id[2] = a.z, id[3] = a.w;
    v[0] = b.x, v[1] = b.y, v[2] = b.z, v[3] = b.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    id[k] = -1;
    v[k] = 0.f;
    if (i + k < m) {
      id[k] = __ldg(ids + i + k);
      v[k] = __ldg(data + i + k);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* src, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// chunk [c, c + kChunk) into ring stage st: a quad of ids and one of values
// in each 128-entry part of the chunk, zero-filled past m
__device__ __forceinline__ void issue_chunk(WarpSmem& sm, int st, const int* ids,
                                            const float* data, long long c, long long m,
                                            int lane) {
#pragma unroll
  for (int h = 0; h < kChunk / 128; ++h) {
    const int off = h * 128 + 4 * lane;
    const long long i = c + off;
    const int bytes = i >= m ? 0 : (i + 4 <= m ? 16 : static_cast<int>(4 * (m - i)));
    cp_async16(&sm.ids[st][off], bytes ? ids + i : ids, bytes);
    cp_async16(&sm.vals[st][off], bytes ? data + i : data, bytes);
  }
}

__device__ __forceinline__ float add4(float acc, float4 t) {
  acc = __fadd_rn(acc, t.x);
  acc = __fadd_rn(acc, t.y);
  acc = __fadd_rn(acc, t.z);
  return __fadd_rn(acc, t.w);
}

// acc + v[0] + ... + v[cnt - 1] (v 16-byte aligned), in order; whole
// groups of 64 with the next eight quads loaded while eight are added
__device__ __forceinline__ float add_chunk(float acc, const float* v, int cnt) {
  if (cnt % 64 == 0) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    float4 a[8], b[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = v4[u];
#pragma unroll 1
    for (int g = 0; g < cnt / 4; g += 16) {
#pragma unroll
      for (int u = 0; u < 8; ++u) b[u] = v4[g + 8 + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = add4(acc, a[u]);
      if (g + 16 < cnt / 4) {
#pragma unroll
        for (int u = 0; u < 8; ++u) a[u] = v4[g + 16 + u];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = add4(acc, b[u]);
    }
    return acc;
  }
#pragma unroll 4
  for (int q = 0; q < cnt; ++q) acc = __fadd_rn(acc, v[q]);
  return acc;
}

// the long run of id s from entry c0 on: lane 0's acc plus its entries up
// to the first entry past m or of another id, whose index is returned (the
// same in every lane)
__device__ long long stream_run(const float* __restrict__ data, const int* __restrict__ ids,
                                long long m, int s, float& acc, long long c0, WarpSmem& sm,
                                int lane) {
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    issue_chunk(sm, st, ids, data, c0 + static_cast<long long>(st) * kChunk, m, lane);
    cp_async_commit();
  }
  long long c = c0;
  for (int st = 0;; st = st + 1 == kStages ? 0 : st + 1, c += kChunk) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
    int first = kChunk;  // the chunk's first entry past the run
#pragma unroll
    for (int h = 0; h < kChunk / 128; ++h) {
      const int off = h * 128 + 4 * lane;
      const int4 q = *reinterpret_cast<const int4*>(&sm.ids[st][off]);
      const int qi[4] = {q.x, q.y, q.z, q.w};
      int loc = 4;
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        if (c + off + k >= m || qi[k] != s) loc = k;
      }
      const unsigned bal = __ballot_sync(kFull, loc < 4);
      if (bal && first == kChunk) {
        const int l = __ffs(bal) - 1;
        first = h * 128 + 4 * l + __shfl_sync(kFull, loc, l);
      }
    }
    if (lane == 0) acc = add_chunk(acc, sm.vals[st], first);
    __syncwarp();
    if (first < kChunk) {
      cp_async_wait<0>();
      __syncwarp();
      return c + first;
    }
    issue_chunk(sm, st, ids, data, c + static_cast<long long>(kStages) * kChunk, m, lane);
    cp_async_commit();
  }
}

// does the run holding entry pos - 1 (id s) hold a nonzero entry at or
// before it? Read back 32 entries at a time until the run starts or a
// nonzero entry turns up (at once, unless zeros lie inside a run).
__device__ bool look_back(const float* __restrict__ data, const int* __restrict__ ids,
                          long long pos, int s, int lane) {
  for (long long i = pos - 1;; i -= 32) {
    const long long j = i - lane;
    bool stop = j < 0, found = false;
    if (j >= 0) {
      if (__ldg(ids + j) != s) {
        stop = true;
      } else if (__ldg(data + j) != 0.f) {
        stop = found = true;
      }
    }
    const unsigned bal = __ballot_sync(kFull, stop);
    if (bal) return __shfl_sync(kFull, found, __ffs(bal) - 1);
  }
}

// Warp w sweeps tiles [w * tiles_per_warp, (w + 1) * tiles_per_warp) and
// finishes the run it holds at the range's end.
__global__ void __launch_bounds__(kThreads)
    segment_sum_f32(const float* __restrict__ data, const int* __restrict__ ids, long long m,
                    float* __restrict__ out, int segs, long long tiles_per_warp) {
  __shared__ WarpSmem smem[kWarps];
  const int lane = threadIdx.x & 31;
  WarpSmem& sm = smem[threadIdx.x >> 5];
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  long long pos = warp * tiles_per_warp * kTile;
  if (pos >= m) return;
  const long long range_end = pos + tiles_per_warp * kTile;

  // the run open before pos: its id, and whether it holds a nonzero entry
  // (known once a nonzero entry of that run turns up here: a run of zeros,
  // such as a batch's padding, is never read back)
  int prev_id = pos > 0 ? __ldg(ids + pos - 1) : -1;
  bool carry = false, carry_known = pos == 0;
  // a run whose head lies in an earlier tile, open at that tile's end
  // (its id the same in every lane, its sum in lane 0)
  bool pending = false;
  int pend_s = 0;
  float pend_acc = 0.f;

  int id[4];
  float v[4];
  load_quad(ids, data, pos + 4 * lane, m, id, v);
  while (pos < m && (pos < range_end || pending)) {
    const long long next = pos + kTile;
    int nid[4];
    float nv[4];
    load_quad(ids, data, next + 4 * lane, m, nid, nv);
    *reinterpret_cast<float4*>(&sm.tile[4 * lane]) = make_float4(v[0], v[1], v[2], v[3]);

    // run starts, and the nonzero flags ORed from each run's start
    int pid = __shfl_up_sync(kFull, id[3], 1);
    if (lane == 0) pid = prev_id;
    bool st[4];
    st[0] = (pos == 0 && lane == 0) || id[0] != pid;
    st[1] = id[1] != id[0];
    st[2] = id[2] != id[1];
    st[3] = id[3] != id[2];
    bool agg = false;  // a nonzero since the lane's last start (or its first entry)
#pragma unroll
    for (int k = 0; k < 4; ++k) agg = (agg && !st[k]) || v[k] != 0.f;
    const unsigned S = __ballot_sync(kFull, st[0] || st[1] || st[2] || st[3]);
    const unsigned A = __ballot_sync(kFull, agg);
    unsigned B[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) B[k] = __ballot_sync(kFull, st[k]);
    int first = kTile;  // the tile's first run start
    if (S) {
      const int l = __ffs(S) - 1;
      first = 4 * l + ((B[0] >> l) & 1u ? 0 : (B[1] >> l) & 1u ? 1 : (B[2] >> l) & 1u ? 2 : 3);
    }
    if (!carry_known) {  // does the run from before hold a nonzero here, before `first`?
      bool early = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) early = early || (v[k] != 0.f && 4 * lane + k < first);
      if (__any_sync(kFull, early)) {
        carry = look_back(data, ids, pos, prev_id, lane);
        carry_known = true;
      }
    }
    // the open run's flag at this lane's first entry, and at the tile's end
    const unsigned below = (1u << lane) - 1u;
    bool seen;
    if (S & below) {
      const int j = 31 - __clz(S & below);
      seen = ((A >> j) & 1u) || (A & below & ~((2u << j) - 1u));
    } else {
      seen = carry || (A & below);
    }
    bool carry_out;
    if (S) {
      const int j = 31 - __clz(S);
      carry_out = ((A >> j) & 1u) || (A & ~((2u << j) - 1u));
    } else {
      carry_out = carry || A;
    }
    bool head[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      seen = seen && !st[k];
      head[k] = v[k] != 0.f && !seen && in_range(id[k], segs);
#ifdef SEGMENT_NO_SUMS  // a diagnostic build (segment_ab.py --variant): the sweep alone
      head[k] = false;
#endif
      seen = seen || v[k] != 0.f;
    }
    __syncwarp();  // the tile is staged

    if (pending && first == kTile) {  // the pending run spans this tile: a long one
      if (lane == 0) pend_acc = add_chunk(pend_acc, sm.tile, kTile);
      const long long e = stream_run(data, ids, m, pend_s, pend_acc, next, sm, lane);
      if (lane == 0) out[pend_s] = pend_acc;
      pending = false;
      pos = e / kTile * kTile;  // go on from the tile where the run ended
      if (pos >= range_end || pos >= m) break;
      prev_id = pend_s;
      carry = carry_known = true;
      load_quad(ids, data, pos + 4 * lane, m, id, v);
      __syncwarp();
      continue;
    }

    // The tile's sums. A run that ends inside its head's lane is added from
    // the lane's registers. The rest, a job a run, go through one loop for
    // all lanes (so the lanes add side by side): lane 0 first ends the
    // pending run (entries [0, first)), then each lane its head whose run
    // leaves the lane; such a run ends at the next start, or goes on past
    // the tile (open).
    unsigned heads = 0, starts = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) starts |= (st[k] ? 1u : 0u) << k;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (pos >= range_end || !head[k]) continue;
      const unsigned rest = starts & ~((2u << k) - 1u);  // starts after entry k in the lane
      if (!rest) {
        heads |= 1u << k;
        continue;
      }
      const int e = __ffs(rest) - 1;
      float acc = 0.f;
#pragma unroll
      for (int j = k; j < 4; ++j) {
        if (j < e) acc = __fadd_rn(acc, v[j]);
      }
      out[id[k]] = acc;
    }
    int next_lane_start = kTile;  // the first start in a later lane
    const unsigned after = S & ~((2u << lane) - 1u);
    if (after) {
      const int l = __ffs(after) - 1;
      next_lane_start =
          4 * l + ((B[0] >> l) & 1u ? 0 : (B[1] >> l) & 1u ? 1 : (B[2] >> l) & 1u ? 2 : 3);
    }
    bool pend_job = pending && lane == 0;
    pending = false;
    bool open = false;
    int open_s = 0;
    float open_acc = 0.f;
    for (;;) {
      int p = 0, e = 0, s = pend_s;
      float acc = pend_acc;
      bool job = true;
      if (pend_job) {
        e = first;
        pend_job = false;
      } else if (heads) {
        const int k = __ffs(heads) - 1;
        heads &= heads - 1;
        p = 4 * lane + k;
        s = k < 2 ? (k == 0 ? id[0] : id[1]) : (k == 2 ? id[2] : id[3]);
        acc = 0.f;
        e = next_lane_start;
      } else {
        job = false;
      }
      if (!__any_sync(kFull, job)) break;
      if (job) {
#pragma unroll 4
        for (int q = p; q < e; ++q) acc = __fadd_rn(acc, sm.tile[q]);
        if (e < kTile) {
          out[s] = acc;
        } else {
          open = true;
          open_s = s;
          open_acc = acc;
        }
      }
    }
    const unsigned O = __ballot_sync(kFull, open);
    if (O) {
      const int l = __ffs(O) - 1;
      pend_s = __shfl_sync(kFull, open_s, l);
      pend_acc = __shfl_sync(kFull, open_acc, l);
      pending = true;
    }
    prev_id = __shfl_sync(kFull, id[3], 31);
    carry = carry_out;
    carry_known = carry_known || S;  // past a start, the open run's flag is this tile's
    __syncwarp();  // every read of the staged tile is done
    pos = next;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      id[k] = nid[k];
      v[k] = nv[k];
    }
  }
  if (pending && lane == 0) out[pend_s] = pend_acc;  // a run that ends with the data
}

// One thread: `adds` dependent __fadd_rn, timed by clock64 and the
// nanosecond global timer.
__global__ void add_latency(const float* in, float* out, long long* t, int adds) {
  float a = in[0];
  const float b = in[1];
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  asm volatile("" : "+f"(a));
#pragma unroll 32
  for (int i = 0; i < adds; ++i) a = __fadd_rn(a, b);
  asm volatile("" : "+f"(a));
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = a;
  t[0] = c1 - c0;
  t[1] = static_cast<long long>(g1 - g0);
}

int resident_warps(int dev) {
  static int cache[64];
  if (dev < 0 || dev >= 64) dev = 0;
  if (cache[dev] == 0) {
    int sms = 0, blocks = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, segment_sum_f32, kThreads, 0);
    cache[dev] = (sms > 0 ? sms : 1) * (blocks > 0 ? blocks : 1) * kWarps;
  }
  return cache[dev];
}

// tiles a warp for n entries: one wave of resident warps, each a
// contiguous range of tiles
long long tiles_per_warp(long long n, int dev) {
  const long long tiles = (n + kTile - 1) / kTile;
  const long long warps = tiles < resident_warps(dev) ? tiles : resident_warps(dev);
  return warps > 0 ? (tiles + warps - 1) / warps : 1;
}

}  // namespace

// C entry point for ctypes: data float32 [n] and ids int32 [n], both
// 16-byte aligned, each segment's nonzero entries in one run of equal ids;
// out float32 [segs] zeroed by the caller. Returns the CUDA error code of
// the launch (0 on success); the Python wrapper raises on anything else.
extern "C" int segment_sum_launch(const float* data, const int* ids, int n, float* out, int segs,
                                  void* stream) {
  if (n <= 0 || segs <= 0) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  const long long tpw = tiles_per_warp(n, dev);
  const long long warps = (tiles + tpw - 1) / tpw;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  segment_sum_f32<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(data, ids, n, out,
                                                                              segs, tpw);
  return static_cast<int>(cudaGetLastError());
}

// The latency of one dependent f32 add: in float32 [2] (the start and the
// addend), out float32 [1], t int64 [2] (clock cycles and nanoseconds of
// `adds` adds). One thread; returns the CUDA error code of the launch.
extern "C" int segment_sum_add_latency(const float* in, float* out, long long* t, int adds,
                                       void* stream) {
  add_latency<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(in, out, t, adds);
  return static_cast<int>(cudaGetLastError());
}
