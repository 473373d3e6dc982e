// segment_sum: the sums of the runs of a sorted segment-id vector, each
// added in entry order from +0.0.
//
// Replaces the summation of jax.ops.segment_sum in the JAX package's linear
// step (parameter_server_tpu/apps/linear/async_sgd.py:1418, :1556, :1560;
// XLA's scatter-add, which the TPU runs as a sorted segment reduction).
// Plain version: ops/segment_sum.py::segment_sum_sorted_ref. The wrapper
// orders the entries by segment with a stable sort first; this kernel adds
// each segment's entries in that order, as the CPU's index_add_ adds them
// in index order, so card and CPU give the same bits, run after run (the
// atomics of index_add_ on the card sum in an order that changes between
// runs).
//
// Bound on the card: bytes (one add an entry). At the headline ministep
// (798,720 entries, 16,384 or 798,720 segments) that is ~7-13 MB,
// 2-4 us at 3.35 TB/s. What the design does about it: one thread an
// entry reads its id and its left neighbour's (coalesced), and only the
// first entry of a segment works: it finds the segment's end by
// exponential search and adds its values 8 loads at a time, so the adds
// of long segments (a frequent key of the CTR data, thousands of entries)
// wait on one add's latency each, not on a load. Segments hold only the
// nonzero entries (the wrapper sorts zeros past the last segment, where
// this kernel drops them), so a batch's padding adds nothing here.
//
// Built with --fmad=false (kernels/__init__.py) and no flush to zero:
// every add rounds as the CPU's does.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

// One thread an entry of the sorted ids; the first entry of each segment
// in [0, segs) sums it into out[segment] (out is zeros beforehand).
__global__ void __launch_bounds__(kThreads) segment_sum_f32(const float* __restrict__ data,
                                                            const int* __restrict__ ids, int n,
                                                            float* __restrict__ out, int segs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int s = ids[i];
  if ((i > 0 && ids[i - 1] == s) || s < 0 || s >= segs) return;
  // the end of the segment: gallop past it, then bisect
  int lo = i + 1, step = 1;
  while (lo + step - 1 < n && ids[lo + step - 1] == s) {
    lo += step;
    step *= 2;
  }
  int hi = min(lo + step - 1, n);  // ids[lo - 1] == s; the end lies in [lo, hi]
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (ids[mid] == s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  float acc = 0.f;
  int j = i;
  for (; j + kUnroll <= lo; j += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = data[j + u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, v[u]);
  }
  for (; j < lo; ++j) acc = __fadd_rn(acc, data[j]);
  out[s] = acc;
}

}  // namespace

// C entry point for ctypes: data float32 [n] and ids int32 [n] sorted
// (non-decreasing), out float32 [segs] zeroed by the caller. Returns the
// CUDA error code of the launch (0 on success); the Python wrapper raises
// on anything else.
extern "C" int segment_sum_launch(const float* data, const int* ids, int n, float* out, int segs,
                                  void* stream) {
  if (n <= 0 || segs <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  segment_sum_f32<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(data, ids, n, out,
                                                                              segs);
  return static_cast<int>(cudaGetLastError());
}
