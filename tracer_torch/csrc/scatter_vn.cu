// Dense (V, 6) segment sum of a sorted (vertex id, corner cotangent) stream:
// the placement step of the backward of the per-hit attribute fetch.
//
// Replaces the Pallas TPU kernel tracer/kernels/scatter_vn.py::segment_place
// (its _kernel), which tracer/geometry/device.py::_scatter_add_vn reaches
// from the custom VJP of fetch_tri_rows. Plain C interface, loaded with
// ctypes from tracer_torch/kernels/scatter_vn.py, which also holds the
// plain-PyTorch twin (segment_place_reference).
//
// Contract: ids (m,) i32 ascending; vals (m, 6) f32 row-major (columns: the
// corner cotangent of the vertex xyz, then of the normal xyz); out (v, 6)
// f32. out[j] is the sum of the rows whose id is j, taken in stream order
// from 0.0f, and 0 where no row has id j; rows with ids outside [0, v) add
// nothing. Every output is written once, so the kernel needs no zeroed
// output, no atomics and no reduction across threads: two launches on the
// same input agree bit for bit, and the result equals a sequential
// scatter-add in stream order (the twin on the CPU) bit for bit.
//
// The TPU kernel sums each 512-vertex block's slice as a one-hot matmul on
// the MXU, a workaround for the TPU's per-index scatter cost. Here one
// thread owns one vertex: two binary searches give its slice [lo, hi) of
// the sorted stream, and it adds the rows in order.
//
// What bounds it on an H100: the stream is m * 28 bytes (4 of id, 24 of
// payload), 30 MB for the dragon's 1,080,000 corners: an estimate of about
// 9 us from the H100 SXM's spec-sheet 3.35 TB/s, not a measured time. The
// segments are heavily skewed, though: every lane of the
// frame is fetched, and a missed lane fetches triangle 0, so each of
// triangle 0's three corners gets one row (of zero payload) per missed
// pixel, 124,875 rows each at 800x450, while the mean segment is 2.5 rows.
// One thread walks such a segment alone, so its serial loop, not
// bandwidth, sets the kernel's time: on an H100 80GB HBM3 at 700 W the
// dragon's stream takes about 17 ms, ~136 ns per row of the longest
// segment, with about one cache line of it in flight at a time. Loading
// rows in batches ahead of their adds did not change that (1 to 32 rows
// gave 14-17 ms; the compiler kept 32 registers). A warp per long segment,
// an SMEM-staged block of vertices, or leaving the missed lanes' zero rows
// out of the stream would remove that tail; it is left for later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

// First index in [lo, hi) whose id is >= key (hi if none).
__device__ __forceinline__ long long lower_bound(const int* __restrict__ ids,
                                                 long long lo, long long hi,
                                                 long long key) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (static_cast<long long>(__ldg(ids + mid)) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    segment_place_kernel(const int* __restrict__ ids,
                         const float2* __restrict__ vals,  // (m, 3) float2
                         float2* __restrict__ out,         // (v, 3) float2
                         long long m, long long v) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= v) return;
  const long long lo = lower_bound(ids, 0, m, j);
  const long long hi = lower_bound(ids, lo, m, j + 1);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f, a4 = 0.0f, a5 = 0.0f;
  for (long long i = lo; i < hi; ++i) {
    const float2 p = __ldg(vals + i * 3);
    const float2 q = __ldg(vals + i * 3 + 1);
    const float2 r = __ldg(vals + i * 3 + 2);
    a0 = __fadd_rn(a0, p.x);
    a1 = __fadd_rn(a1, p.y);
    a2 = __fadd_rn(a2, q.x);
    a3 = __fadd_rn(a3, q.y);
    a4 = __fadd_rn(a4, r.x);
    a5 = __fadd_rn(a5, r.y);
  }
  float2* o = out + j * 3;
  o[0] = make_float2(a0, a1);
  o[1] = make_float2(a2, a3);
  o[2] = make_float2(a4, a5);
}

}  // namespace

// Launches one thread per vertex on `stream` and returns cudaGetLastError().
// ids (m,) i32 sorted, vals (m, 6) f32, out (v, 6) f32; all contiguous, vals
// and out 8-byte aligned.
extern "C" int segment_place_launch(const int* ids, const float* vals,
                                    float* out, long long m, long long v,
                                    void* stream) {
  if (v <= 0) return static_cast<int>(cudaSuccess);
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (v + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_place_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ids, reinterpret_cast<const float2*>(vals),
      reinterpret_cast<float2*>(out), m, v);
  return static_cast<int>(cudaGetLastError());
}
