// Dense (V, 6) segment sum of a sorted (vertex id, corner cotangent) stream:
// the placement step of the backward of the per-hit attribute fetch.
//
// Replaces the Pallas TPU kernel tracer/kernels/scatter_vn.py::segment_place
// (its _kernel), which tracer/geometry/device.py::_scatter_add_vn reaches
// from the custom VJP of fetch_tri_rows. Plain C interface, loaded with
// ctypes from tracer_torch/kernels/scatter_vn.py, which also holds the
// plain-PyTorch twin (segment_place_reference) and CHUNK_ROWS, the chunk
// length that the wrapper passes in here: 256, or 32 or 512, the other
// lengths the card tests run. Each is its own instance of pass 1, built at
// compile time (the chunk's shared-memory stage and the thread count are
// sized by it); any other length is refused.
//
// Contract: ids (m,) i32 ascending; vals (m, 6) f32 row-major (columns: the
// corner cotangent of the vertex xyz, then of the normal xyz); out (v, 6)
// f32; rows with ids outside [0, v) add nothing.
//
// The two passes and their fixed order of additions are segment_sum.cuh's,
// at a row width of 6 (texel_place.cu runs them at 4): chunks of R rows,
// each vertex's rows in stream order within a chunk from 0.0f, then its
// chunk partials in chunk order from 0.0f. The twin reproduces that order,
// so the two agree bit for bit, and two launches agree bit for bit.
//
// The TPU kernel sums each 512-vertex block's slice as a one-hot matmul on
// the MXU, a workaround for the TPU's per-index scatter cost; that fixes no
// order, so the port chose the one above.
//
// What bounds it on an H100: bytes. The stream is m * 28 bytes (4 of id, 24
// of payload) and the output v * 24, 40.7 MB for the dragon's 1,080,000
// corners over 436,260 vertices: 12 us at the data sheet's 3.35 TB/s. The
// stream is skewed, though: a missed lane fetches triangle 0, so each of
// triangle 0's three corners has 124,875 rows at 800x450 (the mean segment
// is 2.5 rows), and a sum in plain stream order is a chain of 124,875
// dependent adds, which no layout of the loads shortens. The two passes cut
// every chain to at most R + ceil(L / R) adds (segment_sum.cuh):
//   * pass 1 (chunk_sums_kernel), one CTA of R threads per chunk, sums each
//     in-chunk run from shared memory;
//   * pass 2 (span_sums_kernel), one CTA per chunk edge, adds a crossing
//     segment's chunk partials in chunk order, one thread per column (~490
//     adds for a 124,875-row segment at R = 256).
// Vertices that no row names keep the memset's zeros: the dragon's stream
// names 77,279 of its 436,260 vertices, so the memset writes the whole
// 10.5 MB table and the passes rewrite 1.9 MB of it.

#include <cuda_runtime.h>

#include "segment_sum.cuh"

namespace {

constexpr int kCols = 6;

// Pass 1 for chunks of R rows, one thread per row.
template <int R>
__global__ void __launch_bounds__(R)
    chunk_sums_kernel(const int* __restrict__ ids,
                      const float* __restrict__ vals, float* __restrict__ out,
                      float* __restrict__ head, float* __restrict__ tail,
                      long long m, int v) {
  segsum::chunk_pass<R, kCols>(ids, vals, out, head, tail, m, v);
}

__global__ void __launch_bounds__(segsum::kSpanThreads)
    span_sums_kernel(const int* __restrict__ ids,
                     const float* __restrict__ head,
                     const float* __restrict__ tail, float* __restrict__ out,
                     int rows, long long n_chunks, int v) {
  segsum::span_pass<kCols>(ids, head, tail, out, rows, n_chunks, v);
}

struct Kernels {
  template <int R>
  static void chunk(unsigned grid, cudaStream_t s, const int* ids, const float* vals,
                    float* out, float* head, float* tail, long long m, int v) {
    chunk_sums_kernel<R><<<grid, R, 0, s>>>(ids, vals, out, head, tail, m, v);
  }
  static void span(unsigned grid, cudaStream_t s, const int* ids, const float* head,
                   const float* tail, float* out, int rows, long long n_chunks, int v) {
    span_sums_kernel<<<grid, segsum::kSpanThreads, 0, s>>>(ids, head, tail, out, rows,
                                                             n_chunks, v);
  }
};

}  // namespace

// Clears out and launches both passes on `stream`; returns the first error.
// ids (m,) i32 sorted, vals (m, 6) f32 (16-byte aligned), out (v, 6) f32,
// head and tail (max(1, ceil(m / chunk_rows)), 6) f32 scratch; all
// contiguous. chunk_rows: 256 (CHUNK_ROWS), 32 or 512; any other length
// returns cudaErrorInvalidValue before any work.
extern "C" int segment_place_launch(const int* ids, const float* vals,
                                    float* out, float* head, float* tail,
                                    long long m, long long v, int chunk_rows,
                                    void* stream) {
  return segsum::launch<kCols, Kernels>(ids, vals, out, head, tail, m, v, chunk_rows, stream);
}
