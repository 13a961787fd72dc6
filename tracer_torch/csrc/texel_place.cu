// Dense (T, 4) segment sum of a sorted (texel id, texel cotangent) stream:
// the backward of the texture lookups' texel gathers
// (tracer_torch/render/texture.py::_GatherTexels), for the environment map
// and plane textures alike.
//
// Replaces no Pallas TPU kernel: the JAX package leaves the backward of its
// gathers (tracer/render/texture.py) to XLA. It was added because PyTorch's
// backward of an advanced-index gather, index_put_(accumulate=True), sorts
// the indices and then sums each texel's duplicates in one serial loop: the
// W9 E1 path gradient's lookups put 4 taps x 262,144 lanes a bounce onto
// the 2,048 texels of a 32x64 map, the first bounce's camera rays on far
// fewer, so each texel's sum was a chain of thousands of dependent adds.
// Plain C interface, loaded with ctypes from
// tracer_torch/kernels/texel_place.py, which also holds the plain-PyTorch
// twin (place_reference) and CHUNK_ROWS (256; 32 and 512 are compiled for
// the card tests; any other length is refused).
//
// Contract: ids (m,) i32 ascending flat texel ids y * W + x; vals (m, 4)
// f32 row-major, one texel's four channels (the alpha channel too: an RGBE
// map's exponent gets its gradient); out (t, 4) f32; rows with ids outside
// [0, t) add nothing.
//
// The design is B2's (scatter_vn.cu), at a row width of 4: segment_sum.cuh's
// two passes and fixed order (chunks of R rows, each texel's rows in stream
// order within a chunk from 0.0f, then its chunk partials in chunk order
// from 0.0f), with no atomics, so the twin agrees bit for bit and two
// launches agree bit for bit. A row is one 16-byte load. The table never
// sits in shared memory, so a published-size map (luxo_pxr_campus) is
// served as the 32x64 stand-in is.
//
// What bounds it on an H100: bytes. The stream is m * 20 bytes (4 of id, 16
// of payload) and the output t * 16: 21 MB for one W9 E1 lookup's 1,048,576
// rows, 6.3 us at the data sheet's 3.35 TB/s. The skew sets the passes'
// work: a 262,144-row segment is summed as 256-row runs in pass 1 and ~1,024
// chunk partials in pass 2.
//
// The kernels' names hold "texel_place_" and not B2's "_sums_kernel", so a
// profiler's time by name keeps the two placements apart.

#include <cuda_runtime.h>

#include "segment_sum.cuh"

namespace {

constexpr int kCols = 4;

// Pass 1 for chunks of R rows, one thread per row.
template <int R>
__global__ void __launch_bounds__(R)
    texel_place_chunk_kernel(const int* __restrict__ ids,
                             const float* __restrict__ vals, float* __restrict__ out,
                             float* __restrict__ head, float* __restrict__ tail,
                             long long m, int v) {
  segsum::chunk_pass<R, kCols>(ids, vals, out, head, tail, m, v);
}

__global__ void __launch_bounds__(segsum::kSpanThreads)
    texel_place_span_kernel(const int* __restrict__ ids,
                            const float* __restrict__ head,
                            const float* __restrict__ tail, float* __restrict__ out,
                            int rows, long long n_chunks, int v) {
  segsum::span_pass<kCols>(ids, head, tail, out, rows, n_chunks, v);
}

struct Kernels {
  template <int R>
  static void chunk(unsigned grid, cudaStream_t s, const int* ids, const float* vals,
                    float* out, float* head, float* tail, long long m, int v) {
    texel_place_chunk_kernel<R><<<grid, R, 0, s>>>(ids, vals, out, head, tail, m, v);
  }
  static void span(unsigned grid, cudaStream_t s, const int* ids, const float* head,
                   const float* tail, float* out, int rows, long long n_chunks, int v) {
    texel_place_span_kernel<<<grid, segsum::kSpanThreads, 0, s>>>(ids, head, tail, out, rows,
                                                                    n_chunks, v);
  }
};

}  // namespace

// Clears out and launches both passes on `stream`; returns the first error.
// ids (m,) i32 sorted, vals (m, 4) f32 (16-byte aligned), out (t, 4) f32,
// head and tail (max(1, ceil(m / chunk_rows)), 4) f32 scratch; all
// contiguous. chunk_rows: 256 (CHUNK_ROWS), 32 or 512; any other length
// returns cudaErrorInvalidValue before any work.
extern "C" int texel_place_launch(const int* ids, const float* vals, float* out,
                                  float* head, float* tail, long long m, long long t,
                                  int chunk_rows, void* stream) {
  return segsum::launch<kCols, Kernels>(ids, vals, out, head, tail, m, t, chunk_rows, stream);
}
