// The sorted segmented sum of the port's placement kernels, written once:
// a sorted (id, payload row) stream of m rows of C floats summed into a
// dense (v, C) table, in a fixed order and with no atomics. scatter_vn.cu
// (kernel B2, the vertex cotangents: C = 6) and texel_place.cu (the
// environment's and plane textures' texel cotangents: C = 4) each define
// their two kernels, under names of their own, around the two passes here
// and launch them through `launch`.
//
// Contract: ids (m,) i32 ascending; vals (m, C) f32 row-major, 16-byte
// aligned; out (v, C) f32; head and tail (max(1, ceil(m / R)), C) f32
// scratch; all contiguous. Rows with ids outside [0, v) add nothing.
//
// Order of the additions (fixed; independent of the launch geometry):
//   * the stream is cut into chunks of R rows (the last one shorter);
//   * within a chunk, each id's rows are summed in stream order from 0.0f:
//     one partial per (id, chunk) that the id has rows in;
//   * out[j] is id j's partials summed in chunk order from 0.0f, and 0
//     where no row has id j.
// A segment inside one chunk sums exactly as a plain sequential scatter-add
// would; only segments that cross a chunk edge are associated differently.
// The twins reproduce this order with two index_add_ calls on the CPU
// (tracer_torch/kernels/segment_sum.py::chunk_order_sum), so kernel and
// twin agree bit for bit, and two launches agree bit for bit: out is
// cleared by one memset, then each named id is written exactly once.
//
// Why two passes: a skewed stream holds segments of 10^5 rows and more (a
// missed lane fetches triangle 0; the camera rays of a path's first bounce
// crowd onto a few texels of the environment), and a sum in plain stream
// order is a chain of that many dependent adds. The passes cut every chain
// to at most R + ceil(L / R) adds:
//   * pass 1 (`chunk_pass`), one CTA of R threads per chunk: 16-byte loads
//     stage the chunk in shared memory; per-warp ballots mark where each
//     in-chunk run of one id ends, and the thread at a run's first row sums
//     the run (at most R rows, from shared memory, with a known trip count)
//     and writes it straight to out when the segment lies wholly inside the
//     chunk, else to the chunk's head or tail partial;
//   * pass 2 (`span_pass`), one CTA per chunk edge: the edge where a
//     segment first crosses into the next chunk finds the segment's last
//     chunk with one parallel probe of the chunk heads per kSpanThreads
//     chunks, stages its partials in shared memory and adds them in chunk
//     order, one thread per column, or adds its two partials at once when
//     the segment ends in the next chunk; every other edge's CTA exits
//     after reading its ids.
// Neither pass holds the table in shared memory, so v is bounded by int
// only, not by the SM.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace segsum {

constexpr int kSpanThreads = 256;  // pass 2: chunk heads probed per step

// Pass 1 for chunks of R rows of C columns, one thread per row.
template <int R, int C>
__device__ __forceinline__ void chunk_pass(const int* __restrict__ ids,
                                           const float* __restrict__ vals,
                                           float* __restrict__ out,
                                           float* __restrict__ head,
                                           float* __restrict__ tail,
                                           long long m, int v) {
  static_assert(R % 32 == 0 && R <= 1024, "one warp-aligned CTA per chunk");
  static_assert(C % 2 == 0, "rows are read as float2 pairs");
  __shared__ __align__(16) float s_vals[R * C];
  __shared__ int s_ids[R];
  __shared__ unsigned run_ends[R / 32];  // bit t: row t ends its run in the chunk

  const int t = threadIdx.x;
  const long long c = blockIdx.x;
  const long long base = c * R;
  const int n = static_cast<int>(min(static_cast<long long>(R), m - base));

  // Stage the chunk: the payload with 16-byte loads (a chunk starts at a
  // multiple of R * C * 4 bytes, and R is a multiple of 32), then the ids.
  // The loops stay rolled: unrolled for a fixed R, they hold their loads in
  // flight in registers (48 per thread at R = 256, C = 6, against 31
  // rolled, and a slower pass on an H100; `b2_turns.py` times it).
  const float* src = vals + base * C;
  const int n4 = n * C / 4;
#pragma unroll 1
  for (int i = t; i < n4; i += R) {
    reinterpret_cast<float4*>(s_vals)[i] =
        __ldg(reinterpret_cast<const float4*>(src) + i);
  }
#pragma unroll 1
  for (int i = n4 * 4 + t; i < n * C; i += R) s_vals[i] = __ldg(src + i);
  if (t < n) s_ids[t] = __ldg(ids + base + t);
  __syncthreads();

  const int id = t < n ? s_ids[t] : 0;
  const int prev = t > 0 ? (t < n ? s_ids[t - 1] : 0)
                         : (base > 0 ? __ldg(ids + base - 1) : INT_MIN);
  const bool last = t < n && (t == n - 1 || s_ids[t + 1] != id);
  const unsigned ends = __ballot_sync(0xffffffffu, last);
  if ((t & 31) == 0) run_ends[t >> 5] = ends;
  __syncthreads();
  if (t < n && (t == 0 || prev != id)) {
    // The first row of this chunk's run of `id`: find the run's end, then
    // sum it in order (a known trip count, so the loads run ahead).
    int w = t >> 5;
    unsigned bits = run_ends[w] & (0xffffffffu << (t & 31));
    while (bits == 0) bits = run_ends[++w];
    const int e = (w << 5) + __ffs(bits);  // one past the run's last row
    float a[C];
#pragma unroll
    for (int j = 0; j < C; ++j) a[j] = 0.0f;
#pragma unroll 4
    for (int i = t; i < e; ++i) {
      const float2* row = reinterpret_cast<const float2*>(s_vals + i * C);
#pragma unroll
      for (int j = 0; j < C / 2; ++j) {
        const float2 p = row[j];
        a[2 * j] = __fadd_rn(a[2 * j], p.x);
        a[2 * j + 1] = __fadd_rn(a[2 * j + 1], p.y);
      }
    }
    const bool from_prev = t == 0 && base > 0 && prev == id;
    const bool to_next = e == n && base + n < m && __ldg(ids + base + n) == id;
    if (id >= 0 && id < v) {
      if (!from_prev && !to_next) {
        float* o = out + static_cast<long long>(id) * C;
#pragma unroll
        for (int j = 0; j < C; ++j) o[j] = __fadd_rn(0.0f, a[j]);
      }
      if (from_prev) {
#pragma unroll
        for (int j = 0; j < C; ++j) head[c * C + j] = a[j];
      }
      if (to_next) {
#pragma unroll
        for (int j = 0; j < C; ++j) tail[c * C + j] = a[j];
      }
    }
  }
}

// Pass 2, one CTA of kSpanThreads threads per chunk edge.
template <int C>
__device__ __forceinline__ void span_pass(const int* __restrict__ ids,
                                          const float* __restrict__ head,
                                          const float* __restrict__ tail,
                                          float* __restrict__ out, int rows,
                                          long long n_chunks, int v) {
  static_assert(C <= kSpanThreads, "one thread per column");
  __shared__ float s_part[kSpanThreads * C];
  const int t = threadIdx.x;
  const long long e = static_cast<long long>(blockIdx.x) + 1;  // edge before chunk e
  const int id = __ldg(ids + e * rows);
  const int before = __ldg(ids + e * rows - 1);
  const int earlier = e >= 2 ? __ldg(ids + (e - 1) * rows - 1) : INT_MIN;
  const int next = e + 1 < n_chunks ? __ldg(ids + (e + 1) * rows) : INT_MIN;
  // Only the first edge that a segment crosses does the work.
  if (id < 0 || id >= v || before != id || earlier == id) return;
  float acc = 0.0f;
  if (t < C) acc = __fadd_rn(acc, tail[(e - 1) * C + t]);
  if (next != id) {  // the segment ends in chunk e
    if (t < C) out[static_cast<long long>(id) * C + t] = __fadd_rn(acc, head[e * C + t]);
    return;
  }
  for (long long k0 = e; k0 < n_chunks; k0 += kSpanThreads) {
    // Chunks k0 .. whose first row is still `id` (a prefix: ids ascend).
    const long long k = k0 + t;
    const bool in = k < n_chunks && __ldg(ids + k * rows) == id;
    const int cnt = __syncthreads_count(in);
    if (in) {
#pragma unroll
      for (int j = 0; j < C; ++j) s_part[t * C + j] = head[k * C + j];
    }
    __syncthreads();
    if (t < C) {
      for (int i = 0; i < cnt; ++i) acc = __fadd_rn(acc, s_part[i * C + t]);
    }
    __syncthreads();
    if (cnt < kSpanThreads) break;
  }
  if (t < C) out[static_cast<long long>(id) * C + t] = acc;
}

// Clears out and launches both passes on `stream`; returns the first error.
// C is the row width; K names the caller's kernels: K::chunk<R>(grid, stream,
// ids, vals, out, head, tail, m, v), which launches pass 1 for chunks of R
// rows, and K::span(grid, stream, ids, head, tail, out, rows, n_chunks, v).
// chunk_rows: 256, 32 or 512, the lengths each caller compiles; any other
// length returns cudaErrorInvalidValue before any work.
template <int C, class K>
int launch(const int* ids, const float* vals, float* out, float* head, float* tail,
           long long m, long long v, int chunk_rows, void* stream) {
  if (chunk_rows != 32 && chunk_rows != 256 && chunk_rows != 512) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (v <= 0) return static_cast<int>(cudaSuccess);
  if (m < 0 || v > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_chunks = (m + chunk_rows - 1) / chunk_rows;
  if (n_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(v) * C * sizeof(float), s);
  if (err != cudaSuccess || n_chunks == 0) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n_chunks);
  const int vi = static_cast<int>(v);
  if (chunk_rows == 32) {
    K::template chunk<32>(grid, s, ids, vals, out, head, tail, m, vi);
  } else if (chunk_rows == 256) {
    K::template chunk<256>(grid, s, ids, vals, out, head, tail, m, vi);
  } else {
    K::template chunk<512>(grid, s, ids, vals, out, head, tail, m, vi);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  K::span(static_cast<unsigned>(n_chunks - 1), s, ids, head, tail, out, chunk_rows, n_chunks,
          vi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segsum
