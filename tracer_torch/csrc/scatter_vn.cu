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
// Order of the additions (fixed; independent of the launch geometry):
//   * the stream is cut into chunks of R rows (the last one shorter);
//   * within a chunk, each vertex's rows are summed in stream order from
//     0.0f: one partial per (vertex, chunk) that the vertex has rows in;
//   * out[j] is vertex j's partials summed in chunk order from 0.0f, and 0
//     where no row has id j.
// A segment inside one chunk sums exactly as a plain sequential scatter-add
// would; only segments that cross a chunk edge are associated differently.
// The twin reproduces this order with two index_add_ calls on the CPU, so
// the two agree bit for bit, and two launches agree bit for bit: out is
// cleared by one memset, then each named vertex is written exactly once,
// with no atomics.
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
// dependent adds, which no layout of the loads shortens. The design cuts
// every chain to at most R + ceil(L / R) adds:
//   * pass 1 (chunk_sums_kernel), one CTA of R threads per chunk: 16-byte
//     loads stage the chunk in shared memory; per-warp ballots mark where
//     each in-chunk run of one id ends, and the thread at a run's first
//     row sums the run (at most R rows, from shared memory, with a known
//     trip count) and writes it straight to out when the segment lies
//     wholly inside the chunk, else to the chunk's head or tail partial;
//   * pass 2 (span_sums_kernel), one CTA per chunk edge: the edge where a
//     segment first crosses into the next chunk finds the segment's last
//     chunk with one parallel probe of the chunk heads per 256 chunks,
//     stages its partials in shared memory and adds them in chunk order,
//     one thread per column (~490 adds for a 124,875-row segment at
//     R = 256), or adds its two partials at once when the segment ends in
//     the next chunk; every other edge's CTA exits after reading its ids.
// Vertices that no row names keep the memset's zeros: the dragon's stream
// names 77,279 of its 436,260 vertices, so the memset writes the whole
// 10.5 MB table and the passes rewrite 1.9 MB of it.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kCols = 6;
constexpr int kSpanThreads = 256;  // pass 2: chunk heads probed per step

// Pass 1 for chunks of R rows, one thread per row.
template <int R>
__global__ void __launch_bounds__(R)
    chunk_sums_kernel(const int* __restrict__ ids,
                      const float* __restrict__ vals, float* __restrict__ out,
                      float* __restrict__ head, float* __restrict__ tail,
                      long long m, int v) {
  static_assert(R % 32 == 0 && R <= 1024, "one warp-aligned CTA per chunk");
  __shared__ __align__(16) float s_vals[R * kCols];
  __shared__ int s_ids[R];
  __shared__ unsigned run_ends[R / 32];  // bit t: row t ends its run in the chunk

  const int t = threadIdx.x;
  const long long c = blockIdx.x;
  const long long base = c * R;
  const int n = static_cast<int>(min(static_cast<long long>(R), m - base));

  // Stage the chunk: the payload with 16-byte loads (a chunk starts at a
  // multiple of R * 24 bytes, and R is even), then the ids. The loops stay
  // rolled: unrolled for a fixed R, they hold their loads in flight in
  // registers (48 per thread at R = 256 against 31 rolled, and a slower
  // pass on an H100; `b2_turns.py` times it).
  const float* src = vals + base * kCols;
  const int n4 = n * kCols / 4;
#pragma unroll 1
  for (int i = t; i < n4; i += R) {
    reinterpret_cast<float4*>(s_vals)[i] =
        __ldg(reinterpret_cast<const float4*>(src) + i);
  }
#pragma unroll 1
  for (int i = n4 * 4 + t; i < n * kCols; i += R) s_vals[i] = __ldg(src + i);
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
    float a[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) a[j] = 0.0f;
#pragma unroll 4
    for (int i = t; i < e; ++i) {
      const float2* row = reinterpret_cast<const float2*>(s_vals + i * kCols);
#pragma unroll
      for (int j = 0; j < kCols / 2; ++j) {
        const float2 p = row[j];
        a[2 * j] = __fadd_rn(a[2 * j], p.x);
        a[2 * j + 1] = __fadd_rn(a[2 * j + 1], p.y);
      }
    }
    const bool from_prev = t == 0 && base > 0 && prev == id;
    const bool to_next = e == n && base + n < m && __ldg(ids + base + n) == id;
    if (id >= 0 && id < v) {
      if (!from_prev && !to_next) {
        float* o = out + static_cast<long long>(id) * kCols;
#pragma unroll
        for (int j = 0; j < kCols; ++j) o[j] = __fadd_rn(0.0f, a[j]);
      }
      if (from_prev) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) head[c * kCols + j] = a[j];
      }
      if (to_next) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) tail[c * kCols + j] = a[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kSpanThreads)
    span_sums_kernel(const int* __restrict__ ids,
                     const float* __restrict__ head,
                     const float* __restrict__ tail, float* __restrict__ out,
                     int rows, long long n_chunks, int v) {
  __shared__ float s_part[kSpanThreads * kCols];
  const int t = threadIdx.x;
  const long long e = static_cast<long long>(blockIdx.x) + 1;  // edge before chunk e
  const int id = __ldg(ids + e * rows);
  const int before = __ldg(ids + e * rows - 1);
  const int earlier = e >= 2 ? __ldg(ids + (e - 1) * rows - 1) : INT_MIN;
  const int next = e + 1 < n_chunks ? __ldg(ids + (e + 1) * rows) : INT_MIN;
  // Only the first edge that a segment crosses does the work.
  if (id < 0 || id >= v || before != id || earlier == id) return;
  float acc = 0.0f;
  if (t < kCols) acc = __fadd_rn(acc, tail[(e - 1) * kCols + t]);
  if (next != id) {  // the segment ends in chunk e
    if (t < kCols) out[static_cast<long long>(id) * kCols + t] = __fadd_rn(acc, head[e * kCols + t]);
    return;
  }
  for (long long k0 = e; k0 < n_chunks; k0 += kSpanThreads) {
    // Chunks k0 .. whose first row is still `id` (a prefix: ids ascend).
    const long long k = k0 + t;
    const bool in = k < n_chunks && __ldg(ids + k * rows) == id;
    const int cnt = __syncthreads_count(in);
    if (in) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s_part[t * kCols + j] = head[k * kCols + j];
    }
    __syncthreads();
    if (t < kCols) {
      for (int i = 0; i < cnt; ++i) acc = __fadd_rn(acc, s_part[i * kCols + t]);
    }
    __syncthreads();
    if (cnt < kSpanThreads) break;
  }
  if (t < kCols) out[static_cast<long long>(id) * kCols + t] = acc;
}

template <int R>
void launch_chunk_sums(unsigned n_chunks, cudaStream_t s, const int* ids, const float* vals,
                       float* out, float* head, float* tail, long long m, int v) {
  chunk_sums_kernel<R><<<n_chunks, R, 0, s>>>(ids, vals, out, head, tail, m, v);
}

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
  if (chunk_rows != 32 && chunk_rows != 256 && chunk_rows != 512) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (v <= 0) return static_cast<int>(cudaSuccess);
  if (m < 0 || v > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_chunks = (m + chunk_rows - 1) / chunk_rows;
  if (n_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(v) * kCols * sizeof(float), s);
  if (err != cudaSuccess || n_chunks == 0) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n_chunks);
  const int vi = static_cast<int>(v);
  if (chunk_rows == 32) {
    launch_chunk_sums<32>(grid, s, ids, vals, out, head, tail, m, vi);
  } else if (chunk_rows == 256) {
    launch_chunk_sums<256>(grid, s, ids, vals, out, head, tail, m, vi);
  } else {
    launch_chunk_sums<512>(grid, s, ids, vals, out, head, tail, m, vi);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  span_sums_kernel<<<static_cast<unsigned>(n_chunks - 1), kSpanThreads, 0, s>>>(
      ids, head, tail, out, chunk_rows, n_chunks, static_cast<int>(v));
  return static_cast<int>(cudaGetLastError());
}
