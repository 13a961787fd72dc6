// The brute-force engine's two queries, closest hit and any hit, over every
// triangle of a mesh: one launch a query.
//
// Replaces no Pallas kernel: mesh_brute_force is XLA in the JAX package
// (tracer/kernels/intersect.py). It was added because the query in PyTorch
// ops (tracer_torch/kernels/intersect.py::mesh_brute_force_reference and
// mesh_brute_force_anyhit_reference, this kernel's plain twins) forms every
// (ray, triangle) pair as (N, T, 3) float32 temporaries: ~69 kernels a query
// and ~1.4 GB of operands for 262,144 rays and 12 triangles, where the
// useful input and output is ~10 MB. Plain C interface, loaded with ctypes
// from tracer_torch/kernels/brute_hits.py; the kernel must equal the twins
// bit for bit, misses and ties included.
//
// What the twins compute, for a ray (o, d, tmin, tmax) and a triangle
// (v0, e0 = v1 - v0, e1 = v2 - v0, n = cross(e0, e1)), in this order:
//   s = v0 - o; nom = cross(s, d); bn = dot(nom, e1); gn = -dot(nom, e0);
//   dn = dot(d, n); tn = dot(s, n); t = tn / safe(dn), where safe clamps
//   |dn| to at least 1e-20 with dn's sign (a NaN stays NaN); the pair is
//   accepted where bn dn >= 0, gn dn >= 0, (bn + gn) dn <= dn dn, tmin <= t,
//   t <= tmax and dn != 0. Every dot is (a0 b0 + a1 b1) + a2 b2. Each step
//   is one correctly rounded float32 operation (built with -fmad=false, and
//   spelled with the _rn intrinsics), so the card rounds as the twins do on
//   either device.
//   * Closest: v = accepted ? t : 3e38 for each triangle j; the result is
//     argmin's (first index of the least v, none NaN), kept where its v is
//     below tmax, else (tmax, -1). The fold starts from (+inf, 0) and keeps
//     strict minima, which is argmin's pick for any T >= 1; with T = 0 it
//     reports the miss.
//   * Any hit: the OR of the accepted flags. A lane stops at its first
//     accepted pair, and a lane whose window is empty (!(tmin <= tmax))
//     tests nothing: no t passes both ends of it. A closest-hit lane with an
//     empty window takes argmin's answer over T misses, (3e38, 0), without
//     testing.
//
// What bounds it on an H100: bytes. A query reads each ray once (o, d, tmin,
// tmax: 32 B) and writes t and the id (8 B) or the flag (1 B): 10.5 MB for
// 262,144 rays, 3.1 us at 3.35 TB/s; the mesh is a few hundred bytes. Its
// tests (38 float32 operations a pair) take 1.8 us at 67 TFLOP/s for 12
// triangles. Design: one thread a ray, held in registers; every block forms
// the triangle terms (v0, e0, e1, n) into shared memory, 128 triangles at a
// time (one a thread), and every thread reads them back as broadcasts, so no
// pair's terms ever reach device memory. Rays are read by their strides, so
// a tmin or tmax expanded from one value (stride 0) costs no copy.

#include <cuda_runtime.h>

#include "moller.cuh"

namespace {

using tracer_torch::dot3;
using tracer_torch::kInf;
using i64 = long long;

constexpr int kThreads = 128;  // rays a block, and triangles staged a pass
constexpr int kTerms = 12;  // v0, e0, e1, n
constexpr float kTiny = 1.0e-20f;  // intersect._safe_denom's clamp

struct Query {
  const float* o;
  i64 o0, o1;
  const float* d;
  i64 d0, d1;
  const float* tmin;
  i64 tmin0;
  const float* tmax;
  i64 tmax0;
  const float* verts;
  i64 v0, v1;
  const int* idx;
  i64 i0, i1;
  int n, tris, nverts;
  float* t_out;
  int* id_out;
  unsigned char* blocked;
};

// Vertex `k` of triangle `j`; a negative index counts from the end, as
// PyTorch's indexing of `vertices` does.
__device__ __forceinline__ void vertex(const Query& q, int j, int k, float& x,
                                       float& y, float& z) {
  int v = q.idx[j * q.i0 + k * q.i1];
  if (v < 0) v += q.nverts;
  const float* p = q.verts + v * q.v0;
  x = p[0];
  y = p[q.v1];
  z = p[2 * q.v1];
}

// intersect._triangle_terms for triangle `j`, into column `c` of `s`.
__device__ __forceinline__ void stage(const Query& q, int j, int c,
                                      float (*s)[kThreads]) {
  float ax, ay, az, bx, by, bz, cx, cy, cz;
  vertex(q, j, 0, ax, ay, az);
  vertex(q, j, 1, bx, by, bz);
  vertex(q, j, 2, cx, cy, cz);
  const float e0x = __fsub_rn(bx, ax), e0y = __fsub_rn(by, ay), e0z = __fsub_rn(bz, az);
  const float e1x = __fsub_rn(cx, ax), e1y = __fsub_rn(cy, ay), e1z = __fsub_rn(cz, az);
  const float terms[kTerms] = {
      ax, ay, az, e0x, e0y, e0z, e1x, e1y, e1z,
      __fsub_rn(__fmul_rn(e0y, e1z), __fmul_rn(e0z, e1y)),
      __fsub_rn(__fmul_rn(e0z, e1x), __fmul_rn(e0x, e1z)),
      __fsub_rn(__fmul_rn(e0x, e1y), __fmul_rn(e0y, e1x))};
#pragma unroll
  for (int r = 0; r < kTerms; ++r) s[r][c] = terms[r];
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) brute_hits_kernel(const Query q) {
  __shared__ float s[kTerms][kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool lane = i < q.n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tmax = 0.f;
  if (lane) {
    const float* po = q.o + i * q.o0;
    const float* pd = q.d + i * q.d0;
    ox = po[0], oy = po[q.o1], oz = po[2 * q.o1];
    dx = pd[0], dy = pd[q.d1], dz = pd[2 * q.d1];
    tmin = q.tmin[i * q.tmin0];
    tmax = q.tmax[i * q.tmax0];
  }
  bool live = lane && (tmin <= tmax);
  bool hit = false;
  float best = (live || q.tris == 0) ? __int_as_float(0x7f800000) : kInf;
  int best_j = 0;
  for (int lo = 0; lo < q.tris; lo += kThreads) {
    const int c = min(kThreads, q.tris - lo);
    if (threadIdx.x < c) stage(q, lo + threadIdx.x, threadIdx.x, s);
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int k = 0; k < c; ++k) {
        const float sx = __fsub_rn(s[0][k], ox), sy = __fsub_rn(s[1][k], oy),
                    sz = __fsub_rn(s[2][k], oz);
        const float nomx = __fsub_rn(__fmul_rn(sy, dz), __fmul_rn(sz, dy));
        const float nomy = __fsub_rn(__fmul_rn(sz, dx), __fmul_rn(sx, dz));
        const float nomz = __fsub_rn(__fmul_rn(sx, dy), __fmul_rn(sy, dx));
        const float bn = dot3(nomx, nomy, nomz, s[6][k], s[7][k], s[8][k]);
        const float gn = -dot3(nomx, nomy, nomz, s[3][k], s[4][k], s[5][k]);
        const float dn = dot3(dx, dy, dz, s[9][k], s[10][k], s[11][k]);
        const float tn = dot3(sx, sy, sz, s[9][k], s[10][k], s[11][k]);
        const float mag = fabsf(dn) < kTiny ? kTiny : fabsf(dn);
        const float t = __fdiv_rn(tn, dn < 0.f ? -mag : mag);
        const bool ok = (__fmul_rn(bn, dn) >= 0.f) && (__fmul_rn(gn, dn) >= 0.f) &&
                        (__fmul_rn(__fadd_rn(bn, gn), dn) <= __fmul_rn(dn, dn)) &&
                        (t >= tmin) && (t <= tmax) && (dn != 0.f);
        if (kAnyHit) {
          if (ok) {
            hit = true;
            live = false;
            break;
          }
        } else {
          const float v = ok ? t : kInf;
          if (v < best) {
            best = v;
            best_j = lo + k;
          }
        }
      }
    }
    if (kAnyHit) {
      if (__syncthreads_and(!live)) break;
    } else {
      __syncthreads();
    }
  }
  if (!lane) return;
  if (kAnyHit) {
    q.blocked[i] = hit;
  } else {
    const bool found = best < tmax;
    q.t_out[i] = found ? best : tmax;
    q.id_out[i] = found ? best_j : -1;
  }
}

}  // namespace

// One query: any_hit = 0 writes t_out and id_out, 1 writes blocked. Strides
// are in elements. Returns the launch's cudaError_t.
extern "C" int brute_hits_launch(int any_hit, const float* o, i64 o0, i64 o1,
                                 const float* d, i64 d0, i64 d1, const float* tmin,
                                 i64 tmin0, const float* tmax, i64 tmax0,
                                 const float* verts, i64 v0, i64 v1, const int* idx,
                                 i64 i0, i64 i1, int n, int tris, int nverts,
                                 float* t_out, int* id_out, unsigned char* blocked,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (tris < 0 || nverts < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Query q{o, o0, o1, d, d0, d1, tmin, tmin0, tmax, tmax0, verts, v0, v1, idx,
                i0, i1, n, tris, nverts, t_out, id_out, blocked};
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    brute_hits_kernel<true><<<blocks, kThreads, 0, s>>>(q);
  } else {
    brute_hits_kernel<false><<<blocks, kThreads, 0, s>>>(q);
  }
  return static_cast<int>(cudaGetLastError());
}
