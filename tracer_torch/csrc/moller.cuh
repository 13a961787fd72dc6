// The per-triangle Moller test of the port's hit kernels (super_hits.cu,
// treelet_hits.cu), written once.
//
// It is _moller_tile of the JAX package (tracer/kernels/treelet_hits.py:
// 43-82) for one (ray, triangle) pair, operation for operation: plane-form
// t = (k - n.o) / (n.d) with the barycentric inside tests, every float
// operation spelled as a round-to-nearest intrinsic (the kernels are built
// with -fmad=false as well), so a kernel equals its op-by-op PyTorch twin
// (tracer_torch/kernels/super_hits.py::moller_tile) bit for bit. NaN from a
// zero denominator fails every comparison, as it does there.
//
// Triangles come from a feature-major block in shared memory (16 rows x
// `stride` triangles; tracer_torch/accel/treelet.py lists the rows).

#pragma once

namespace tracer_torch {

constexpr float kInf = 3.0e38f;  // the JAX package's "infinity", not IEEE inf

struct Triangle {
  float v0x, v0y, v0z, e0x, e0y, e0z, e1x, e1y, e1z, pid, valid, nx, ny, nz, k;
};

__device__ __forceinline__ Triangle load_triangle(const float* blk, int stride,
                                                  int c) {
  Triangle tri;
  tri.v0x = blk[0 * stride + c];
  tri.v0y = blk[1 * stride + c];
  tri.v0z = blk[2 * stride + c];
  tri.e0x = blk[3 * stride + c];
  tri.e0y = blk[4 * stride + c];
  tri.e0z = blk[5 * stride + c];
  tri.e1x = blk[6 * stride + c];
  tri.e1y = blk[7 * stride + c];
  tri.e1z = blk[8 * stride + c];
  tri.pid = blk[9 * stride + c];
  tri.valid = blk[10 * stride + c];
  tri.nx = blk[11 * stride + c];
  tri.ny = blk[12 * stride + c];
  tri.nz = blk[13 * stride + c];
  tri.k = blk[14 * stride + c];
  return tri;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// The hit distance when the ray (origin o, direction d) meets the triangle
// inside the window [tn, upper) and the slot is valid, else kInf.
__device__ __forceinline__ float moller_t(const Triangle& tri, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float tn,
                                          float upper) {
  const float denom = dot3(tri.nx, tri.ny, tri.nz, dx, dy, dz);
  const float inv = __fdiv_rn(1.0f, denom);
  const float t = __fmul_rn(
      __fsub_rn(tri.k, dot3(tri.nx, tri.ny, tri.nz, ox, oy, oz)), inv);
  const float sx = __fsub_rn(tri.v0x, ox);
  const float sy = __fsub_rn(tri.v0y, oy);
  const float sz = __fsub_rn(tri.v0z, oz);
  const float nomx = __fsub_rn(__fmul_rn(sy, dz), __fmul_rn(sz, dy));
  const float nomy = __fsub_rn(__fmul_rn(sz, dx), __fmul_rn(sx, dz));
  const float nomz = __fsub_rn(__fmul_rn(sx, dy), __fmul_rn(sy, dx));
  const float beta =
      __fmul_rn(dot3(nomx, nomy, nomz, tri.e1x, tri.e1y, tri.e1z), inv);
  const float gamma =
      __fmul_rn(-dot3(nomx, nomy, nomz, tri.e0x, tri.e0y, tri.e0z), inv);
  const bool ok = (beta >= 0.0f) && (gamma >= 0.0f) &&
                  (__fadd_rn(beta, gamma) <= 1.0f) && (t >= tn) &&
                  (t < upper) && (tri.valid > 0.5f);
  return ok ? t : kInf;
}

// Folds one candidate into a block-local best: the smallest t wins, ties go
// to the smallest prim id (the twin's min over t, then over the prim ids at
// that t). Start from (kInf, kInf); a best t of kInf means no hit.
__device__ __forceinline__ void fold_block_best(float tc, float pid, float& tb,
                                                float& pb) {
  if (tc < tb || (tc == tb && pid < pb)) {
    tb = tc;
    pb = pid;
  }
}

}  // namespace tracer_torch
