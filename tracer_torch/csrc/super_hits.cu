// Super-tile closest-hit / any-hit over near-ordered quarter-block emissions.
//
// Replaces the Pallas TPU kernel tracer/kernels/super_hits.py::hits2 (its
// _kernel, quarter-emission mode), which the flat frustum engine
// (tracer_torch/accel/flat.py) dispatches once per frame and once per
// repair or overflow round. Plain C interface, loaded with ctypes from
// tracer_torch/kernels/super_hits.py, which also holds the plain-PyTorch
// twin (hits2_reference) that this kernel must match bit for bit.
//
// Contract (same as the TPU kernel and the twin):
//   * one super-tile = 2048 rays = 16 sub-tiles of 128 rays; emissions are
//     quarter blocks of 16 feature rows x TQ triangles (tracer_torch/accel/
//     treelet.py), a 16-bit gate word per emission (bit s: sub-tile s may
//     hit the block), and a conservative, non-decreasing entry distance;
//   * sub-tile s tests emission k only when bit s is set and
//     enear[k] < ub[s], where ub[s] is the largest current best t of its 128
//     rays; the stream stops at the first k with enear[k] >= max_s ub[s];
//   * inside a block the best hit is the smallest t, ties to the smallest
//     prim id; across blocks a hit replaces the best only when strictly
//     closer, in emission order; "infinity" is 3.0e38 (not IEEE inf);
//   * any-hit: an occluded lane's bound drops to -3.0e38, its flag to 1, and
//     the output t row is the input best t, unchanged.
// The per-triangle test is moller.cuh's (shared with treelet_hits.cu):
// every float operation is a round-to-nearest intrinsic and the file is
// built with -fmad=false, so the result equals the twin's op-by-op PyTorch
// evaluation bit for bit.
//
// What bounds it on an H100: each visited emission moves one 16*TQ*4-byte
// block (16 KB at TQ = 256) from device memory or L2 and, per gated
// sub-tile, runs 128 x TQ Moller tests of ~35 FP32 operations and one
// IEEE division. The frame's quarter-block table (95 MB for the dragon
// stand-in: 1,443 treelets x 4 quarters x 16 KB) exceeds the 50 MB L2, so
// block reads are latency-bound at low occupancy: one 512-thread CTA per
// super-tile gives only ~1.5 CTAs per SM at 800x450 (195 super-tiles).
// Design response: the block is staged once in shared memory and shared by
// all 16 warps (one warp per sub-tile, 4 rays per lane), so each visit reads
// the block from memory once instead of once per sub-tile; gate bits are
// warp-uniform, so a culled sub-tile costs no arithmetic and no divergence;
// each triangle's 15 features are read from shared memory once per lane and
// reused for its 4 rays. Overlapping the next block's load with the current
// block's tests (cp.async or TMA double buffering) is left for later work.

#include <cuda_runtime.h>

#include <cstddef>

#include "moller.cuh"

namespace {

using tracer_torch::kInf;

constexpr int kSub = 128;              // rays per sub-tile (8x16 pixels)
constexpr int kNSub = 16;              // sub-tiles per super-tile
constexpr int kSuper = kSub * kNSub;   // rays per super-tile
constexpr int kRows = 16;              // feature rows per block
constexpr int kRays = kSub / 32;       // rays per lane
constexpr int kThreads = 32 * kNSub;   // one warp per sub-tile

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    super_hits_kernel(const int* __restrict__ ids, const int* __restrict__ en,
                      const float* __restrict__ enear,
                      const int* __restrict__ gm,
                      const float* __restrict__ qblocks,
                      const float* __restrict__ rays8,
                      const float* __restrict__ best,
                      float* __restrict__ out, int kd, int ntq, int tq,
                      int any_hit) {
  extern __shared__ __align__(16) float blk[];  // kRows * tq
  __shared__ float ub[kNSub];

  const int sup = blockIdx.x;
  const int s = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* r8 = rays8 + static_cast<size_t>(sup) * 8 * kSuper;
  const float* b2 = best + static_cast<size_t>(sup) * 2 * kSuper;

  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float tn[kRays], bt[kRays], bp[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int r = s * kSub + j * 32 + lane;
    ox[j] = r8[0 * kSuper + r];
    oy[j] = r8[1 * kSuper + r];
    oz[j] = r8[2 * kSuper + r];
    dx[j] = r8[3 * kSuper + r];
    dy[j] = r8[4 * kSuper + r];
    dz[j] = r8[5 * kSuper + r];
    tn[j] = r8[6 * kSuper + r];
    bt[j] = b2[r];
    bp[j] = b2[kSuper + r];
    if (any_hit && bp[j] > 0.0f) bt[j] = -kInf;
  }
  float m = bt[0];
#pragma unroll
  for (int j = 1; j < kRays; ++j) m = fmaxf(m, bt[j]);
  m = warp_max(m);
  if (lane == 0) ub[s] = m;
  __syncthreads();

  const int n = min(en[sup], kd);  // the twin also stops at kd slots
  const int* ids_s = ids + static_cast<size_t>(sup) * kd;
  const float* enear_s = enear + static_cast<size_t>(sup) * kd;
  const int* gm_s = gm + static_cast<size_t>(sup) * kd;
  const int n4 = kRows * tq / 4;

  float gub = kInf;
  for (int k = 0; k < n; ++k) {
    const float ek = enear_s[k];
    if (!(ek < gub)) break;  // every sub-tile's bound beats the stream
    const int g = gm_s[k];
    if (g != 0) {
      const int q = min(max(ids_s[k], 0), ntq - 1);
      const float4* src = reinterpret_cast<const float4*>(
          qblocks + static_cast<size_t>(q) * kRows * tq);
      float4* dst = reinterpret_cast<float4*>(blk);
      for (int i = threadIdx.x; i < n4; i += kThreads) dst[i] = src[i];
      __syncthreads();
      if (((g >> s) & 1) && ek < ub[s]) {
        float tb[kRays], pb[kRays];
#pragma unroll
        for (int j = 0; j < kRays; ++j) {
          tb[j] = kInf;
          pb[j] = kInf;
        }
        for (int c = 0; c < tq; ++c) {
          const tracer_torch::Triangle tri = tracer_torch::load_triangle(blk, tq, c);
#pragma unroll
          for (int j = 0; j < kRays; ++j) {
            const float tc = tracer_torch::moller_t(tri, ox[j], oy[j], oz[j], dx[j],
                                                    dy[j], dz[j], tn[j], bt[j]);
            tracer_torch::fold_block_best(tc, tri.pid, tb[j], pb[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kRays; ++j) {
          if (any_hit) {
            if (tb[j] < kInf) {
              bp[j] = 1.0f;
              bt[j] = -kInf;
            }
          } else if (tb[j] < bt[j]) {
            bt[j] = tb[j];
            bp[j] = tb[j] < kInf ? pb[j] : -1.0f;
          }
        }
        m = bt[0];
#pragma unroll
        for (int j = 1; j < kRays; ++j) m = fmaxf(m, bt[j]);
        m = warp_max(m);
        if (lane == 0) ub[s] = m;
      }
      __syncthreads();  // ub visible; the staged block may be overwritten
    }
    gub = ub[0];
#pragma unroll
    for (int i = 1; i < kNSub; ++i) gub = fmaxf(gub, ub[i]);
  }

  float* o2 = out + static_cast<size_t>(sup) * 2 * kSuper;
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int r = s * kSub + j * 32 + lane;
    o2[r] = any_hit ? b2[r] : bt[j];
    o2[kSuper + r] = bp[j];
  }
}

}  // namespace

// Launches one 512-thread CTA per super-tile on `stream` and returns
// cudaGetLastError(). Shapes: ids/enear/gm (n_super, kd) i32/f32/i32,
// en (n_super,) i32, qblocks (ntq, 16, tq) f32, rays8 (n_super, 8, 2048)
// f32, best and out (n_super, 2, 2048) f32; all contiguous.
extern "C" int super_hits_launch(const int* ids, const int* en,
                                 const float* enear, const int* gm,
                                 const float* qblocks, const float* rays8,
                                 const float* best, float* out, int n_super,
                                 int kd, int ntq, int tq, int any_hit,
                                 void* stream) {
  if (n_super <= 0) return static_cast<int>(cudaSuccess);
  if (tq <= 0 || tq % 4 != 0 || ntq <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * kRows * static_cast<size_t>(tq);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        super_hits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  super_hits_kernel<<<n_super, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      ids, en, enear, gm, qblocks, rays8, best, out, kd, ntq, tq, any_hit);
  return static_cast<int>(cudaGetLastError());
}
