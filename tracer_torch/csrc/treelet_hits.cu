// Ray-tile x treelet-block closest-hit / any-hit over a round of emissions.
//
// Replaces the Pallas TPU kernel tracer/kernels/treelet_hits.py::hits (its
// _kernel), which the packet engine (tracer_torch/accel/packet.py) calls
// once per traversal round, between rounds of its top-tree walk. Plain C
// interface, loaded with ctypes from tracer_torch/kernels/treelet_hits.py,
// which also holds the plain-PyTorch twin (hits_reference) that this kernel
// must match bit for bit.
//
// Contract (same as the TPU kernel and the twin):
//   * one tile = 128 rays (an 8x16 pixel packet); the tile streams its
//     emitted treelet blocks k = 0 .. en-1 (ids clipped to [0, NT-1]) while
//     enear[k] < ub, where ub starts at 3e38 and is the largest best t of
//     the tile after each block;
//   * a block is T triangles, kept as its NQ = 4 contiguous quarter blocks
//     of 16 feature rows x TQ = T/4 triangles (tracer_torch/accel/
//     treelet.py); inside a block the best hit is the smallest t, ties to
//     the smallest prim id, tested against the window [tmin, best t before
//     the block); across blocks a hit replaces the best only when strictly
//     closer, in emission order; "infinity" is 3.0e38 (not IEEE inf);
//   * any-hit: a lane whose flag is already set starts at -3e38; a hit sets
//     the flag to 1 and the bound to -3e38; the output t row is the input
//     best t, unchanged.
// The per-triangle test is moller.cuh's (shared with super_hits.cu): every
// float operation is a round-to-nearest intrinsic and the file is built
// with -fmad=false, so the result equals the twin's op-by-op PyTorch
// evaluation bit for bit.
//
// What bounds it on an H100: operations. Each block visit is 128 x T =
// 131,072 Moller tests (T = 1024) of 38 FP32 operations, one of them an
// IEEE division, against 64 KB of triangle data. The bunny stand-in's whole
// table (118 treelets x 64 KB = 7.7 MB) stays resident in the 50 MB L2, so
// device memory is not the limit; the dragon's (95 MB) would not be.
// Design response: one CTA of 128 threads per tile, one ray per thread,
// the ray kept in registers for the whole stream; each block is staged
// through shared memory one 16 KB quarter at a time (float4 copies by all
// threads), and every thread tests its ray against the staged triangles,
// whose features all threads of a warp read at the same address (a
// broadcast, no bank conflicts). At 16 KB of shared memory and 128 threads
// a CTA, many tiles share an SM, so one tile's staging overlaps another's
// tests without explicit double buffering. Each triangle costs 15 shared
// loads for one ray's test; several rays per thread, or a triangle-major
// float4 layout in shared memory, would cut that and is left for later.

#include <cuda_runtime.h>

#include <cstddef>

#include "moller.cuh"

namespace {

using tracer_torch::kInf;

constexpr int kTile = 128;  // rays per tile (8x16 pixels), one per thread
constexpr int kNq = 4;      // quarter blocks per block
constexpr int kRows = 16;   // feature rows per block

__global__ void __launch_bounds__(kTile)
    treelet_hits_kernel(const int* __restrict__ ids, const int* __restrict__ en,
                        const float* __restrict__ enear,
                        const float* __restrict__ qblocks,
                        const float* __restrict__ rays8,
                        const float* __restrict__ best,
                        float* __restrict__ out, int k_slots, int nt, int tq,
                        int any_hit) {
  extern __shared__ __align__(16) float blk[];  // kRows * tq: one quarter
  __shared__ float warp_ub[kTile / 32];

  const int tile = blockIdx.x;
  const int r = threadIdx.x;
  const float* r8 = rays8 + static_cast<size_t>(tile) * 8 * kTile;
  const float* b2 = best + static_cast<size_t>(tile) * 2 * kTile;
  const float ox = r8[0 * kTile + r], oy = r8[1 * kTile + r],
              oz = r8[2 * kTile + r];
  const float dx = r8[3 * kTile + r], dy = r8[4 * kTile + r],
              dz = r8[5 * kTile + r];
  const float tn = r8[6 * kTile + r];
  float bt = b2[r];
  float bp = b2[kTile + r];
  if (any_hit && bp > 0.0f) bt = -kInf;

  const int n = min(en[tile], k_slots);
  const int* ids_s = ids + static_cast<size_t>(tile) * k_slots;
  const float* enear_s = enear + static_cast<size_t>(tile) * k_slots;
  const int n4 = kRows * tq / 4;
  const size_t quarter = static_cast<size_t>(kRows) * tq;

  float ub = kInf;  // block-uniform
  for (int k = 0; k < n && enear_s[k] < ub; ++k) {
    const int b = min(max(ids_s[k], 0), nt - 1);
    float tb = kInf, pb = kInf;
    for (int q = 0; q < kNq; ++q) {
      const float4* src = reinterpret_cast<const float4*>(
          qblocks + (static_cast<size_t>(b) * kNq + q) * quarter);
      float4* dst = reinterpret_cast<float4*>(blk);
      __syncthreads();  // every thread is done with the previous quarter
      for (int i = r; i < n4; i += kTile) dst[i] = src[i];
      __syncthreads();
      for (int c = 0; c < tq; ++c) {
        const tracer_torch::Triangle tri = tracer_torch::load_triangle(blk, tq, c);
        const float tc = tracer_torch::moller_t(tri, ox, oy, oz, dx, dy, dz, tn, bt);
        tracer_torch::fold_block_best(tc, tri.pid, tb, pb);
      }
    }
    if (any_hit) {
      if (tb < kInf) {
        bp = 1.0f;
        bt = -kInf;
      }
    } else if (tb < bt) {
      bt = tb;
      bp = tb < kInf ? pb : -1.0f;
    }
    float m = bt;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if ((r & 31) == 0) warp_ub[r >> 5] = m;
    __syncthreads();
    ub = fmaxf(fmaxf(warp_ub[0], warp_ub[1]), fmaxf(warp_ub[2], warp_ub[3]));
  }

  float* o2 = out + static_cast<size_t>(tile) * 2 * kTile;
  o2[r] = any_hit ? b2[r] : bt;
  o2[kTile + r] = bp;
}

}  // namespace

// Launches one 128-thread CTA per tile on `stream` and returns
// cudaGetLastError(). Shapes: ids/enear (n_tiles, k_slots) i32/f32,
// en (n_tiles,) i32, qblocks (nt * 4, 16, tq) f32, rays8 (n_tiles, 8, 128)
// f32, best and out (n_tiles, 2, 128) f32; all contiguous, qblocks 16-byte
// aligned.
extern "C" int treelet_hits_launch(const int* ids, const int* en,
                                   const float* enear, const float* qblocks,
                                   const float* rays8, const float* best,
                                   float* out, int n_tiles, int k_slots,
                                   int nt, int tq, int any_hit, void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  if (tq <= 0 || tq % 4 != 0 || nt <= 0 || k_slots < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * kRows * static_cast<size_t>(tq);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        treelet_hits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  treelet_hits_kernel<<<n_tiles, kTile, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      ids, en, enear, qblocks, rays8, best, out, k_slots, nt, tq, any_hit);
  return static_cast<int>(cudaGetLastError());
}
