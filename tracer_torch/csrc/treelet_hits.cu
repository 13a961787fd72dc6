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
//     the tile's 128 lanes after each block;
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
// Lane rule: a lane is live while tmin < bt (bt as held here: -3e38 for an
// occluded any-hit lane). A lane that is not live can never hit again (a
// hit needs tmin <= t < bt, and NaN fails both), so it is not tested: it
// takes the block's "no hit" update (t = 3e38, which only lowers a bt above
// 3e38 to 3e38). Lanes die mid-stream: any-hit at their first hit, closest
// when bt reaches tmin. A visit that finds no live lane applies that update
// and ends the stream without reading the block; later visits could change
// nothing. ub stays the max over all 128 lanes, so the break is unchanged.
//
// What bounds it on an H100: operations. A visit needs (live lanes) x T
// Moller tests of 38 FP32 operations, one of them an IEEE division, against
// 64 KB of triangle data; the bunny stand-in's whole table (118 treelets x
// 64 KB = 7.7 MB) stays resident in the 50 MB L2, so device memory is not
// the limit. Most lanes that reach B3 in a path frame are dead: finished
// paths keep an empty window, but the packet walk still emits the blocks
// around their origins (in a 512x512 W9 E1 frame, chip_smoke.py counts
// 16.3% of bounce 2's lane-visits live, and under 3% of each later
// round's). Design:
//   * one CTA of 128 threads per tile; the rays sit in shared memory and,
//     before each block, the live lanes are compacted there in lane order
//     (a ballot per warp); a tile with none stops at once;
//   * the L live rays are spread over all 128 threads: S = the power of two
//     >= ceil(L / 4) ray slots of up to 4 rays each (ray slot + i * S), and
//     128 / S triangle splits (triangle split + j * 128 / S of each
//     quarter), so each triangle's 15 features are read from shared memory
//     once for up to 4 rays, lanes of a warp read neighbouring or equal
//     addresses (no bank conflicts), and a tile with one live lane still
//     keeps every thread busy on a share of the triangles;
//   * the splits' per-ray block bests meet in shared memory and are folded
//     with fold_block_best's (t, pid) minimum, which is order-free, so the
//     result is the twin's whatever S is;
//   * the 16 KB quarters are double-buffered with cp.async: quarter q + 1
//     (or the next block's first) is in flight while quarter q is tested.

#include <cuda_runtime.h>

#include <cstddef>

#include "moller.cuh"

namespace {

using tracer_torch::kInf;

constexpr int kTile = 128;  // rays per tile (8x16 pixels) and threads per CTA
constexpr int kWarps = kTile / 32;
constexpr int kNq = 4;      // quarter blocks per block
constexpr int kRows = 16;   // feature rows per block
constexpr int kRays = 4;    // live rays per thread at most
constexpr int kRayRows = 7; // o xyz, d xyz, tmin

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// All threads: start copying quarter q of block b into `dst` as one commit
// group (16-byte copies, neighbouring threads on neighbouring addresses).
__device__ __forceinline__ void stage_quarter(float* dst, const float* qblocks,
                                              int b, int q, int tq) {
  const size_t quarter = static_cast<size_t>(kRows) * tq;
  const float4* src = reinterpret_cast<const float4*>(
      qblocks + (static_cast<size_t>(b) * kNq + q) * quarter);
  float4* d = reinterpret_cast<float4*>(dst);
  const int n4 = kRows * tq / 4;
  for (int i = threadIdx.x; i < n4; i += kTile) cp_async16(d + i, src + i);
  cp_async_commit();
}

// The block's update of one lane with its block best (tb, pb).
__device__ __forceinline__ void update_lane(bool any_hit, float tb, float pb,
                                            float& bt, float& bp) {
  if (any_hit) {
    if (tb < kInf) {
      bp = 1.0f;
      bt = -kInf;
    }
  } else if (tb < bt) {
    bt = tb;
    bp = tb < kInf ? pb : -1.0f;
  }
}

struct Compaction {
  int n_live;  // live lanes of the tile (block-uniform)
  float ub;    // the largest bt of the tile (block-uniform)
  int idx;     // this lane's place among the live lanes (live lanes only)
};

// Block-wide: lists the live lanes in lane order in s_lane, publishes each
// lane's bt in s_up, and returns the count, the tile's max bt and the
// lane's place.
__device__ __forceinline__ Compaction compact(bool live, float bt, int* s_lane,
                                              float* s_up, int* s_wcount,
                                              float* s_wub) {
  const int r = threadIdx.x, lane = r & 31, warp = r >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  float m = bt;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (lane == 0) {
    s_wcount[warp] = __popc(mask);
    s_wub[warp] = m;
  }
  s_up[r] = bt;
  __syncthreads();
  Compaction c;
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_wcount[w] : 0;
    total += s_wcount[w];
  }
  c.n_live = total;
  c.ub = fmaxf(fmaxf(s_wub[0], s_wub[1]), fmaxf(s_wub[2], s_wub[3]));
  c.idx = before + __popc(mask & ((1u << lane) - 1u));
  if (live) s_lane[c.idx] = r;
  __syncthreads();
  return c;
}

__global__ void __launch_bounds__(kTile)
    treelet_hits_kernel(const int* __restrict__ ids, const int* __restrict__ en,
                        const float* __restrict__ enear,
                        const float* __restrict__ qblocks,
                        const float* __restrict__ rays8,
                        const float* __restrict__ best,
                        float* __restrict__ out, int k_slots, int nt, int tq,
                        int any_hit) {
  extern __shared__ __align__(16) float s_quarters[];  // 2 x (kRows * tq)
  __shared__ float s_ray[kRayRows][kTile];
  __shared__ float s_up[kTile];    // each lane's bt before the block
  __shared__ int s_lane[kTile];    // live lanes in lane order
  __shared__ float s_tb[kTile * kRays];  // per (split, live ray) block bests
  __shared__ float s_pb[kTile * kRays];
  __shared__ int s_wcount[kWarps];
  __shared__ float s_wub[kWarps];

  const int tile = blockIdx.x;
  const int r = threadIdx.x;
  const float* r8 = rays8 + static_cast<size_t>(tile) * 8 * kTile;
  const float* b2 = best + static_cast<size_t>(tile) * 2 * kTile;
#pragma unroll
  for (int j = 0; j < kRayRows; ++j) s_ray[j][r] = r8[j * kTile + r];
  const float tn = s_ray[6][r];
  float bt = b2[r];
  float bp = b2[kTile + r];
  if (any_hit && bp > 0.0f) bt = -kInf;

  const int n = min(en[tile], k_slots);
  const int* ids_s = ids + static_cast<size_t>(tile) * k_slots;
  const float* enear_s = enear + static_cast<size_t>(tile) * k_slots;
  const size_t quarter = static_cast<size_t>(kRows) * tq;
  auto block_id = [&](int k) { return min(max(ids_s[k], 0), nt - 1); };

  bool live = tn < bt;
  Compaction cp = compact(live, bt, s_lane, s_up, s_wcount, s_wub);
  float ub = kInf;  // block-uniform
  if (n > 0 && enear_s[0] < ub && cp.n_live > 0) {
    stage_quarter(s_quarters, qblocks, block_id(0), 0, tq);
  }
  for (int k = 0; k < n && enear_s[k] < ub; ++k) {
    if (cp.n_live == 0) {
      update_lane(any_hit, kInf, kInf, bt, bp);
      break;
    }
    // Ray slots and triangle splits for this block's live lanes.
    const int want = (cp.n_live + kRays - 1) / kRays;
    const int lg_s = want <= 1 ? 0 : 32 - __clz(want - 1);
    const int S = 1 << lg_s;
    const int W = kTile >> lg_s;
    const int slot = r & (S - 1);
    const int split = r >> lg_s;
    float ro[kRays][kRayRows], up[kRays], tb[kRays], pb[kRays];
    int nr = 0;
#pragma unroll
    for (int i = 0; i < kRays; ++i) {
      tb[i] = kInf;
      pb[i] = kInf;
      const int idx = slot + i * S;
      if (idx < cp.n_live) {
        const int l = s_lane[idx];
#pragma unroll
        for (int j = 0; j < kRayRows; ++j) ro[i][j] = s_ray[j][l];
        up[i] = s_up[l];
        nr = i + 1;
      } else {
#pragma unroll
        for (int j = 0; j < kRayRows; ++j) ro[i][j] = 0.0f;
        up[i] = -kInf;
      }
    }

    const int b = block_id(k);
    for (int q = 0; q < kNq; ++q) {
      if (q + 1 < kNq) {
        stage_quarter(s_quarters + ((q + 1) & 1) * quarter, qblocks, b, q + 1, tq);
      } else if (k + 1 < n) {
        stage_quarter(s_quarters, qblocks, block_id(k + 1), 0, tq);
      } else {
        cp_async_commit();  // an empty group keeps the wait count uniform
      }
      cp_async_wait<1>();
      __syncthreads();
      const float* blk = s_quarters + (q & 1) * quarter;
      for (int c = split; c < tq; c += W) {
        const tracer_torch::Triangle tri = tracer_torch::load_triangle(blk, tq, c);
#pragma unroll
        for (int i = 0; i < kRays; ++i) {
          if (i < nr) {
            const float tc = tracer_torch::moller_t(
                tri, ro[i][0], ro[i][1], ro[i][2], ro[i][3], ro[i][4],
                ro[i][5], ro[i][6], up[i]);
            tracer_torch::fold_block_best(tc, tri.pid, tb[i], pb[i]);
          }
        }
      }
      __syncthreads();  // every thread is done with this buffer
    }

    // Fold the splits' bests per live ray, then update every lane.
#pragma unroll
    for (int i = 0; i < kRays; ++i) {
      if (i < nr) {
        s_tb[split * (S * kRays) + slot + i * S] = tb[i];
        s_pb[split * (S * kRays) + slot + i * S] = pb[i];
      }
    }
    __syncthreads();
    float t_best = kInf, p_best = kInf;
    if (live) {
      for (int s = 0; s < W; ++s) {
        tracer_torch::fold_block_best(s_tb[s * (S * kRays) + cp.idx],
                                      s_pb[s * (S * kRays) + cp.idx], t_best,
                                      p_best);
      }
    }
    update_lane(any_hit, t_best, p_best, bt, bp);
    live = tn < bt;
    cp = compact(live, bt, s_lane, s_up, s_wcount, s_wub);
    ub = cp.ub;
  }
  cp_async_wait<0>();  // retire a copy started for a block the break skipped

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
  const size_t smem = 2 * sizeof(float) * kRows * static_cast<size_t>(tq);
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
