// Packet phase A's top-tree walk: n iterations of the walk for every tile of
// a chunk, in one launch.
//
// Replaces no Pallas kernel: phase A is XLA in the JAX package
// (tracer/accel/packet.py). It was added because one iteration of the
// walk in PyTorch ops (tracer_torch/accel/packet.py::_body, this kernel's
// plain twin) is ~230 dependent kernels on (C, 8, 128) or smaller tensors,
// each doing almost nothing, so an iteration cost ~0.6 ms of kernel latency
// on the card even when replayed from a CUDA graph. Plain C interface,
// loaded with ctypes from tracer_torch/kernels/phase_a_walk.py; the kernel
// reads and writes packet._Walk's buffers in place, with their dtypes, and
// must equal _body bit for bit in state and emissions.
//
// What _body does for one tile of 128 rays (one iteration):
//   * active = !done && !paused; a visiting tile (active, not ascending)
//     slab-tests its rays against the 8 child boxes of top[cur]: near =
//     amax over axes of minimum(t0, t1), far = amin of maximum(t0, t1);
//     a ray passes if near <= far, far >= tmin and near < prune; a child is
//     hit if a ray passes, at the amin over passing rays of
//     clamp_min(near, 0);
//   * hit treelet children (ref <= -2) are emitted in (near, slot) order to
//     eids / enear at en, en + 1, ... (a slot at or past K is dropped); the
//     nearest hit inner child (ref >= 0, lowest slot on ties) is descended
//     into and its siblings parked in the stack row [level];
//   * an ascending tile pops the nearest unconsumed sibling of the stack row
//     [level] whose near lies below the tile's loosest bound (amax);
//   * done reads the new level (< 0 after an ascent), paused the new done
//     and the new en (> K - 8).
// A tile that is done or paused is a fixed point, so a warp stops at its
// first such iteration.
//
// Bit for bit with the twin: every float operation is a subtraction, a
// product, a minimum, a maximum or a comparison (built with -fmad=false, so
// none is contracted). torch.minimum / maximum and amax / amin propagate
// NaN (rays parallel to an axis whose origin lies on a slab plane give
// 0 * inf = NaN, which fails every comparison), so near and far take PTX's
// min.NaN / max.NaN, where fminf and fmaxf would drop the NaN. Where they
// differ from PyTorch's folds at all, it is in the sign of a zero, which no
// comparison sees and clamp_min (PyTorch's `isnan(v) ? v : fmaxf(v, 0)`,
// taken here as written) turns into +0 on both. The cross-ray minimum of
// the clamped nears is taken over values that are never NaN or -0, so its
// order does not matter; argmin keeps the lowest slot among equal keys.
//
// What bounds it on an H100: bytes. A launch reads each ray once (o,
// inv_d, tmin, prune: 32 B), the top tree, the state and the sibling stacks,
// writes the state and stacks back and the emissions once: 11.3 MB for the
// bunny's 2,048-tile first-bounce chunk, 3.4 us at 3.35 TB/s; its slab tests
// (25 float32 operations a ray and child) take less at 67 TFLOP/s. In fact
// it is bound by its dependent steps (load the node, test, reduce, pick,
// load the next node) at ~16 warps an SM. Design:
//   * one warp per tile, four rays per lane (lane + 32 r), held in
//     registers with the tile's state across the n iterations; four warps
//     (tiles) a CTA, no shared memory and no barrier;
//   * every lane reads the node's 8 boxes (one broadcast address a load);
//     the per-child any and minimum over the tile's rays are a transposed
//     butterfly of shuffles (9 for the nears, 5 for the hit bits) that
//     leaves child j's result in lanes 4j..4j+3;
//   * the emission order, the descent and the ascent run one child slot per
//     lane (lanes 0-7): a slot's place among the emissions is its rank by
//     (near, slot), and the argmins are three shuffle steps;
//   * only the slots that change are written: a descent writes the whole
//     stack row, a pop one near.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // rays per tile
constexpr int kRays = kTile / 32;  // rays per lane
constexpr int kWarps = 4;  // tiles per CTA
constexpr int kSlots = 8;  // children of a top-tree node
constexpr int kRow = 8;  // floats per child in a top row: lo3, hi3, ref, pad
constexpr float kInf = 3.0e38f;  // packet._INF
constexpr unsigned kFull = 0xffffffffu;

using i64 = long long;

// Minimum and maximum that are NaN where either operand is (sm_80 and up).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// torch.clamp_min(v, 0.0) on the card.
__device__ __forceinline__ float clamp_min0(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

// Argmin of `key` over lanes 0-7 (each group of 8 lanes alike): the
// smallest key, the lowest slot among equal ones. Keys are never NaN.
__device__ __forceinline__ void argmin8(float& key, int& slot) {
#pragma unroll
  for (int off = 1; off < kSlots; off <<= 1) {
    const float k2 = __shfl_xor_sync(kFull, key, off);
    const int s2 = __shfl_xor_sync(kFull, slot, off);
    if (k2 < key || (k2 == key && s2 < slot)) {
      key = k2;
      slot = s2;
    }
  }
}

struct Walk {
  const float* top;  // (R, 8, 8)
  const i64* top_ref;  // (R, 8)
  const float* o;  // (C, 128, 3)
  const float* inv_d;  // (C, 128, 3)
  const float* tmin;  // (C, 128)
  const float* prune;  // (C, 128)
  const float* amax;  // (C,)
  i64* cur;  // (C,)
  i64* level;  // (C,)
  bool* asc;  // (C,)
  bool* done;  // (C,)
  bool* paused;  // (C,)
  float* snear;  // (C, D, 8)
  i64* sref;  // (C, D, 8)
  i64* eids;  // (C, K)
  float* enear;  // (C, K)
  i64* en;  // (C,)
  int rows, tiles, depth, k_slots, iters;
};

__global__ void __launch_bounds__(kWarps * 32)
phase_a_walk_kernel(const Walk w) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= w.tiles) return;  // the whole warp
  bool done = w.done[c], paused = w.paused[c];
  if (done || paused) return;  // a fixed point of the walk
  i64 cur = w.cur[c], level = w.level[c], en = w.en[c];
  bool asc = w.asc[c];
  const float amax = w.amax[c];
  const int K = w.k_slots;

  float ox[kRays], oy[kRays], oz[kRays], ix[kRays], iy[kRays], iz[kRays];
  float tn[kRays], pr[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const size_t i = static_cast<size_t>(c) * kTile + lane + 32 * r;
    ox[r] = w.o[3 * i];
    oy[r] = w.o[3 * i + 1];
    oz[r] = w.o[3 * i + 2];
    ix[r] = w.inv_d[3 * i];
    iy[r] = w.inv_d[3 * i + 1];
    iz[r] = w.inv_d[3 * i + 2];
    tn[r] = w.tmin[i];
    pr[r] = w.prune[i];
  }
  const int slot = lane & (kSlots - 1);
  const bool owner = lane < kSlots;  // lanes 0-7 hold child slot `lane`

  for (int it = 0; it < w.iters; ++it) {
    const i64 lvl = level < 0 ? 0 : (level > w.depth - 1 ? w.depth - 1 : level);
    const size_t stack = (static_cast<size_t>(c) * w.depth + lvl) * kSlots + slot;
    bool has_child = false, a_has = false;
    i64 next = cur;
    if (!asc) {
      // Visit: slab-test the tile's rays against the node's 8 children.
      const i64 curc = cur < 0 ? 0 : (cur > w.rows - 1 ? w.rows - 1 : cur);
      const float* row = w.top + curc * (kSlots * kRow);
      const i64 ref = owner ? w.top_ref[curc * kSlots + slot] : 0;
      float best[kSlots];
      unsigned hits = 0;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(row + j * kRow));
        const float2 b = __ldg(reinterpret_cast<const float2*>(row + j * kRow + 4));
        best[j] = kInf;
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          const float t0x = (a.x - ox[r]) * ix[r], t1x = (a.w - ox[r]) * ix[r];
          const float t0y = (a.y - oy[r]) * iy[r], t1y = (b.x - oy[r]) * iy[r];
          const float t0z = (a.z - oz[r]) * iz[r], t1z = (b.y - oz[r]) * iz[r];
          const float near = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                                     min_nan(t0z, t1z));
          const float far = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)),
                                    max_nan(t0z, t1z));
          if (near <= far && far >= tn[r] && near < pr[r]) {
            hits |= 1u << j;
            best[j] = fminf(best[j], clamp_min0(near));
          }
        }
      }
      // Transposed butterfly: after the offsets 16, 8 and 4 each lane keeps
      // one child, j = (lane >> 2) & 7, folded over 8 lanes; 2 and 1 finish.
      const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float got = __shfl_xor_sync(kFull, b4 ? best[k] : best[k + 4], 16);
        best[k] = fminf(b4 ? best[k + 4] : best[k], got);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float got = __shfl_xor_sync(kFull, b3 ? best[k] : best[k + 2], 8);
        best[k] = fminf(b3 ? best[k + 2] : best[k], got);
      }
      {
        const float got = __shfl_xor_sync(kFull, b2 ? best[0] : best[1], 4);
        best[0] = fminf(b2 ? best[1] : best[0], got);
      }
      best[0] = fminf(best[0], __shfl_xor_sync(kFull, best[0], 2));
      best[0] = fminf(best[0], __shfl_xor_sync(kFull, best[0], 1));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) hits |= __shfl_xor_sync(kFull, hits, off);
      const float child_near = __shfl_sync(kFull, best[0], 4 * slot);
      const bool hit = owner && ((hits >> slot) & 1u);

      // Emit the hit treelet children in (near, slot) order.
      const float tkey = hit && ref <= -2 ? child_near : kInf;
      const unsigned live = __ballot_sync(kFull, owner && tkey < kInf) & 0xffu;
      int rank = 0;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const float ki = __shfl_sync(kFull, tkey, i);
        rank += (ki < tkey || (ki == tkey && i < slot)) ? 1 : 0;
      }
      if (owner && tkey < kInf && en + rank < K) {
        const size_t e = static_cast<size_t>(c) * K + en + rank;
        w.eids[e] = -2 - ref;
        w.enear[e] = tkey;
      }
      en += __popc(live);

      // Descend into the nearest hit inner child; park its siblings.
      float ikey = hit && ref >= 0 ? child_near : kInf;
      float cmin = ikey;
      int csel = slot;
      argmin8(cmin, csel);
      cmin = __shfl_sync(kFull, cmin, 0);
      csel = __shfl_sync(kFull, csel, 0);
      const i64 c_ref = __shfl_sync(kFull, ref, csel);
      has_child = cmin < kInf;
      if (has_child) {
        if (owner) {
          w.snear[stack] = slot == csel ? kInf : ikey;
          w.sref[stack] = ref;
        }
        next = c_ref;
      }
    } else {
      // Ascend: pop the nearest sibling below the loosest bound.
      const float s_near = owner ? w.snear[stack] : kInf;
      const i64 s_ref = owner ? w.sref[stack] : 0;
      float amin = s_near < amax ? s_near : kInf;
      int asel = slot;
      argmin8(amin, asel);
      amin = __shfl_sync(kFull, amin, 0);
      asel = __shfl_sync(kFull, asel, 0);
      const i64 a_ref = __shfl_sync(kFull, s_ref, asel);
      a_has = amin < kInf;
      if (a_has) {
        if (lane == asel) w.snear[stack] = kInf;
        next = a_ref;
      }
    }
    // Transitions: done reads the new level, paused the new done and en.
    const bool descend = has_child || a_has;
    const bool go_asc = !descend;  // a visit without a child, or a failed pop
    cur = next;
    level = descend ? lvl + 1 : level - 1;
    asc = go_asc;
    done = go_asc && level < 0;
    paused = !done && en > K - 8;
    if (done || paused) break;
  }
  if (lane == 0) {
    w.cur[c] = cur;
    w.level[c] = level;
    w.asc[c] = asc;
    w.done[c] = done;
    w.paused[c] = paused;
    w.en[c] = en;
  }
}

}  // namespace

// Runs `iters` iterations of the walk on every tile, one warp a tile, on
// `stream`, and returns cudaGetLastError(). Shapes as in struct Walk; all
// contiguous, top 16-byte aligned; depth >= 1, k_slots >= 8.
extern "C" int phase_a_walk_launch(const float* top, const i64* top_ref, const float* o,
                                   const float* inv_d, const float* tmin, const float* prune,
                                   const float* amax, i64* cur, i64* level, bool* asc,
                                   bool* done, bool* paused, float* snear, i64* sref,
                                   i64* eids, float* enear, i64* en, int rows, int tiles,
                                   int depth, int k_slots, int iters, void* stream) {
  if (tiles <= 0 || iters <= 0) return static_cast<int>(cudaSuccess);
  if (rows <= 0 || depth <= 0 || k_slots < kSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Walk w{top, top_ref, o, inv_d, tmin, prune, amax, cur, level, asc, done, paused,
               snear, sref, eids, enear, en, rows, tiles, depth, k_slots, iters};
  phase_a_walk_kernel<<<(tiles + kWarps - 1) / kWarps, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(w);
  return static_cast<int>(cudaGetLastError());
}
