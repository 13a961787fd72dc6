// The flat engine's any-hit (occlusion) query in one launch: the culled
// list of quarter-block emissions and the overflow sweep together.
//
// Replaces, for the occlusion query, the Pallas TPU kernel
// tracer/kernels/super_hits.py::hits2 in any-hit mode together with the
// loop of id-order overflow rounds that drives it
// (tracer/accel/flat.py:573-606). Plain C interface, loaded with ctypes
// from tracer_torch/kernels/super_occluded.py, whose twin route
// (occluded_reference: hits2_reference over the list, then the rounds)
// this kernel must match flag for flag.
//
// Contract (the twin route's result):
//   * a super-tile is 2048 rays = 16 sub-tiles of 128; a lane is blocked
//     iff its input flag is > 0 or some tested quarter block holds a
//     triangle that moller.cuh's test accepts in [tmin, bt) with t < 3e38;
//     the flag is then set to 1.0, and nothing else is written (the best t
//     row stays the input's);
//   * sub-tile s tests slot k < min(en, kd) of its culled list when bit s
//     of gm[k] is set and enear[k] < ub, and, for an overflowing
//     super-tile, the quarters [0, n_sweep) in id order when 0 < ub; ub is
//     the largest window top of the sub-tile's lanes that are not blocked.
// A flag is an OR over blocks, so neither the order of the tests nor the
// split of a sub-tile's blocks between CTAs can change it. The twin skips
// a test only where ub shows that no unblocked lane could hit (the entry
// distances are conservative), so testing a block here whether or not the
// twin's ub had fallen by then gives the same flags.
//
// Gates: the sweep's quarters are gated here per sub-tile with
// _sub_gates_raw's test (tracer_torch/accel/flat.py) on the quarter box
// grown by a margin: on each axis, kPad times the sum of the magnitudes of
// the box's bounds and of the sub-tile's origin bounds. The twin sweeps
// every quarter ungated, so a gate may close only where no lane of the
// sub-tile can hit, and the interval test alone is not enough for that: its
// round-to-nearest operations may shrink the interval by an ulp, and a
// Moller test in float32 accepts rays that pass an ulp or so outside the
// triangle (whose edges are rounded), hence outside its box, and puts its
// t a few ulps off. The margin, 2^-16 of the coordinates' magnitudes, is
// hundreds of times those errors (rays within ~2^-9 of a triangle's plane
// aside, whose Moller t is ill-conditioned) and a small fraction of a
// quarter's width. The operations run in the same order, each
// a round-to-nearest intrinsic, with PyTorch's NaN-propagating min and max,
// as super_occluded.sweep_gates (the plain version the tests hold to the
// twin's hits on rays that graze box faces and edges).
//
// What bounds it on an H100: operations. The shadowed dragon stand-in
// (800x450, 195 super-tiles, 34 overflowing, 5,772 quarters of 256
// triangles) gives the twin route ~1.1e9 live Moller tests in the list
// alone, each 38 FP32 operations with an IEEE division. Its earlier route
// was one B1 launch for the list and 16 for the sweep, each super-tile a
// serial chain of slots on one 2-CTA cluster, the sweep ungated. Design:
//   * work items, not chains: an item is (super-tile, sub-tile, chunk of
//     kChunk list slots or sweep quarters). The wrapper sorts the items,
//     sweep chunks first, and persistent CTAs take them from a counter
//     that the wrapper zeroes in the launch's stream, so all SMs share the
//     overflowing super-tiles' sweeps; the list items that follow find
//     most of their lanes blocked;
//   * an item loads its sub-tile's 128 rays, keeps the lanes that are not
//     blocked and whose window is open (tmin < bt), gathers its candidate
//     blocks (one slot or quarter per thread: gate bit or in-kernel gate,
//     then a ballot), and streams them through a double buffer in shared
//     memory (cp.async: the next candidate is in flight while the current
//     one is tested);
//   * each thread holds one triangle column of the staged quarter and tests
//     the live lanes against it (W columns by G lane groups when the
//     quarter has fewer than kThreads triangles); a lane found blocked is
//     skipped by the threads that reach it later;
//   * at each block boundary the item publishes its new flags
//     (st.relaxed.gpu) and re-reads the others' (ld.relaxed.gpu): a lane
//     blocked anywhere leaves every item, and an item ends when its
//     sub-tile has no live lane. Every writer stores 1.0f only, so the
//     result does not depend on the order; a stale read costs tests, never
//     a result. No float atomics, no host sync.
// Occupancy: 256 threads, 4 CTAs per SM (55 registers; the Moller test
// with its triangle in registers fits in the 64 this allows), ~38 KB of
// shared memory per CTA at 256 triangles a quarter (two 16 KB quarters,
// the rays and the lists): 32 warps per SM hide the staging and the
// divisions' latency. The constants were measured on the shadowed dragon
// (PERF.md, occluded_turns.py): items of 64 beat 16, 32, 128 and 256
// (shorter items spread a sub-tile's sweep further, but each item reloads
// its rays and the concurrent items test lanes before another blocks
// them), sweep chunks first beat list chunks first, 3 CTAs per SM were no
// faster, and starting each warp at its own place in the live list was
// slower.

#include <cuda_runtime.h>

#include <cstddef>

#include "moller.cuh"

namespace {

using tracer_torch::kInf;

constexpr int kSub = 128;                 // rays per sub-tile
constexpr int kNSub = 16;                 // sub-tiles per super-tile
constexpr int kRows = 16;                 // feature rows per quarter block
constexpr int kThreads = 256;             // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kLaneWarps = kSub / 32;     // warps that hold the item's lanes
constexpr int kChunk = 64;                // slots or quarters per work item
constexpr int kMinBlocks = 4;             // CTAs per SM
constexpr float kBig = 1.0e18f;           // flat._BIG
constexpr float kPad = 1.52587890625e-5f;  // 2^-16, super_occluded.GATE_PAD

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

// A lane's flag as the other CTAs last published it (bypasses L1).
__device__ __forceinline__ float load_flag(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_blocked(float* p) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;\n" ::"l"(p), "f"(1.0f) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// torch.minimum / torch.maximum: NaN when either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// flat._imul: the interval product [x_lo, x_hi] * [y_lo, y_hi].
__device__ __forceinline__ void imul(float x_lo, float x_hi, float y_lo, float y_hi,
                                     float& lo, float& hi) {
  const float p1 = __fmul_rn(x_lo, y_lo), p2 = __fmul_rn(x_lo, y_hi);
  const float p3 = __fmul_rn(x_hi, y_lo), p4 = __fmul_rn(x_hi, y_hi);
  lo = nan_min(nan_min(p1, p2), nan_min(p3, p4));
  hi = nan_max(nan_max(p1, p2), nan_max(p3, p4));
}

// _sub_gates_raw for one (sub-tile, quarter) pair, the box grown by the
// margin (super_occluded.sweep_gates): sb is the sub-tile's packed bounds
// row [o_lo3, o_hi3, d_lo3, d_hi3, tmin_lo, alive, window top, pad], box
// the quarter's [lo3, hi3].
__device__ __forceinline__ bool quarter_gate(const float* __restrict__ sb,
                                             const float* __restrict__ box) {
  float near = 0.0f, far = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float o_lo = sb[k], o_hi = sb[3 + k], d_lo = sb[6 + k], d_hi = sb[9 + k];
    const float m = __fmul_rn(kPad, __fadd_rn(__fadd_rn(fabsf(box[k]), fabsf(box[3 + k])),
                                              __fadd_rn(fabsf(o_lo), fabsf(o_hi))));
    const float lo = __fsub_rn(box[k], m), hi = __fadd_rn(box[3 + k], m);
    const float a_lo = __fsub_rn(lo, o_hi), a_hi = __fsub_rn(lo, o_lo);
    const float b_lo = __fsub_rn(hi, o_hi), b_hi = __fsub_rn(hi, o_lo);
    const bool definite = (d_lo > 0.0f) || (d_hi < 0.0f);
    const float inv_lo = __frcp_rn(definite ? d_hi : 1.0f);
    const float inv_hi = __frcp_rn(definite ? d_lo : 1.0f);
    float t0_lo, t0_hi, t1_lo, t1_hi;
    imul(a_lo, a_hi, inv_lo, inv_hi, t0_lo, t0_hi);
    imul(b_lo, b_hi, inv_lo, inv_hi, t1_lo, t1_hi);
    const float near_def = nan_min(t0_lo, t1_lo);
    const float far_def = nan_max(t0_hi, t1_hi);
    const float gap = nan_max(nan_max(a_lo, -b_hi), 0.0f);
    const float amax = nan_max(nan_max(-d_lo, d_hi), 1e-30f);
    const float near_k = definite ? near_def : __fdiv_rn(gap, amax);
    const float far_k = definite ? far_def : kBig;
    near = k == 0 ? near_k : nan_max(near, near_k);
    far = k == 0 ? far_k : nan_min(far, far_k);
  }
  near = nan_max(near, 0.0f);
  return near <= far && far >= sb[12] && near < sb[14] && sb[13] > 0.5f;
}

// One CTA's shared memory, carved from the dynamic allocation in this
// order (the double buffer first: cp.async writes it 16 bytes at a time).
struct Shared {
  float* quarters;  // [2][kRows * tq] candidate blocks, row-major as in global
  float4* ray;      // [kSub][2] ox oy oz dx | dy dz tmin bt
  int* live;        // [kSub] the item's live lanes, in lane order
  int* hit;         // [kSub] 1 once a test of this CTA blocks the lane
  int* cand_q;      // [kChunk] candidate quarter ids, in slot or id order
  float* cand_e;    // [kChunk] their entry distances (0 in the sweep)
  unsigned* ball;   // [kWarps] ballots
  float* ubw;       // [kLaneWarps] per-warp window tops
  int* item;        // [1] the CTA's current work item
};

__host__ __device__ __forceinline__ size_t shared_bytes(int tq) {
  return sizeof(float) * 2 * kRows * tq + sizeof(float4) * 2 * kSub +
         sizeof(int) * 2 * kSub + (sizeof(int) + sizeof(float)) * kChunk +
         sizeof(unsigned) * kWarps + sizeof(float) * kLaneWarps + sizeof(int);
}

__device__ __forceinline__ Shared carve(unsigned char* base, int tq) {
  Shared sh;
  sh.quarters = reinterpret_cast<float*>(base);
  sh.ray = reinterpret_cast<float4*>(sh.quarters + 2 * kRows * tq);
  sh.live = reinterpret_cast<int*>(sh.ray + 2 * kSub);
  sh.hit = sh.live + kSub;
  sh.cand_q = sh.hit + kSub;
  sh.cand_e = reinterpret_cast<float*>(sh.cand_q + kChunk);
  sh.ball = reinterpret_cast<unsigned*>(sh.cand_e + kChunk);
  sh.ubw = reinterpret_cast<float*>(sh.ball + kWarps);
  sh.item = reinterpret_cast<int*>(sh.ubw + kLaneWarps);
  return sh;
}

// All threads: start copying one quarter block (n floats) into dst, as one
// commit group.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n / 4; i += kThreads) cp_async16(d4 + i, s4 + i);
  cp_async_commit();
}

// All threads: the live list from each lane thread's `live` (threads below
// kSub own lane threadIdx.x), the live count and the sub-tile's bound ub
// (the largest `top` of the lane threads). Two barriers.
__device__ __forceinline__ void gather_live(const Shared& sh, bool live, float top,
                                            int& n_live, float& ub) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  if (w < kLaneWarps) {
    const unsigned b = __ballot_sync(0xffffffffu, live);
    const float m = warp_max(top);
    if (lane == 0) {
      sh.ball[w] = b;
      sh.ubw[w] = m;
    }
  }
  __syncthreads();
  n_live = 0;
  ub = -kInf;
  int base = 0;
#pragma unroll
  for (int i = 0; i < kLaneWarps; ++i) {
    const int c = __popc(sh.ball[i]);
    base += i < w ? c : 0;
    n_live += c;
    ub = fmaxf(ub, sh.ubw[i]);
  }
  if (live) sh.live[base + __popc(sh.ball[w] & ((1u << lane) - 1u))] = t;
  __syncthreads();
}

// All threads: test the live lanes against the staged quarter `blk`
// (tq triangles). Thread t holds column t % W and takes the lanes
// t / W, t / W + G, ... of the live list.
__device__ __forceinline__ void test_quarter(const Shared& sh, const float* blk, int tq,
                                             int n_live) {
  const int W = tq < kThreads ? tq : kThreads;
  const int G = kThreads / W;
  const int g = threadIdx.x / W;
  if (g >= G) return;
  volatile int* hit = sh.hit;
  for (int c = threadIdx.x - g * W; c < tq; c += W) {
    const tracer_torch::Triangle tri = tracer_torch::load_triangle(blk, tq, c);
    for (int i = g; i < n_live; i += G) {
      const int l = sh.live[i];
      if (hit[l]) continue;
      const float4 a = sh.ray[2 * l], b = sh.ray[2 * l + 1];
      if (tracer_torch::moller_t(tri, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w) < kInf) {
        hit[l] = 1;
      }
    }
  }
}

struct Args {
  const int* __restrict__ ids;      // (n_super, kd) quarter ids, near-ordered
  const int* __restrict__ en;       // (n_super,) emission counts
  const float* __restrict__ enear;  // (n_super, kd) entry distances
  const int* __restrict__ gm;       // (n_super, kd) 16-bit gate words
  const float* __restrict__ qblocks;  // (ntq, 16, tq)
  const float* __restrict__ qbox;     // (ntq, 6) quarter boxes
  const float* __restrict__ sb;       // (n_super * 16, 16) sub-tile bounds
  const float* __restrict__ rays;     // (n_super * 2048, 8)
  const int* __restrict__ order;      // (n_items,) work items, longest first
  const int* __restrict__ key;        // (n_items,) their sorted keys (0: none)
  int* ticket;                        // next item to take (0 at launch)
  float* flags;                       // (n_super * 2048,) blocked flags
  unsigned long long* counts;         // null, or items, visits, live tests
  int n_items, kd, ntq, tq, ncl, nch, n_sweep;
};

// All threads of a CTA: one work item.
__device__ __forceinline__ void run_item(const Shared& sh, const Args& a, int item) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int us = item / a.nch, ch = item - us * a.nch;  // us = super * 16 + sub
  const int u = us / kNSub, s = us - u * kNSub;
  float* flag = a.flags + static_cast<size_t>(us) * kSub;

  // The sub-tile's rays; a lane is live while unblocked with tmin < bt.
  bool live = false;
  float top = -kInf, bt0 = 0.0f;
  if (t < kSub) {
    const float4* src = reinterpret_cast<const float4*>(a.rays) +
                        (static_cast<size_t>(us) * kSub + t) * 2;
    const float4 r0 = src[0], r1 = src[1];
    sh.ray[2 * t] = r0;
    sh.ray[2 * t + 1] = r1;
    sh.hit[t] = 0;
    bt0 = r1.w;
    const bool blocked = load_flag(flag + t) > 0.0f;
    live = !blocked && r1.z < bt0;
    top = blocked ? -kInf : bt0;
  }
  int n_live;
  float ub;
  gather_live(sh, live, top, n_live, ub);
  if (t == 0 && a.counts != nullptr) atomicAdd(a.counts, 1ull);
  if (n_live == 0) return;

  // Candidates: one list slot or sweep quarter per thread, kept in order.
  const bool in_list = ch < a.ncl;
  int start, end;
  if (in_list) {
    start = ch * kChunk;
    end = min(start + kChunk, min(a.en[u], a.kd));
  } else {
    start = (ch - a.ncl) * kChunk;
    end = min(start + kChunk, a.n_sweep);
  }
  bool ok = false;
  int q = 0;
  float e = 0.0f;
  const int i = start + t;
  if (t < kChunk && i < end) {
    if (in_list) {
      const size_t k = static_cast<size_t>(u) * a.kd + i;
      e = a.enear[k];
      ok = ((a.gm[k] >> s) & 1) && e < ub;
      q = min(max(a.ids[k], 0), a.ntq - 1);
    } else {
      q = i;
      ok = 0.0f < ub && quarter_gate(a.sb + static_cast<size_t>(us) * 16,
                                      a.qbox + static_cast<size_t>(q) * 6);
    }
  }
  const unsigned b = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) sh.ball[w] = b;
  __syncthreads();
  int nc = 0, base = 0;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) {
    const int c = __popc(sh.ball[j]);
    base += j < w ? c : 0;
    nc += c;
  }
  if (ok) {
    const int p = base + __popc(b & ((1u << lane) - 1u));
    sh.cand_q[p] = q;
    sh.cand_e[p] = e;
  }
  __syncthreads();
  if (nc == 0) return;

  // Stream the candidates through the double buffer.
  const int qsz = kRows * a.tq;
  stage(sh.quarters, a.qblocks + static_cast<size_t>(sh.cand_q[0]) * qsz, qsz);
  for (int c = 0; c < nc; ++c) {
    const float* cur = sh.quarters + (c & 1) * qsz;
    if (c + 1 < nc) {
      stage(sh.quarters + ((c + 1) & 1) * qsz,
            a.qblocks + static_cast<size_t>(sh.cand_q[c + 1]) * qsz, qsz);
    } else {
      cp_async_commit();  // an empty group keeps the wait count uniform
    }
    cp_async_wait<1>();
    __syncthreads();  // candidate c staged by every thread
    if (!(sh.cand_e[c] < ub)) continue;  // ub is block-uniform
    test_quarter(sh, cur, a.tq, n_live);
    if (t == 0 && a.counts != nullptr) {
      atomicAdd(a.counts + 1, 1ull);
      atomicAdd(a.counts + 2, static_cast<unsigned long long>(n_live) * a.tq);
    }
    __syncthreads();  // every test of the block done
    // Publish this CTA's hits and take the others'.
    if (live) {
      if (sh.hit[t]) {
        store_blocked(flag + t);
        live = false;
      } else if (load_flag(flag + t) > 0.0f) {
        live = false;
      }
      if (!live) top = -kInf;
    }
    gather_live(sh, live, top, n_live, ub);
    if (n_live == 0) break;
  }
  cp_async_wait<0>();  // retire a copy started for a candidate left untested
  __syncthreads();
}

// Persistent CTAs: each takes work items order[j] from the counter until
// the keys run out (the counter decides only which CTA runs which item).
__global__ void __launch_bounds__(kThreads, kMinBlocks) super_occluded_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = carve(smem, a.tq);
  for (;;) {
    if (threadIdx.x == 0) {
      const int j = atomicAdd(a.ticket, 1);
      *sh.item = j < a.n_items && a.key[j] > 0 ? a.order[j] : -1;
    }
    __syncthreads();
    const int item = *sh.item;
    __syncthreads();  // every thread has read the item before it is rewritten
    if (item < 0) break;
    run_item(sh, a, item);
  }
}

}  // namespace

// Launches persistent CTAs (as many as fit on the card, at most n_items)
// of kThreads threads on `stream`; they take work items in the order of
// `order` from the counter `ticket` (one int, zero at launch) while
// key > 0. An item (super * 16 + sub) * nch + chunk runs the chunk's list
// slots (chunk < ncl) or sweep quarters (chunk >= ncl, ids below n_sweep).
// Shapes: ids/enear/gm (n_super, kd) i32/f32/i32, en (n_super,) i32,
// qblocks (ntq, 16, tq) f32 with tq a multiple of 4, qbox (ntq, 6) f32, sb
// (n_super * 16, 16) f32 (sub_bounds with the window top in column 14),
// rays (n_super * 2048, 8) f32 [o, d, tmin, bt], flags (n_super * 2048) f32
// (updated in place), counts null or 3 u64 (added to); all contiguous,
// qblocks 16-byte aligned. Returns the first CUDA error (a refused launch
// included).
extern "C" int super_occluded_launch(const int* ids, const int* en, const float* enear,
                                     const int* gm, const float* qblocks,
                                     const float* qbox, const float* sb,
                                     const float* rays, const int* order,
                                     const int* key, int* ticket, float* flags,
                                     unsigned long long* counts, int n_items, int kd,
                                     int ntq, int tq, int ncl, int nch, int n_sweep,
                                     void* stream) {
  if (n_items <= 0) return static_cast<int>(cudaSuccess);
  if (tq <= 0 || tq % 4 != 0 || ntq <= 0 || kd < 0 || ncl < 0 || nch < ncl ||
      n_sweep < 0 || n_sweep > ntq) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = shared_bytes(tq);
  cudaError_t e = cudaFuncSetAttribute(
      super_occluded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, super_occluded_kernel,
                                                      kThreads, smem);
  }
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();  // leave no stale error for the next launch's check
    return static_cast<int>(e);
  }
  const int fit = sms * per_sm;
  const int blocks = n_items < fit ? n_items : fit;
  Args a{ids, en, enear, gm, qblocks, qbox, sb, rays, order, key, ticket, flags, counts,
         n_items, kd, ntq, tq, ncl, nch, n_sweep};
  super_occluded_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
