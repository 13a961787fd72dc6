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
// grown by a margin. The twin sweeps every quarter ungated, so a gate may
// close only where no lane of the sub-tile can pass moller_t against a
// valid triangle of the quarter. On axis k the margin is
//   m_k = kPad * mag_k + kCondPad * G * cond / c_lo,
// mag_k = |lo_k| + |hi_k| + |o_lo_k| + |o_hi_k| (box and origin bounds);
// G = A + W + M / 8, summed over the axes: A of max(hi_k - o_lo_k,
// o_hi_k - lo_k) (no origin is farther from a box point), W of
// hi_k - lo_k, M of max(|lo_k|, |hi_k|) + max(|o_lo_k|, |o_hi_k|); cond
// the quarter's largest |e0| |e1| / |n|; c_lo a lower bound on
// cos = |n . d| / (|n| |d|) over the quarter's box of unit normals and the
// sub-tile's direction box (cond and the normal box from
// treelet.quarter_normals, rounded outward; the interval dot product less
// kCosSlack times its terms' magnitudes, over the largest |d|). Where
// c_lo <= kCosFloor * cond or the second term reaches L = sum of mag_k,
// the triangle pass takes the quarter's triangles one by one: the second
// term becomes kCondPad * G * R, R^2 the largest |e0|^2 |e1|^2 |d|^2 /
// |n . d|^2 over them (|n . d| bounded below over the direction box as
// c_lo is, |d| by the box's largest), and the gate is open only where
// some triangle's bound on |n . d| is not above 0, R reaches 1 / kCosFloor
// or that term too reaches L. On the shadowed dragon the normal box of a
// quarter that the light's terminator crosses straddles the plane normal
// to the light; without the pass every such quarter was open to every
// overflowing sub-tile (11.5% of the sweep's pairs against 3.5%,
// PERF.md).
//
// The bound (u = 2^-24, round to nearest, no underflow or overflow;
// coordinates and 1 / |d| below 2^50). Take a lane (o, d) and a triangle
// (v0, v1, v2, all inside the box) whose moller_t accepts t' in [tmin, bt).
// Roundings counted: the stored rows (assemble_blocks, or XLA with or
// without FMA) e_i = fl(v_i - v0), within u |v_i - v0|; n = fl(e0 x e1),
// within sqrt2 g2 |e0| |e1|; k = fl(v0 . n), within g3 |v0| |n|
// (g_j = j u / (1 - j u)). moller_t: n . d and n . o 5 each, the
// reciprocal 1, k - n . o 1, t 1; s = fl(v0 - o) 1, nom = s x d 2 more,
// nom . e_i 5, beta and gamma 1 each, beta + gamma 1. With S = v0 - o,
// |S| <= A, |e_i| <= W, |v0| + |o| <= M, and c' = cos - sqrt2 g2 cond, the
// point P' = o + t' d is, to first order in u, away from the triangle by:
//   * 2 (1 + sqrt2) g3 |S| cond / c' from the line's crossing X of the
//     plane of (v0, e0, e1) inside that triangle (the errors of nom . e_i
//     over n . d, times |e_j|);
//   * (3 u + (sqrt2 g2 cond + g3) / c') W more from beta + gamma <= 1 + u
//     and the ratio of fl(n . d) to (e0 x e1) . d; u W from e_i's rounding;
//   * |t' - t_X| |d| <= (A + W) (g3 + (sqrt2 g2 cond + g3) / c')
//     + (sqrt2 g2 cond A + g3 M) / c' along the ray.
// The sum is at most u cond / c' (26.2 A + 18.7 W + 3 M) (cond >= 1 - 3 u,
// c' <= 1). c_lo > kCosFloor cond = 256 u cond gives c' >= 0.988 cos, so
// P' lies within u cond / cos (26.6 A + 19 W + 3.1 M) of the triangle,
// hence of the box, on every axis. c_lo is at most cos (1 + 5 u)
// (kCosSlack = 16 u covers the dot product's 3 u), so the second term,
// kCondPad cond / c_lo (A + W + M / 8) = 32 u cond / c_lo (A + W + M / 8),
// exceeds that by a fifth: room for its own roundings and for the interval
// test's rounding in proportion to it. The triangle pass bounds cond / cos
// = |e0| |e1| |d| / |n . d| of each triangle by R within 10 u, the same way
// (R < 1 / kCosFloor gives c' >= 0.988 cos); the argument holds triangle
// by triangle, and the box holds every triangle. The first
// term, kPad = 256 u of mag_k, covers the interval test's own rounding in
// proportion to the coordinates (each entry or exit distance is two
// rounded differences times a rounded reciprocal, within 12 u (mag_k +
// m_k) in space). So the test's [near, far] holds t', which lies in
// [tmin_lo, window top): the gate is open. The factor cond / cos is what
// no margin in proportion to the coordinates bounds: rays at cos 2^-20 to
// a triangle's normal pass moller_t up to 2^-6 L outside the quarter's
// box, at 2^-24 up to 2^-2.8 L ("coplanar" in chip_smoke.OCCLUSION_CASES).
// On those cases and the grazing ones the largest such distance is 4.8%
// of the bound (tests/test_torch_occluded.py holds every accepted point
// to it).
//
// The operations run in the same order, each a round-to-nearest intrinsic,
// with PyTorch's NaN-propagating min and max (a NaN anywhere in c_lo or the
// second term opens the gate), as super_occluded.sweep_gates, the plain
// version the tests hold to the twin's hits.
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
//     the triangle pass of the quarters that need it spread over the
//     whole CTA, then a ballot), and streams them through a double buffer
//     in shared memory (cp.async: the next candidate is in flight while
//     the current one is tested);
//   * each thread holds one triangle column of the staged quarter and tests
//     the live lanes against it (W columns by G lane groups when the
//     quarter has fewer than kThreads triangles); a lane found blocked is
//     skipped by the threads that reach it later;
//   * at each block boundary the item publishes its new flags
//     (st.relaxed.gpu) and re-reads the others' (ld.relaxed.gpu): a lane
//     blocked anywhere leaves every item, and an item ends when its
//     sub-tile has no live lane. Every writer stores 1.0f only, so the
//     result does not depend on the order; a stale read costs tests, never
//     a result. No float atomics (the triangle pass folds its maximum with
//     an integer atomicMax on the bits, which no order changes), no host
//     sync.
// Occupancy: 256 threads, 4 CTAs per SM (64 registers, the most this
// allows, with the sweep gate; 55 without), ~38 KB of
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
constexpr float kPad = 1.52587890625e-5f;       // 2^-16, super_occluded.GATE_PAD
constexpr float kCondPad = 1.9073486328125e-6f;  // 2^-19, super_occluded.COND_PAD
constexpr float kCosFloor = 1.52587890625e-5f;    // 2^-16, super_occluded.COS_FLOOR
constexpr float kRatioCap = 4294967296.0f;        // 2^32 = COS_FLOOR^-2
constexpr float kCosSlack = 9.5367431640625e-7f;  // 2^-20, super_occluded.COS_SLACK

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

// x[0] + x[1] + x[2], in that order.
__device__ __forceinline__ float axes(const float* x) {
  return __fadd_rn(__fadd_rn(x[0], x[1]), x[2]);
}

// flat._imul: the interval product [x_lo, x_hi] * [y_lo, y_hi].
__device__ __forceinline__ void imul(float x_lo, float x_hi, float y_lo, float y_hi,
                                     float& lo, float& hi) {
  const float p1 = __fmul_rn(x_lo, y_lo), p2 = __fmul_rn(x_lo, y_hi);
  const float p3 = __fmul_rn(x_hi, y_lo), p4 = __fmul_rn(x_hi, y_hi);
  lo = nan_min(nan_min(p1, p2), nan_min(p3, p4));
  hi = nan_max(nan_max(p1, p2), nan_max(p3, p4));
}

// The interval dot product of [n_lo, n_hi] and [d_lo, d_hi]: its lower
// bound on |n . d| less kCosSlack times its terms' magnitudes
// (super_occluded._cos_terms).
__device__ __forceinline__ float cos_terms(const float* n_lo, const float* n_hi,
                                           const float* d_lo, const float* d_hi) {
  float p_lo[3], p_hi[3], terms[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    imul(n_lo[k], n_hi[k], d_lo[k], d_hi[k], p_lo[k], p_hi[k]);
    terms[k] = __fmul_rn(nan_max(fabsf(n_lo[k]), fabsf(n_hi[k])),
                         nan_max(fabsf(d_lo[k]), fabsf(d_hi[k])));
  }
  return __fsub_rn(nan_max(axes(p_lo), -axes(p_hi)), __fmul_rn(kCosSlack, axes(terms)));
}

// One triangle of the triangle pass (super_occluded._triangle_margins):
// column c of the quarter block blk (tq columns) against the direction box
// [d_lo, d_hi] with dd its largest |d|^2. Returns 0 for a slot that is not
// valid or has n = 0 (it never hits), -1 where the bound l on |n . d| is
// not above 0, else 1 with r2 = |e0|^2 |e1|^2 dd / l^2 (l = cos_terms(n,
// n, d)).
__device__ __forceinline__ int triangle_r2(const float* __restrict__ blk, int tq, int c,
                                           const float* d_lo, const float* d_hi, float dd,
                                           float& r2) {
  float n[3], s0[3], s1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    n[k] = blk[(11 + k) * tq + c];
    const float e0 = blk[(3 + k) * tq + c], e1 = blk[(6 + k) * tq + c];
    s0[k] = __fmul_rn(e0, e0);
    s1[k] = __fmul_rn(e1, e1);
  }
  if (!(blk[10 * tq + c] > 0.5f) || (n[0] == 0.0f && n[1] == 0.0f && n[2] == 0.0f)) return 0;
  const float l = cos_terms(n, n, d_lo, d_hi);
  if (!(l > 0.0f)) return -1;
  r2 = __fmul_rn(__fdiv_rn(__fmul_rn(axes(s0), axes(s1)), __fmul_rn(l, l)), dd);
  return 1;
}

// The first part of a pair's gate: the box margins' magnitudes mag_k, their
// sum L (total), G (g) and the second term from the quarter's normal box
// (extra). Returns true where that term is of no use and the quarter has
// a triangle that can hit, so that the gate needs the triangle pass.
__device__ __forceinline__ bool quarter_margin(const float* __restrict__ sb,
                                               const float* __restrict__ box,
                                               const float* __restrict__ qn, float* mag,
                                               float& total, float& g, float& extra) {
  float d_sq[3], far_o[3], w[3], big[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = box[k], hi = box[3 + k], o_lo = sb[k], o_hi = sb[3 + k];
    mag[k] = __fadd_rn(__fadd_rn(fabsf(lo), fabsf(hi)), __fadd_rn(fabsf(o_lo), fabsf(o_hi)));
    far_o[k] = nan_max(__fsub_rn(hi, o_lo), __fsub_rn(o_hi, lo));
    w[k] = __fsub_rn(hi, lo);
    big[k] = __fadd_rn(nan_max(fabsf(lo), fabsf(hi)), nan_max(fabsf(o_lo), fabsf(o_hi)));
    d_sq[k] = nan_max(__fmul_rn(sb[6 + k], sb[6 + k]), __fmul_rn(sb[9 + k], sb[9 + k]));
  }
  g = __fadd_rn(__fadd_rn(axes(far_o), axes(w)), __fmul_rn(0.125f, axes(big)));
  const float c_lo = __fdiv_rn(cos_terms(qn, qn + 3, sb + 6, sb + 9), __fsqrt_rn(axes(d_sq)));
  const float cond = qn[6];
  total = axes(mag);
  extra = __fdiv_rn(__fmul_rn(kCondPad, __fmul_rn(g, cond)), c_lo);
  const bool has = cond > 0.0f && sb[13] > 0.5f;
  const bool useful = has && c_lo > __fmul_rn(kCosFloor, cond) && extra < total;
  if (!useful) extra = 0.0f;
  return has && !useful;
}

// The sweep's gate of one (sub-tile, quarter) pair
// (super_occluded.sweep_gates): _sub_gates_raw's test on the quarter box
// grown on each axis k by kPad * mag_k + kCondPad * G * cond / c_lo or,
// where that second term is of no use, by kCondPad * G * sqrt(r2max) of
// the triangle pass (pass: -1 where it found a triangle whose bound on
// |n . d| is not above 0, else 1; r2max its largest r2, 0 for none); open
// where that too is of no use (see the bound at the top). sb is the
// sub-tile's packed bounds row [o_lo3, o_hi3, d_lo3, d_hi3, tmin_lo, alive,
// window top, pad], box the quarter's [lo3, hi3], qn its [n_lo3, n_hi3,
// cond, pad].
__device__ __forceinline__ bool quarter_gate(const float* __restrict__ sb,
                                             const float* __restrict__ box,
                                             const float* __restrict__ qn, int pass,
                                             float r2max) {
  float mag[3], total, g, extra;
  bool opened = false;
  if (quarter_margin(sb, box, qn, mag, total, g, extra)) {
    const float e2 = __fmul_rn(kCondPad, __fmul_rn(g, __fsqrt_rn(r2max)));
    const bool useful2 = pass > 0 && r2max < kRatioCap && e2 < total;
    extra = useful2 ? e2 : 0.0f;
    opened = !useful2;
  }
  float near = 0.0f, far = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float o_lo = sb[k], o_hi = sb[3 + k], d_lo = sb[6 + k], d_hi = sb[9 + k];
    const float m = __fadd_rn(__fmul_rn(kPad, mag[k]), extra);
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
  const bool hit = near <= far && far >= sb[12] && near < sb[14];
  return (hit || opened) && sb[13] > 0.5f;
}

// The scratch of sweep_chunk_gates, in shared memory.
struct GateScratch {
  unsigned ball[kWarps];
  int slot[kChunk];  // the chunk's quarters that need the triangle pass
  int pass[kChunk];  // per thread's quarter: 1, or -1 once a triangle is refused
  int r2[kChunk];    // per thread's quarter: the largest r2's bits (r2 >= 0)
};

// All threads: the sweep gates of sub-tile row sb against the quarters
// [start, end) (at most kChunk), thread t < kChunk taking quarter
// start + t (false for the others and where `live` is false). The quarters
// whose normal box is of no use get the triangle pass from the whole CTA:
// their tq triangles spread over the threads, the largest r2 folded with
// atomicMax on its bits (r2 is never negative; a NaN's bits are the
// largest), any refused triangle recorded; that is the plain version's
// max over the triangles. Three barriers, four when a pass runs.
__device__ bool sweep_chunk_gates(GateScratch& sc, const float* __restrict__ qbox,
                                  const float* __restrict__ qnorm,
                                  const float* __restrict__ qblocks, int tq,
                                  const float* __restrict__ sb, int start, int end,
                                  bool live) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int q = start + t;
  const bool mine = live && t < kChunk && q < end;
  bool pass = false;
  if (mine) {
    float mag[3], total, g, extra;
    pass = quarter_margin(sb, qbox + static_cast<size_t>(q) * 6,
                          qnorm + static_cast<size_t>(q) * 8, mag, total, g, extra);
  }
  if (t < kChunk) {
    sc.pass[t] = 1;
    sc.r2[t] = 0;
  }
  const unsigned b = __ballot_sync(0xffffffffu, pass);
  if (lane == 0) sc.ball[w] = b;
  __syncthreads();
  int n_pass = 0, base = 0;
#pragma unroll
  for (int j = 0; j < kChunk / 32; ++j) {
    const int c = __popc(sc.ball[j]);
    base += j < w ? c : 0;
    n_pass += c;
  }
  if (pass) sc.slot[base + __popc(b & ((1u << lane) - 1u))] = t;
  __syncthreads();
  if (n_pass > 0) {
    float d_sq[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d_sq[k] = nan_max(__fmul_rn(sb[6 + k], sb[6 + k]), __fmul_rn(sb[9 + k], sb[9 + k]));
    }
    const float dd = axes(d_sq);
    for (int i = t; i < n_pass * tq; i += kThreads) {
      const int j = i / tq, c = i - j * tq, u = sc.slot[j];
      float r2;
      const int st = triangle_r2(qblocks + static_cast<size_t>(start + u) * kRows * tq, tq, c,
                                 sb + 6, sb + 9, dd, r2);
      if (st < 0) {
        sc.pass[u] = -1;
      } else if (st > 0) {
        atomicMax(&sc.r2[u], __float_as_int(r2));
      }
    }
    __syncthreads();
  }
  const bool ok = mine && quarter_gate(sb, qbox + static_cast<size_t>(q) * 6,
                                       qnorm + static_cast<size_t>(q) * 8,
                                       t < kChunk ? sc.pass[t] : 1,
                                       __int_as_float(t < kChunk ? sc.r2[t] : 0));
  __syncthreads();  // the scratch is read before the next chunk rewrites it
  return ok;
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
  GateScratch* gate;  // [1] the sweep gates' scratch
  int* item;        // [1] the CTA's current work item
};

__host__ __device__ __forceinline__ size_t shared_bytes(int tq) {
  return sizeof(float) * 2 * kRows * tq + sizeof(float4) * 2 * kSub +
         sizeof(int) * 2 * kSub + (sizeof(int) + sizeof(float)) * kChunk +
         sizeof(unsigned) * kWarps + sizeof(float) * kLaneWarps + sizeof(GateScratch) +
         sizeof(int);
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
  sh.gate = reinterpret_cast<GateScratch*>(sh.ubw + kLaneWarps);
  sh.item = reinterpret_cast<int*>(sh.gate + 1);
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
  const float* __restrict__ qnorm;    // (ntq, 8) quarter normal boxes and cond
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
  int q = start + t;
  float e = 0.0f;
  if (in_list) {
    if (t < kChunk && q < end) {
      const size_t k = static_cast<size_t>(u) * a.kd + q;
      e = a.enear[k];
      ok = ((a.gm[k] >> s) & 1) && e < ub;
      q = min(max(a.ids[k], 0), a.ntq - 1);
    }
  } else {  // in_list and ub are the same for every thread
    ok = sweep_chunk_gates(*sh.gate, a.qbox, a.qnorm, a.qblocks, a.tq,
                           a.sb + static_cast<size_t>(us) * 16, start, end, 0.0f < ub);
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

// One CTA per (sub-tile, chunk of kChunk quarters): the sweep's gates,
// 1 or 0, through the query's own sweep_chunk_gates.
__global__ void __launch_bounds__(kThreads) super_occluded_gates_kernel(
    const float* __restrict__ sb, const float* __restrict__ qbox,
    const float* __restrict__ qnorm, const float* __restrict__ qblocks,
    unsigned char* __restrict__ out, int ntq, int tq) {
  __shared__ GateScratch sc;
  const int nch = (ntq + kChunk - 1) / kChunk;
  const int us = blockIdx.x / nch, start = (blockIdx.x - us * nch) * kChunk;
  const int end = min(start + kChunk, ntq);
  const bool ok = sweep_chunk_gates(sc, qbox, qnorm, qblocks, tq,
                                    sb + static_cast<size_t>(us) * 16, start, end, true);
  if (static_cast<int>(threadIdx.x) < end - start) {
    out[static_cast<size_t>(us) * ntq + start + threadIdx.x] = ok ? 1 : 0;
  }
}

}  // namespace

// The sweep's gate of every (sub-tile, quarter) pair, as the query's
// kernel evaluates it (sweep_chunk_gates), into out (n_sub, ntq) u8: for the
// checks that hold it to super_occluded.sweep_gates. sb as below, n_sub
// rows; qbox, qnorm and qblocks as below. Returns the first CUDA error.
extern "C" int super_occluded_gates_launch(const float* sb, const float* qbox,
                                           const float* qnorm, const float* qblocks,
                                           unsigned char* out, int n_sub, int ntq, int tq,
                                           void* stream) {
  if (n_sub <= 0 || ntq <= 0) return static_cast<int>(cudaSuccess);
  if (tq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t blocks = static_cast<size_t>(n_sub) * ((ntq + kChunk - 1) / kChunk);
  super_occluded_gates_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(sb, qbox, qnorm, qblocks,
                                                                     out, ntq, tq);
  return static_cast<int>(cudaGetLastError());
}

// Launches persistent CTAs (as many as fit on the card, at most n_items)
// of kThreads threads on `stream`; they take work items in the order of
// `order` from the counter `ticket` (one int, zero at launch) while
// key > 0. An item (super * 16 + sub) * nch + chunk runs the chunk's list
// slots (chunk < ncl) or sweep quarters (chunk >= ncl, ids below n_sweep).
// Shapes: ids/enear/gm (n_super, kd) i32/f32/i32, en (n_super,) i32,
// qblocks (ntq, 16, tq) f32 with tq a multiple of 4, qbox (ntq, 6) f32,
// qnorm (ntq, 8) f32 (treelet.quarter_normals), sb
// (n_super * 16, 16) f32 (sub_bounds with the window top in column 14),
// rays (n_super * 2048, 8) f32 [o, d, tmin, bt], flags (n_super * 2048) f32
// (updated in place), counts null or 3 u64 (added to); all contiguous,
// qblocks 16-byte aligned. Returns the first CUDA error (a refused launch
// included).
extern "C" int super_occluded_launch(const int* ids, const int* en, const float* enear,
                                     const int* gm, const float* qblocks,
                                     const float* qbox, const float* qnorm,
                                     const float* sb,
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
  Args a{ids, en, enear, gm, qblocks, qbox, qnorm, sb, rays, order, key, ticket, flags, counts,
         n_items, kd, ntq, tq, ncl, nch, n_sweep};
  super_occluded_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
