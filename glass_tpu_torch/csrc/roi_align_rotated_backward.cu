// K1b: the backward of K1 (rotated RoIAlign over a packed, channels-last
// feature pyramid) with respect to the features.  Hand-written for Hopper
// (sm_90a).
//
// Replaces: what glass_tpu gets from XLA autodiff of its pooler, a
// scatter-add of every sample's four weighted taps
// (glass_tpu/ops/roi_align_rotated.py:375 _packed_pool_impl, and
// roi_align_rotated), which the reference ran as detectron2's hand-written
// ROIAlignRotated_backward.  The rois carry no gradient, as in detectron2.
//
// Inputs:
//   grad_out    (R, PH, PW, C) upstream gradient, f32, bf16 or fp16
//   rois, level_meta, levels, grid: as K1 (roi_align_rotated.cu)
//   acc         (sum_l H_l * W_l, C) f32 accumulator: the output itself
//               when it is f32, else scratch; never zeroed as a whole
//   out         (sum_l H_l * W_l, C) the gradient, f32, bf16 or fp16, every row
//               written once
//   flags       one int a unit of kUnitRows packed rows, zero on entry and
//               left zero on return
//   stats       2 ints: bin tiles on the direct path, and taps that fell
//               outside their tile's footprint (0 unless the footprint
//               arithmetic is wrong; such a tap is dropped)
//   info        per (roi, tile) the frame and footprint the mark kernel
//               computed, for the scatter kernel
//
// What bounds it on the H100: the function's output is the dense gradient
// of every packed row, zeros included, so the least bytes are the upstream
// gradient read once plus the dense gradient written once in its own dtype
// (chip_smoke.py phase 7 prints that bound).  The per-tap form
// (study/kernel_variants.cu, the baseline) added every tap of every sample
// into an f32 buffer that the wrapper zeroed whole, with one scalar L2
// atomic a channel, and left the cast to bf16 to a separate pass: ~100 M
// atomics and ~280 MB of memset a step, more than the bound in the memset
// alone.
//
// Design, three kernels a call, no host sync:
// 1. mark_kernel, one block per (roi, tile of bins): computes the tile's
//    samples and sets the flag of every unit of kUnitRows packed rows that a
//    tap of nonzero weight reaches; the thread that sets a flag first has
//    its block zero that unit of `acc`.  Only touched rows are zeroed.  It
//    also writes each tile's frame and footprint to `info`.
// 2. scatter_kernel, one block per (roi, tile of bins, group of 256
//    channels): thread 0 reads the tile's frame and footprint from `info`.
//    The footprint is the bounding rectangle, on the roi's level, of the
//    tile's rotated extent, widened by kSlack, plus the one-pixel tap
//    reach, clamped to the map (ops/roi_align_rotated.py::
//    bin_tile_footprints is its plain version).  The block computes the
//    tile's samples once into a shared table of taps (the forward's
//    operations in its order, bilinear.cuh, -fmad=false, so every tap row
//    and weight is K1's bit for bit; the per-roi (g_h, g_w) table gives
//    glass_tpu's bulk-plus-budget split its exact gradient), places each
//    tap in a shared index map of the footprint's rows, and numbers the
//    touched rows into accumulator slots with a block scan.  The samples of
//    a bin share its gradient, so the bin's taps of one slot merge: the
//    first takes the sum of their weights (each tap compares itself with
//    its bin's earlier taps, in parallel).  The tile's gradient is staged
//    in shared memory with 16-byte loads (a scalar load a thread and bin
//    flooded the SM's load queue).  Thread i owns channels 2i and 2i + 1
//    of the block's 256 (channel-owned columns) and adds w * g of each
//    merged tap into its columns of the tap's slot with plain shared loads
//    and stores, the four taps of a sample at a time, no atomics; then
//    each touched row is flushed once to `acc` with Hopper's 16-byte
//    vector reduction (atomicAdd on float4).  More touched rows than the
//    accumulator's cap_slots are taken in rounds.  A tile whose footprint
//    exceeds the index map, whose samples exceed the table, or whose
//    touched rows exceed kMaxRounds rounds takes the direct path in the
//    same launch (the per-tap form with 16-byte reductions: one a tap and 4
//    channels) and is counted in stats[0].  A block holds 53 KB (bf16):
//    four an SM (fp16 the same), with the carveout set to all shared memory.  The
//    accumulation is bound by shared-memory bandwidth (a read and a write
//    of 4 bytes a merged tap and channel).  The study's first form (shared
//    atomics into a tile of all footprint rows x 32 channels, the chunks of
//    a tile in turn) ran slower than the per-tap form.
// 3. finish_kernel, one block per kFinishUnits units: writes every row of
//    `out` once, rounded from `acc` with __float2bfloat16_rn or
//    __float2half_rn (torch's rounding) where its unit is marked and zero where it is not (f32:
//    marked rows are already in place), and clears the flags.
// K1b's sums are not bit-equal run to run: the shared and global atomics
// add in another order each run (phase 7's tolerance is the bound of two
// reordered f32 sums).
#include "bilinear.cuh"

namespace {
namespace k1b {

constexpr int kThreads = 256;           // finish blocks
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 256;             // channels a scatter block owns
constexpr int kScatterVec = 2;          // channels a scatter thread owns
constexpr int kMarkThreads = 128;       // mark blocks: samples a pass
constexpr int kTableSamples = 256;      // samples a tile's table holds (8 KB, plus a spare)
constexpr int kMaxTileBins = 16;        // bins a tile holds (their gradient staged in shared memory)
constexpr int kMaxRounds = 6;           // rounds of cap_slots rows before the direct path
constexpr int kUnitRows = 2;            // packed rows one flag covers
constexpr int kFinishUnits = 16;        // units a finishing block writes
constexpr float kSlack = 1.0f / 16.0f;  // FOOTPRINT_SLACK, pixels

struct RoiFrame {
  float cx, cy, rw, rh, cos_t, sin_t, bin_h, bin_w, ghf, gwf, count;
  float inv_h, inv_w, inv_count;
  int H, W, gh, gw, pow2;
  long long base;
};

// The work split: tiles of tile_h x tile_w bins, row-major over the roi's
// PH x PW bins (the last ones cut at the edge), the footprint rows the
// index map holds and the touched rows the accumulator holds a round.
struct Plan {
  int tile_h, tile_w, tiles_w, tiles, cap_rows, cap_slots;
  // the study's trace (null on the port's path): kTraceStamps %globaltimer
  // stamps a scatter block of channel group 0, at the starts of its phases
  unsigned long long* trace;
};

constexpr int kTraceStamps = 6;

// Stamp i of this scatter block's trace, when there is one.
__device__ __forceinline__ void stamp(const Plan& p, int i) {
  if (p.trace == nullptr || threadIdx.x != 0 || blockIdx.y != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  p.trace[(size_t)blockIdx.x * kTraceStamps + i] = t;
}

struct Unit {
  int r, h0, h1, w0, w1;  // roi, bin rows [h0, h1), bin columns [w0, w1)
};

// Map rows [y0, y0 + fh) x columns [x0, x0 + fw) of the roi's level;
// fh == 0: the tile has no tap.
struct Footprint {
  int y0, x0, fh, fw;
};

// What the mark kernel hands the scatter kernel for each (roi, tile).
struct UnitInfo {
  RoiFrame fr;
  Footprint fp;
};

__device__ __forceinline__ Unit unit_of(int u, const Plan& p, int PH, int PW) {
  Unit t;
  t.r = u / p.tiles;
  const int k = u - t.r * p.tiles;
  const int ti = k / p.tiles_w;
  const int tj = k - ti * p.tiles_w;
  t.h0 = ti * p.tile_h;
  t.h1 = min(t.h0 + p.tile_h, PH);
  t.w0 = tj * p.tile_w;
  t.w1 = min(t.w0 + p.tile_w, PW);
  return t;
}

// K1's roi frame, the same operations in the same order.
__device__ __forceinline__ void make_frame(RoiFrame& fr, const float* rois,
                                           const float* level_meta, const int* levels,
                                           const int* grid, int r, int PH, int PW) {
  const int lvl = levels[r];
  const float scale = level_meta[4 * lvl + 0];
  const float* roi = rois + 5 * r;
  fr.H = (int)level_meta[4 * lvl + 1];
  fr.W = (int)level_meta[4 * lvl + 2];
  fr.base = (long long)level_meta[4 * lvl + 3];
  fr.cx = roi[0] * scale - 0.5f;
  fr.cy = roi[1] * scale - 0.5f;
  fr.rw = roi[2] * scale;
  fr.rh = roi[3] * scale;
  const float theta = (roi[4] * 3.14159265358979323846f) * (1.0f / 180.0f);
  fr.cos_t = cosf(theta);
  fr.sin_t = sinf(theta);
  fr.gh = grid[2 * r + 0];
  fr.gw = grid[2 * r + 1];
  fr.ghf = (float)fr.gh;
  fr.gwf = (float)fr.gw;
  fr.bin_h = fr.rh * (1.0f / (float)PH);
  fr.bin_w = fr.rw * (1.0f / (float)PW);
  fr.count = fr.ghf * fr.gwf;
  fr.pow2 = power_of_two_grid(fr.gh, fr.gw);
  fr.inv_h = 1.0f / fr.ghf;
  fr.inv_w = 1.0f / fr.gwf;
  fr.inv_count = 1.0f / fr.count;
}

// Sample (iy, ix) of bin (ph, pw): K1's fill_entry, the same operations in
// the same order.
template <typename Scale>
__device__ __forceinline__ TapCoords sample_coords(const RoiFrame& fr, int ph, int pw, int iy,
                                                   int ix, Scale per_h, Scale per_w,
                                                   Scale per_count) {
  const float yy = sample_offset(fr.rh, fr.bin_h, ph, iy, per_h);
  const float xx = sample_offset(fr.rw, fr.bin_w, pw, ix, per_w);
  const float y = (yy * fr.cos_t - xx * fr.sin_t) + fr.cy;
  const float x = (yy * fr.sin_t + xx * fr.cos_t) + fr.cx;
  return tap_coords(y, x, fr.H, fr.W, per_count);
}

// Sample i of a tile, bin-major (bin k of the tile row-major, then the
// sample s row-major over the g_h x g_w grid).
__device__ __forceinline__ TapCoords tile_sample(const RoiFrame& fr, const Unit& t, int i) {
  const int n = fr.gh * fr.gw;
  const int tw = t.w1 - t.w0;
  const int k = i / n;
  const int s = i - k * n;
  const int ph = t.h0 + k / tw;
  const int pw = t.w0 + (k - (k / tw) * tw);
  const int iy = s / fr.gw;
  const int ix = s - iy * fr.gw;
  if (fr.pow2) {
    return sample_coords(fr, ph, pw, iy, ix, MultiplyBy{fr.inv_h}, MultiplyBy{fr.inv_w},
                         MultiplyBy{fr.inv_count});
  }
  return sample_coords(fr, ph, pw, iy, ix, DivideBy{fr.ghf}, DivideBy{fr.gwf},
                       DivideBy{fr.count});
}

__device__ __forceinline__ Footprint tile_footprint(const RoiFrame& fr, const Unit& t) {
  Footprint f{0, 0, 0, 0};
  if (fr.gh <= 0 || fr.gw <= 0) return f;  // an empty grid pooled zeros: no gradient
  const float ya = -fr.rh / 2.0f + (float)t.h0 * fr.bin_h;
  const float yb = -fr.rh / 2.0f + (float)t.h1 * fr.bin_h;
  const float xa = -fr.rw / 2.0f + (float)t.w0 * fr.bin_w;
  const float xb = -fr.rw / 2.0f + (float)t.w1 * fr.bin_w;
  const float yc_lo = fminf(ya * fr.cos_t, yb * fr.cos_t), yc_hi = fmaxf(ya * fr.cos_t, yb * fr.cos_t);
  const float xs_lo = fminf(xa * fr.sin_t, xb * fr.sin_t), xs_hi = fmaxf(xa * fr.sin_t, xb * fr.sin_t);
  const float ys_lo = fminf(ya * fr.sin_t, yb * fr.sin_t), ys_hi = fmaxf(ya * fr.sin_t, yb * fr.sin_t);
  const float xc_lo = fminf(xa * fr.cos_t, xb * fr.cos_t), xc_hi = fmaxf(xa * fr.cos_t, xb * fr.cos_t);
  const float y_lo = ((yc_lo - xs_hi) + fr.cy) - kSlack;
  const float y_hi = ((yc_hi - xs_lo) + fr.cy) + kSlack;
  const float x_lo = ((ys_lo + xc_lo) + fr.cx) - kSlack;
  const float x_hi = ((ys_hi + xc_hi) + fr.cx) + kSlack;
  const float hf = (float)fr.H, wf = (float)fr.W;
  // every sample outside [-1, H] x [-1, W] adds nothing
  if (y_hi < -1.0f || y_lo > hf || x_hi < -1.0f || x_lo > wf) return f;
  const int y0 = (int)fminf(fmaxf(floorf(y_lo), 0.0f), hf - 1.0f);
  const int y1 = (int)fminf(fmaxf(floorf(y_hi) + 1.0f, 0.0f), hf - 1.0f);
  const int x0 = (int)fminf(fmaxf(floorf(x_lo), 0.0f), wf - 1.0f);
  const int x1 = (int)fminf(fmaxf(floorf(x_hi) + 1.0f, 0.0f), wf - 1.0f);
  f.y0 = y0;
  f.x0 = x0;
  f.fh = y1 - y0 + 1;
  f.fw = x1 - x0 + 1;
  return f;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// ---------------------------------------------------------------------------
// 1. mark touched units, zero them in acc
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mark_tap(const RoiFrame& fr, int y, int x, float w, int* flags,
                                         int* list, int* n_list) {
  if (w == 0.0f) return;  // a tap of weight zero adds nothing
  const int u = (int)((fr.base + (long long)y * fr.W + x) / kUnitRows);
  if (flags[u] == 0 && atomicExch(flags + u, 1) == 0) list[atomicAdd(n_list, 1)] = u;
}

__global__ void __launch_bounds__(kMarkThreads)
mark_kernel(const float* __restrict__ rois, const float* __restrict__ level_meta,
            const int* __restrict__ levels, const int* __restrict__ grid, int PH, int PW, Plan p,
            int C, long long n_rows, int* __restrict__ flags, float* __restrict__ acc,
            int* __restrict__ stats, UnitInfo* __restrict__ info) {
  __shared__ int list[4 * kMarkThreads];
  __shared__ int n_list;
  if (blockIdx.x == 0 && threadIdx.x < 2) stats[threadIdx.x] = 0;
  const Unit t = unit_of(blockIdx.x, p, PH, PW);
  RoiFrame fr;  // every thread computes the frame: no barrier before the samples
  make_frame(fr, rois, level_meta, levels, grid, t.r, PH, PW);
  if (threadIdx.x == 0) info[blockIdx.x] = UnitInfo{fr, tile_footprint(fr, t)};
  const int n = fr.gh * fr.gw;
  if (n <= 0) return;
  const int total = (t.h1 - t.h0) * (t.w1 - t.w0) * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < total; s0 += kMarkThreads) {
    if (threadIdx.x == 0) n_list = 0;
    __syncthreads();
    if (s0 + (int)threadIdx.x < total) {
      const TapCoords c = tile_sample(fr, t, s0 + threadIdx.x);
      if (c.inside) {
        mark_tap(fr, c.yi, c.xi, c.w00, flags, list, &n_list);
        mark_tap(fr, c.yi, c.xi1, c.w01, flags, list, &n_list);
        mark_tap(fr, c.yi1, c.xi, c.w10, flags, list, &n_list);
        mark_tap(fr, c.yi1, c.xi1, c.w11, flags, list, &n_list);
      }
    }
    __syncthreads();
    // a warp zeroes one unit at a time with 16-byte stores
    for (int k = warp; k < n_list; k += kMarkThreads / 32) {
      const long long r0 = (long long)list[k] * kUnitRows;
      const long long rows = min((long long)kUnitRows, n_rows - r0);
      float4* dst = reinterpret_cast<float4*>(acc + r0 * C);
      const int n4 = (int)(rows * C / 4);
      for (int i = lane; i < n4; i += 32) dst[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 2. pre-reduce each tile's taps in shared memory, flush once
// ---------------------------------------------------------------------------

// Hopper's vector reduction into global memory (red.global.add.v4.f32).
template <bool kVecFlush>
__device__ __forceinline__ void flush_add(float* dst, float4 v) {
  if constexpr (kVecFlush) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
  } else {
    atomicAdd(dst + 0, v.x);
    atomicAdd(dst + 1, v.y);
    atomicAdd(dst + 2, v.z);
    atomicAdd(dst + 3, v.w);
  }
}

// Shared memory of a scatter block: the accumulator (cap_slots rows of
// kGroup channels), the table (per sample 4 slots and 4 weights, plus a
// spare), the tile's gradient (kMaxTileBins x kGroup channels of the
// gradient's type, elt bytes each), the packed row of each slot of
// a round, and the footprint's index map (int16).
__host__ __device__ constexpr int scatter_smem_bytes(int cap_rows, int cap_slots, int elt) {
  return cap_slots * kGroup * 4 + (kTableSamples + 1) * 32 + kMaxTileBins * kGroup * elt +
         cap_slots * 4 + ((cap_rows * 2 + 15) / 16) * 16;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&q.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&q.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// kVec consecutive f32 of shared memory (one 4-, 8- or 16-byte access).
template <int kVec>
__device__ __forceinline__ void lds(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (kVec == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = *p;
  }
}
template <int kVec>
__device__ __forceinline__ void sts(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The direct path of a tile (the per-tap form with 16-byte reductions): warps
// take bins, every lane computes each sample's taps and adds w * g of 4
// channels a quad into the packed rows, channels [c0, c0 + kGroup).
template <typename T, bool kVecFlush, int kThreadsX>
__device__ void scatter_direct(const RoiFrame& fr, const Unit& t, const T* __restrict__ grad_out,
                               int C, int c0, int PH, int PW, float* __restrict__ acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = fr.gh * fr.gw;
  const int tw = t.w1 - t.w0;
  const int bins = (t.h1 - t.h0) * tw;
  constexpr int kQuads = kGroup / 4 / 32;  // quads a lane
  for (int k = warp; k < bins; k += kThreadsX / 32) {
    const int ph = t.h0 + k / tw;
    const int pw = t.w0 + (k - (k / tw) * tw);
    const T* go = grad_out + (((long long)t.r * PH + ph) * PW + pw) * C;
    float4 g[kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int c = c0 + 4 * (lane + 32 * q);
      g[q] = c < C ? load4(go + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int s = 0; s < n; ++s) {
      const TapCoords tc = tile_sample(fr, t, k * n + s);
      if (!tc.inside) continue;  // a sample outside the map added zero
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = j == 0 ? tc.w00 : j == 1 ? tc.w01 : j == 2 ? tc.w10 : tc.w11;
        if (w == 0.0f) continue;  // a tap of weight zero adds nothing
        const int y = j < 2 ? tc.yi : tc.yi1;
        const int x = (j & 1) ? tc.xi1 : tc.xi;
        float* row = acc + (fr.base + (long long)y * fr.W + x) * C;
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          const int c = c0 + 4 * (lane + 32 * q);
          if (c < C)
            flush_add<kVecFlush>(row + c, make_float4(w * g[q].x, w * g[q].y, w * g[q].z,
                                                      w * g[q].w));
        }
      }
    }
  }
}

// One block per (roi, tile of bins, group of kGroup channels); thread i
// owns channels c0 + kVec i .. + kVec - 1 (channel-owned columns).  The
// tile's gradient is staged in shared memory with 16-byte loads.  The
// block computes the tile's samples once into a table, places each tap in
// the footprint's index map, numbers the touched rows into slots (a block
// scan), then merges each bin's taps of the same slot (all samples of a
// bin share its gradient, so their weights add).  Each thread adds w * g
// of every merged tap into its own columns with plain shared loads and
// stores, no atomics, and each touched row is flushed once.  When the
// touched rows outnumber the accumulator's cap_slots rows, the block takes
// them in rounds (at most kMaxRounds, else the direct path).
template <typename T, int kVec, bool kVecFlush>
__global__ void __launch_bounds__(kGroup / kVec, 4)
scatter_kernel(const T* __restrict__ grad_out, int C, const UnitInfo* __restrict__ info, int PH,
               int PW, Plan p, float* __restrict__ acc, int* __restrict__ stats) {
  constexpr int kThreadsX = kGroup / kVec;
  constexpr int kWarpsX = kThreadsX / 32;
  constexpr int kGVec = 16 / sizeof(T);  // channels of one 16-byte gradient load
  extern __shared__ float4 smem[];
  float* slots = reinterpret_cast<float*>(smem);
  int4* tap_slot = reinterpret_cast<int4*>(slots + (size_t)p.cap_slots * kGroup);
  float4* tap_w = reinterpret_cast<float4*>(tap_slot + kTableSamples + 1);
  T* g_s = reinterpret_cast<T*>(tap_w + kTableSamples + 1);  // [bin][kGroup]
  int* slot_row = reinterpret_cast<int*>(g_s + kMaxTileBins * kGroup);
  short* map = reinterpret_cast<short*>(slot_row + p.cap_slots);
  __shared__ RoiFrame fr;
  __shared__ Footprint fp;
  __shared__ int path;  // 0: shared, 1: direct
  __shared__ int warp_total[kWarpsX];
  __shared__ int n_slots;

  stamp(p, 0);
  const Unit t = unit_of(blockIdx.x, p, PH, PW);
  const int tw = t.w1 - t.w0;
  const int bins = (t.h1 - t.h0) * tw;
  const int c0 = blockIdx.y * kGroup;
  if (threadIdx.x == 0) {
    fr = info[blockIdx.x].fr;
    fp = info[blockIdx.x].fp;
    path = fp.fh * fp.fw > p.cap_rows || bins * fr.gh * fr.gw > kTableSamples;
  }
  // the tile's gradient, 16 bytes a load, while thread 0 reads the frame
  constexpr int kLoads = kGroup / kGVec;  // loads a bin
  for (int i = threadIdx.x; i < bins * kLoads; i += kThreadsX) {
    const int k = i / kLoads;
    const int c = (i - k * kLoads) * kGVec;
    const int ph = t.h0 + k / tw;
    const int pw = t.w0 + (k - (k / tw) * tw);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c0 + c < C)
      v = *reinterpret_cast<const uint4*>(grad_out + (((long long)t.r * PH + ph) * PW + pw) * C + c0 + c);
    *reinterpret_cast<uint4*>(g_s + k * kGroup + c) = v;
  }
  __syncthreads();
  stamp(p, 1);
  const int n = fr.gh * fr.gw;
  if (n <= 0 || fp.fh == 0) return;
  if (path) {
    if (threadIdx.x == 0 && blockIdx.y == 0) atomicAdd(stats + 0, 1);
    scatter_direct<T, kVecFlush, kThreadsX>(fr, t, grad_out, C, c0, PH, PW, acc);
    stamp(p, 5);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_fp = fp.fh * fp.fw;
  const int total = bins * n;
  for (int i = threadIdx.x; i < n_fp; i += kThreadsX) map[i] = 0;
  __syncthreads();

  // The table: per sample its four taps' footprint indices (-1: no tap)
  // and weights; map[l] = 1 where a tap lands.
  auto local = [&](int y, int x, float w) -> int {
    if (w == 0.0f) return -1;  // a tap of weight zero adds nothing
    const int ly = y - fp.y0, lx = x - fp.x0;
    if (ly < 0 || ly >= fp.fh || lx < 0 || lx >= fp.fw) {
      atomicAdd(stats + 1, 1);
      return -1;
    }
    const int l = ly * fp.fw + lx;
    map[l] = 1;
    return l;
  };
  for (int e = threadIdx.x; e < total; e += kThreadsX) {
    const TapCoords c = tile_sample(fr, t, e);
    int4 li = make_int4(-1, -1, -1, -1);
    float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c.inside) {
      li = make_int4(local(c.yi, c.xi, c.w00), local(c.yi, c.xi1, c.w01),
                     local(c.yi1, c.xi, c.w10), local(c.yi1, c.xi1, c.w11));
      w = make_float4(c.w00, c.w01, c.w10, c.w11);
    }
    tap_slot[e] = li;
    tap_w[e] = w;
  }
  __syncthreads();
  stamp(p, 2);

  // Slots: an exclusive scan of the touched flags, footprint order.
  const int per = (n_fp + kThreadsX - 1) / kThreadsX;
  const int b0 = min(n_fp, (int)threadIdx.x * per), b1 = min(n_fp, b0 + per);
  int cnt = 0;
  for (int i = b0; i < b1; ++i) cnt += map[i];
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int base = incl - cnt;
  for (int w = 0; w < warp; ++w) base += warp_total[w];
  if (threadIdx.x == kThreadsX - 1) n_slots = base + cnt;
  for (int i = b0; i < b1; ++i) map[i] = map[i] ? (short)(base++) : (short)-1;
  __syncthreads();
  const int rounds = (n_slots + p.cap_slots - 1) / p.cap_slots;
  if (rounds > kMaxRounds) {  // too many rows for the rounds
    if (threadIdx.x == 0 && blockIdx.y == 0) atomicAdd(stats + 0, 1);
    scatter_direct<T, kVecFlush, kThreadsX>(fr, t, grad_out, C, c0, PH, PW, acc);
    stamp(p, 5);
    return;
  }
  for (int e = threadIdx.x; e < total; e += kThreadsX) {
    const int4 li = tap_slot[e];
    tap_slot[e] = make_int4(li.x < 0 ? -1 : map[li.x], li.y < 0 ? -1 : map[li.y],
                            li.z < 0 ? -1 : map[li.z], li.w < 0 ? -1 : map[li.w]);
  }
  __syncthreads();
  stamp(p, 3);
  // Merge each bin's taps of one slot (the samples of a bin share its
  // gradient, so their weights add): the first tap of a slot in the bin's
  // order takes the sum of the weights, in that order; the later ones drop
  // out.  Decided for every tap first, then written.
  constexpr int kTapsPer = 4 * kTableSamples / kThreadsX;
  int lead_w_bits[kTapsPer];
  int lead_slot[kTapsPer];
#pragma unroll
  for (int q = 0; q < kTapsPer; ++q) {
    const int i = threadIdx.x + q * kThreadsX;  // tap i of the table, i / 4 its sample
    lead_slot[q] = -1;
    lead_w_bits[q] = 0;
    if (i >= 4 * total) continue;
    const int* ts = reinterpret_cast<const int*>(tap_slot);
    const float* tw_ = reinterpret_cast<const float*>(tap_w);
    const int sl = ts[i];
    if (sl < 0) continue;
    const int b0_ = (i / 4 / n) * 4 * n;  // the bin's first tap
    bool first = true;
    for (int jj = b0_; jj < i && first; ++jj) first = ts[jj] != sl;
    if (!first) continue;
    float w = tw_[i];
    for (int jj = i + 1; jj < b0_ + 4 * n; ++jj)
      if (ts[jj] == sl) w = w + tw_[jj];
    lead_slot[q] = sl;
    lead_w_bits[q] = __float_as_int(w);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kTapsPer; ++q) {
    const int i = threadIdx.x + q * kThreadsX;
    if (i >= 4 * total) continue;
    reinterpret_cast<int*>(tap_slot)[i] = lead_slot[q];
    reinterpret_cast<float*>(tap_w)[i] = __int_as_float(lead_w_bits[q]);
  }

  float4* slots4 = reinterpret_cast<float4*>(slots);
  float* mine = slots + kVec * threadIdx.x;
  const int ch = c0 + kVec * threadIdx.x;
  for (int lo = 0; lo < n_slots; lo += p.cap_slots) {
    const int hi = min(lo + p.cap_slots, n_slots);
    for (int i = threadIdx.x; i < (hi - lo) * kGroup / 4; i += kThreadsX)
      slots4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int l = threadIdx.x; l < n_fp; l += kThreadsX) {
      const int sl = map[l];
      if (sl >= lo && sl < hi) {
        const int ly = l / fp.fw;
        slot_row[sl - lo] = (int)(fr.base + (long long)(fp.y0 + ly) * fr.W + fp.x0 + (l - ly * fp.fw));
      }
    }
    __syncthreads();
    // Each thread adds every merged tap of this round into its own
    // channels' columns.  A sample's taps are distinct rows, so its four
    // go out together; a tap merged away or outside this round is skipped
    // (the test is the same for the whole warp), and so is a sample with
    // none left.
    auto row_of = [&](int sl) { return sl >= lo && sl < hi ? sl - lo : -1; };
    for (int k = 0; k < bins; ++k) {
      float g[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        g[j] = ch + j < C ? to_float(g_s[k * kGroup + kVec * threadIdx.x + j]) : 0.0f;
      for (int e = k * n; e < (k + 1) * n; ++e) {
        const int4 sl = tap_slot[e];
        const int r[4] = {row_of(sl.x), row_of(sl.y), row_of(sl.z), row_of(sl.w)};
        if ((r[0] & r[1] & r[2] & r[3]) == -1) continue;  // all four are -1
        const float4 w4 = tap_w[e];
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
        float a[4][kVec];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (r[q] >= 0) lds<kVec>(mine + r[q] * kGroup, a[q]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) a[q][j] = a[q][j] + w[q] * g[j];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (r[q] >= 0) sts<kVec>(mine + r[q] * kGroup, a[q]);
      }
    }
    __syncthreads();
    if (lo == 0) stamp(p, 4);
    // flush: one 16-byte reduction a (slot, 4 channels)
    constexpr int kQuads = kGroup / 4;
    for (int i = threadIdx.x; i < (hi - lo) * kQuads; i += kThreadsX) {
      const int sl = i / kQuads;
      const int c = c0 + 4 * (i - sl * kQuads);
      if (c < C) flush_add<kVecFlush>(acc + (long long)slot_row[sl] * C + c, slots4[i]);
    }
    __syncthreads();  // before the next round zeroes the slots
  }
  stamp(p, 5);
}

// ---------------------------------------------------------------------------
// 3. write every row once in the output dtype, clear the flags
// ---------------------------------------------------------------------------

// Two f32 values rounded to bf16 (torch's round to nearest even), packed.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
// The same in fp16 (values beyond 65504 round to inf, as torch's cast).
__device__ __forceinline__ unsigned pack_pair(float lo, float hi, __nv_bfloat16*) {
  return pack_bf16(lo, hi);
}
__device__ __forceinline__ unsigned pack_pair(float lo, float hi, __half*) {
  return (unsigned)__half_as_ushort(__float2half_rn(lo)) |
         ((unsigned)__half_as_ushort(__float2half_rn(hi)) << 16);
}

// kMarked false (a study variant): `acc` was zeroed whole, every unit is
// read.
template <typename TOut, bool kMarked>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* acc, TOut* out, int C, long long n_rows, int* __restrict__ flags) {
  __shared__ int marked[kFinishUnits];
  const long long n_units = (n_rows + kUnitRows - 1) / kUnitRows;
  const long long u0 = (long long)blockIdx.x * kFinishUnits;
  if (threadIdx.x < kFinishUnits) {
    const long long u = u0 + threadIdx.x;
    marked[threadIdx.x] = !kMarked || (u < n_units && flags[u] != 0);
  }
  __syncthreads();
  if (kMarked && threadIdx.x < kFinishUnits && u0 + threadIdx.x < n_units)
    flags[u0 + threadIdx.x] = 0;
  constexpr int kVec = 16 / sizeof(TOut);
  const long long r0 = u0 * kUnitRows;
  const int rows = (int)min((long long)kFinishUnits * kUnitRows, n_rows - r0);
  const int per_row = C / kVec;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int lr = i / per_row;
    const long long e = (r0 + lr) * C + (long long)(i - lr * per_row) * kVec;
    const bool m = marked[lr / kUnitRows];
    if constexpr (sizeof(TOut) == 4) {
      // f32: acc is out, marked rows are in place
      if (!m) *reinterpret_cast<float4*>(out + e) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m) {
        const float4 a = *reinterpret_cast<const float4*>(acc + e);
        const float4 b = *reinterpret_cast<const float4*>(acc + e + 4);
        v = make_uint4(pack_pair(a.x, a.y, out), pack_pair(a.z, a.w, out),
                       pack_pair(b.x, b.y, out), pack_pair(b.z, b.w, out));
      }
      *reinterpret_cast<uint4*>(out + e) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* grad_out;
  int dtype, out_dtype, C;
  const float *rois, *level_meta;
  const int *levels, *grid;
  int R, PH, PW;
  long long n_rows;
  float* acc;
  void* out;
  int *flags, *stats;
  UnitInfo* info;
};

template <typename T, int kVec, bool kVecFlush>
int launch_scatter(const Args& a, const Plan& p, cudaStream_t s) {
  auto kernel = scatter_kernel<T, kVec, kVecFlush>;
  const int smem = scatter_smem_bytes(p.cap_rows, p.cap_slots, (int)sizeof(T));
  static int smem_set = 0;  // the largest dynamic shared memory allowed so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // all of L1 as shared memory, so that four blocks fit an SM (the default
    // carveout left one)
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const unsigned groups = (unsigned)((a.C + kGroup - 1) / kGroup);
  kernel<<<dim3((unsigned)(a.R * p.tiles), groups), kGroup / kVec, smem, s>>>(
      static_cast<const T*>(a.grad_out), a.C, a.info, a.PH, a.PW, p, a.acc, a.stats);
  return (int)cudaGetLastError();
}

template <int kVec, bool kVecFlush>
int launch_scatter_any(const Args& a, const Plan& p, cudaStream_t s) {
  if (a.dtype == kFloat32) return launch_scatter<float, kVec, kVecFlush>(a, p, s);
  if (a.dtype == kFloat16) return launch_scatter<__half, kVec, kVecFlush>(a, p, s);
  return launch_scatter<__nv_bfloat16, kVec, kVecFlush>(a, p, s);
}

template <bool kMarked>
int launch_finish(const Args& a, cudaStream_t s) {
  const long long units = (a.n_rows + kUnitRows - 1) / kUnitRows;
  const unsigned blocks = (unsigned)((units + kFinishUnits - 1) / kFinishUnits);
  if (blocks == 0) return 0;
  if (a.out_dtype == kFloat32) {
    finish_kernel<float, kMarked><<<blocks, kThreads, 0, s>>>(a.acc, static_cast<float*>(a.out),
                                                              a.C, a.n_rows, a.flags);
  } else if (a.out_dtype == kFloat16) {
    finish_kernel<__half, kMarked><<<blocks, kThreads, 0, s>>>(
        a.acc, static_cast<__half*>(a.out), a.C, a.n_rows, a.flags);
  } else {
    finish_kernel<__nv_bfloat16, kMarked><<<blocks, kThreads, 0, s>>>(
        a.acc, static_cast<__nv_bfloat16*>(a.out), a.C, a.n_rows, a.flags);
  }
  return (int)cudaGetLastError();
}

int check(const Args& a, const Plan& p, int smem_bytes) {
  if (a.PH <= 0 || a.PW <= 0 || p.tile_h <= 0 || p.tile_w <= 0 ||
      p.tile_h * p.tile_w > kMaxTileBins || p.cap_rows <= 0 || p.cap_rows > 32767 ||
      p.cap_slots <= 0)
    return (int)cudaErrorInvalidValue;
  auto known = [](int d) { return d == kFloat32 || d == kBFloat16 || d == kFloat16; };
  if (!known(a.dtype) || !known(a.out_dtype)) return (int)cudaErrorInvalidValue;
  // 16-byte vectors: 4 f32 channels, 8 bf16 or fp16
  if (a.C % (a.dtype != kFloat32 || a.out_dtype != kFloat32 ? 8 : 4) != 0 || a.n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (a.out_dtype == kFloat32 && a.out != a.acc) return (int)cudaErrorInvalidValue;
  if (smem_bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  return 0;
}

Plan make_plan(const Args& a, int tile_h, int tile_w, int cap_rows, int cap_slots) {
  Plan p;
  p.tile_h = min(tile_h, a.PH);
  p.tile_w = min(tile_w, a.PW);
  p.tiles_w = (a.PW + p.tile_w - 1) / p.tile_w;
  p.tiles = ((a.PH + p.tile_h - 1) / p.tile_h) * p.tiles_w;
  p.cap_rows = cap_rows;
  p.cap_slots = cap_slots;
  p.trace = nullptr;
  return p;
}

// Mark, scatter with the given scatter launch, finish.  The finish kernel
// runs even when a launch before it failed, so the flags are left zero.
template <typename Scatter>
int launch_backward(const Args& a, const Plan& p, cudaStream_t s, Scatter scatter) {
  int status = 0;
  if (a.R > 0) {
    mark_kernel<<<(unsigned)(a.R * p.tiles), kMarkThreads, 0, s>>>(
        a.rois, a.level_meta, a.levels, a.grid, a.PH, a.PW, p, a.C, a.n_rows, a.flags, a.acc,
        a.stats, a.info);
    status = (int)cudaGetLastError();
    if (status == 0) status = scatter();
  }
  const int fin = launch_finish<true>(a, s);
  return status ? status : fin;
}

}  // namespace k1b
}  // namespace

// Bytes of the (roi, tile) records the wrapper allocates for `info`.
extern "C" int glass_roi_align_rotated_backward_unit_bytes() { return (int)sizeof(k1b::UnitInfo); }

// The plan (ops/roi_align_rotated.py::backward_tile): tiles of tile_h x
// tile_w bins, footprints of up to cap_rows map rows, cap_slots touched
// rows of 256 channels in the accumulator.  Returns a cudaError_t; 0 when
// all three kernels launched.
extern "C" int glass_roi_align_rotated_backward(
    const void* grad_out, int dtype, int out_dtype, int C, const float* rois,
    const float* level_meta, const int* levels, const int* grid, int R, int PH, int PW,
    int tile_h, int tile_w, int cap_rows, int cap_slots, long long n_rows, float* acc, void* out,
    int* flags, int* stats, void* info, void* stream) {
  const k1b::Args a{grad_out, dtype, out_dtype, C, rois, level_meta, levels, grid, R, PH, PW,
                    n_rows, acc, out, flags, stats, static_cast<k1b::UnitInfo*>(info)};
  const k1b::Plan p = k1b::make_plan(a, tile_h, tile_w, cap_rows, cap_slots);
  const int bad = k1b::check(a, p, k1b::scatter_smem_bytes(cap_rows, cap_slots, 4));
  if (bad) return bad;
  const cudaStream_t s = (cudaStream_t)stream;
  return k1b::launch_backward(
      a, p, s, [&] { return k1b::launch_scatter_any<k1b::kScatterVec, true>(a, p, s); });
}
