// K1: rotated RoIAlign (detectron2 ROIAlignRotated forward) over a packed,
// channels-last feature pyramid.  Hand-written for Hopper (sm_90a).
//
// Replaces: glass_tpu/ops/pallas_roi_align.py::_kernel (entry point
// roi_align_rotated_pallas), and serves what glass_tpu ran through its XLA
// gathers: the box 7x7, mask 14x14 and recognizer 8x32 poolers
// (ops/roi_align_rotated.py: roi_align_rotated, roi_align_rotated_adaptive,
// multilevel_roi_align_rotated_packed).
//
// Inputs:
//   feat        (sum_l H_l * W_l, C) level maps concatenated row-wise, f32, bf16
//               or fp16; C a multiple of the 16-byte vector (4 f32, 8 bf16 or
//               fp16), 16-byte aligned
//   rois        (R, 5) f32 (cx, cy, w, h, angle in degrees), image coordinates
//   level_meta  (L, 4) f32 rows (spatial scale, H, W, row offset)
//   levels      (R,) int32 level of each roi
//   grid        (R, 2) int32 sampling grid (g_h, g_w) of each roi; the
//               wrapper resolves fixed, adaptive-capped and bulk/large-roi
//               budget grids into this table, so one launch serves them all
//   out         (R, PH, PW, C) in the feature dtype, f32 accumulation rounded
//               once (__float2bfloat16_rn / __float2half_rn, torch's rounding)
//
// What bounds it on the H100 (device times: chip_smoke.py phase 2; the
// design alternatives below were timed on the card, PERF.md).  The first form (one
// 256-thread block per bin, one channel a thread) ran at 7 % of the byte
// bound and no faster in bf16 than in f32: every thread repeated the roi
// set-up (cosf/sinf) and every sample's coordinate and tap math, and moved
// 2 bytes a load.  This form runs at ~37 % of the bound in bf16 and ~52 %
// in f32.  Its time follows the samples, not the distinct bytes: with
// every roi on the 4x4 grid (16 samples a bin, where most rois of the bulk
// grid take 2) the mask pooler takes 4-5x its time, while the bytes its
// bound counts grow by less than a tenth.  Each sample costs each lane four 16-byte
// tap loads through L1 (a roi's samples overlap, so the taps move many
// times the distinct bytes the bound counts) and, per channel, the plain
// version's 8 f32 operations (no FMA).  80 registers hold it at 3 blocks,
// 24 warps, an SM (kernel_build.log).
//
// Design:
// * Work unit: one 8-warp block per (roi, tile of bins), roi-major: a band
//   of all bin rows by max(2, kTileBins / rows) columns.  The other
//   tiles (1 to all rows by 1 to 16 columns) are as fast or slower at the
//   three poolers, by up to ~2.5x; with every roi on the 4x4 grid, one
//   column of all rows is ~4 % faster.  A warp takes every 8th bin of the tile.  Lanes run
//   across channels with 16-byte loads and stores (8 bf16 or 4 f32 a
//   lane), so one warp instruction moves a 512-byte bf16 C-vector.  The
//   split-grid budget gives the 4x4 grid to the first large rois by index,
//   whose tiles the roi-major block order dispatches first, so they do not
//   set the tail.
// * Set-up once: thread 0 computes the roi's frame (level, scaled centre and
//   extent, cos/sin, bin size, grid) into shared memory for the block.
// * Taps once per sample: one table fill computes the samples of as many of
//   the warp's bins as fit 32 lanes (16 bins at 2 samples a bin), each
//   lane one sample's four tap rows and weights; every lane then reads the
//   entries as broadcasts, for all its channels.  Power-of-two grids divide
//   by multiplying with the exact inverse, the same bits.
// * Loads in flight: the taps of kUnroll table entries are loaded before
//   they are summed, across bin boundaries.  Each channel still adds its
//   samples in (iy, ix) order with the operation order of the plain
//   version, so f32 stays bit-identical.
// * Reuse: the bins of a tile run on one SM and share tap rows through its
//   L1.  Nothing is staged in shared memory, so there is no limit on a
//   roi's extent; shared memory is the same on-chip store as L1, so
//   staging would not cut the loads each sample makes.
#include "bilinear.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 2;  // table entries whose taps are loaded before they are summed
constexpr int kTileBins = 16;  // bins a block pools, about

struct RoiFrame {
  float cx, cy, rw, rh, cos_t, sin_t, bin_h, bin_w, ghf, gwf, count;
  float inv_h, inv_w, inv_count;
  int H, W, gh, gw, pow2;
  long long base;
};

// The element e of a 16-byte vector of T, as f32 (8 channels of a 2-byte
// type: bf16 by a shift, fp16 by the conversion instruction).
template <typename T> __device__ __forceinline__ float vec_elem(const uint4& q, int e);
template <> __device__ __forceinline__ float vec_elem<float>(const uint4& q, int e) {
  const unsigned w = e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
  return __uint_as_float(w);
}
template <> __device__ __forceinline__ float vec_elem<__nv_bfloat16>(const uint4& q, int e) {
  const int k = e >> 1;
  const unsigned w = k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <> __device__ __forceinline__ float vec_elem<__half>(const uint4& q, int e) {
  const int k = e >> 1;
  const unsigned w = k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
  return __half2float(__ushort_as_half((unsigned short)((e & 1) ? (w >> 16) : (w & 0xffffu))));
}

template <typename T> __device__ __forceinline__ uint4 pack_vec(const float* v);
template <> __device__ __forceinline__ uint4 pack_vec<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
template <> __device__ __forceinline__ uint4 pack_vec<__nv_bfloat16>(const float* v) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <> __device__ __forceinline__ uint4 pack_vec<__half>(const float* v) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned lo = __half_as_ushort(__float2half_rn(v[2 * k]));
    const unsigned hi = __half_as_ushort(__float2half_rn(v[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename Scale>
__device__ __forceinline__ void tap_entry(const RoiFrame& fr, int ph, int pw, int iy, int ix,
                                          Scale per_h, Scale per_w, Scale per_count, int4* row,
                                          float4* w) {
  const float yy = sample_offset(fr.rh, fr.bin_h, ph, iy, per_h);
  const float xx = sample_offset(fr.rw, fr.bin_w, pw, ix, per_w);
  const float y = (yy * fr.cos_t - xx * fr.sin_t) + fr.cy;
  const float x = (yy * fr.sin_t + xx * fr.cos_t) + fr.cx;
  const Taps t = bilinear_taps(y, x, fr.H, fr.W, per_count);
  *row = t.inside ? make_int4(t.i00, t.i01, t.i10, t.i11) : make_int4(-1, 0, 0, 0);
  *w = make_float4(t.w00, t.w01, t.w10, t.w11);
}

// Table entry of sample s (row-major over the g_h x g_w grid) of bin (ph, pw):
// its four tap rows (-1 when it lies outside the map) and weights.
__device__ __forceinline__ void fill_entry(const RoiFrame& fr, int ph, int pw, int s, int4* row,
                                           float4* w) {
  const int iy = s / fr.gw;
  const int ix = s - iy * fr.gw;
  if (fr.pow2) {
    tap_entry(fr, ph, pw, iy, ix, MultiplyBy{fr.inv_h}, MultiplyBy{fr.inv_w},
              MultiplyBy{fr.inv_count}, row, w);
  } else {
    tap_entry(fr, ph, pw, iy, ix, DivideBy{fr.ghf}, DivideBy{fr.gwf}, DivideBy{fr.count}, row, w);
  }
}

// Running sums of one lane's 16-byte channel vector: acc, the entries left
// in the current bin and the bin's index in the warp's output pointers.
template <int VEC>
struct BinSums {
  float acc[VEC];
  int left, bin;
  __device__ __forceinline__ explicit BinSums(int per) : left(per), bin(0) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  }
};

// Adds table entries [0, total) to the sums of channel vector cv, entry by
// entry in order, and stores a bin's sum when its last entry (every per-th
// entry overall) is added.  The taps of kUnroll entries are loaded before
// they are summed, across bin boundaries.
template <typename T, int VEC>
__device__ __forceinline__ void sum_entries(const T* __restrict__ f, int C, int cv,
                                            const int4* rows, const float4* wts, int total, int per,
                                            T* const* outs, BinSums<VEC>& b) {
  for (int e0 = 0; e0 < total; e0 += kUnroll) {
    uint4 q[kUnroll][4];
    int4 ti[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ti[u] = e0 + u < total ? rows[e0 + u] : make_int4(-1, 0, 0, 0);
      if (ti[u].x >= 0) {
        q[u][0] = __ldg(reinterpret_cast<const uint4*>(f + (long long)ti[u].x * C) + cv);
        q[u][1] = __ldg(reinterpret_cast<const uint4*>(f + (long long)ti[u].y * C) + cv);
        q[u][2] = __ldg(reinterpret_cast<const uint4*>(f + (long long)ti[u].z * C) + cv);
        q[u][3] = __ldg(reinterpret_cast<const uint4*>(f + (long long)ti[u].w * C) + cv);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u;
      if (e >= total) break;
      if (ti[u].x >= 0) {  // outside the map adds zero
        const float4 w = wts[e];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float v = ((vec_elem<T>(q[u][0], k) * w.x + vec_elem<T>(q[u][1], k) * w.y) +
                           vec_elem<T>(q[u][2], k) * w.z) +
                          vec_elem<T>(q[u][3], k) * w.w;
          b.acc[k] = b.acc[k] + v;
        }
      }
      if (--b.left == 0) {  // the bin's last sample
        reinterpret_cast<uint4*>(outs[b.bin++])[cv] = pack_vec<T>(b.acc);
        b.left = per;
#pragma unroll
        for (int k = 0; k < VEC; ++k) b.acc[k] = 0.0f;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 3)
roi_align_rotated_kernel(const T* __restrict__ feat, int C, const float* __restrict__ rois,
                         const float* __restrict__ level_meta, const int* __restrict__ levels,
                         const int* __restrict__ grid, int PH, int PW, int tile_h,
                         int tile_w, T* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ RoiFrame fr;
  __shared__ int4 tap_rows[kWarps][32];
  __shared__ float4 tap_w[kWarps][32];
  __shared__ T* bin_out[kWarps][32];

  const int tiles_w = (PW + tile_w - 1) / tile_w;
  const int tiles = ((PH + tile_h - 1) / tile_h) * tiles_w;
  const int r = blockIdx.x / tiles;
  const int t = blockIdx.x - r * tiles;
  const int h0 = (t / tiles_w) * tile_h;
  const int w0 = (t - (t / tiles_w) * tiles_w) * tile_w;
  const int th = min(tile_h, PH - h0);
  const int tw = min(tile_w, PW - w0);
  if (threadIdx.x == 0) {
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
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = C / VEC;
  const int n = fr.gh * fr.gw;
  const T* f = feat + fr.base * C;
  int4* rows = tap_rows[warp];
  float4* wts = tap_w[warp];
  T** outs = bin_out[warp];
  // this warp's bins: k = warp + kWarps * m of the tile's th * tw, row-major
  const int nk = th * tw;
  const int mine = nk > warp ? (nk - warp + kWarps - 1) / kWarps : 0;
  auto bin_of = [&](int m, int& ph, int& pw) {
    const int k = warp + kWarps * m;
    ph = h0 + k / tw;
    pw = w0 + k - (k / tw) * tw;
    return out + (((long long)r * PH + ph) * PW + pw) * C;
  };

  if (n == 0) {  // an empty grid pools zeros
    for (int m = 0; m < mine; ++m) {
      int ph, pw;
      T* o = bin_of(m, ph, pw);
      for (int cv = lane; cv < nvec; cv += 32) reinterpret_cast<uint4*>(o)[cv] = make_uint4(0, 0, 0, 0);
    }
  } else if (n <= 32) {
    // one table fill holds the samples of `group` bins, one per lane
    const int group = 32 / n;
    for (int m0 = 0; m0 < mine; m0 += group) {
      const int g = min(group, mine - m0);
      __syncwarp();
      if (lane < g * n) {
        const int j = lane / n;
        int ph, pw;
        T* o = bin_of(m0 + j, ph, pw);
        fill_entry(fr, ph, pw, lane - j * n, rows + lane, wts + lane);
        if (lane == j * n) outs[j] = o;
      }
      __syncwarp();
      for (int cv = lane; cv < nvec; cv += 32) {
        BinSums<VEC> b(n);
        sum_entries<T, VEC>(f, C, cv, rows, wts, g * n, n, outs, b);
      }
    }
  } else {
    // more than 32 samples a bin: the table takes them 32 at a time
    for (int m = 0; m < mine; ++m) {
      int ph, pw;
      T* o = bin_of(m, ph, pw);
      // every lane runs the same passes and chunks, so __syncwarp is safe
      for (int v0 = 0; v0 < nvec; v0 += 32) {
        const int cv = v0 + lane;
        BinSums<VEC> b(n);
        for (int s0 = 0; s0 < n; s0 += 32) {
          __syncwarp();
          if (s0 + lane < n) fill_entry(fr, ph, pw, s0 + lane, rows + lane, wts + lane);
          if (lane == 0) outs[0] = o;
          __syncwarp();
          if (cv < nvec) sum_entries<T, VEC>(f, C, cv, rows, wts, min(32, n - s0), n, outs, b);
        }
      }
    }
  }
}

// Launches the kernel over R rois, one block per tile of tile_h x tile_w
// bins.
int launch_roi_align(const void* feat, int dtype, int C, const float* rois,
                     const float* level_meta, const int* levels, const int* grid, int R, int PH,
                     int PW, int tile_h, int tile_w, void* out, cudaStream_t s) {
  if (R == 0) return 0;
  if (tile_h <= 0 || tile_w <= 0) return (int)cudaErrorInvalidValue;
  const dim3 blocks((unsigned)(R * ((PH + tile_h - 1) / tile_h) * ((PW + tile_w - 1) / tile_w)));
  if (dtype == kFloat32 && C % 4 == 0) {
    roi_align_rotated_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        (const float*)feat, C, rois, level_meta, levels, grid, PH, PW, tile_h, tile_w,
        (float*)out);
  } else if (dtype == kBFloat16 && C % 8 == 0) {
    roi_align_rotated_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, s>>>(
        (const __nv_bfloat16*)feat, C, rois, level_meta, levels, grid, PH, PW, tile_h, tile_w,
        (__nv_bfloat16*)out);
  } else if (dtype == kFloat16 && C % 8 == 0) {
    roi_align_rotated_kernel<__half><<<blocks, kWarps * 32, 0, s>>>(
        (const __half*)feat, C, rois, level_meta, levels, grid, PH, PW, tile_h, tile_w,
        (__half*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int glass_roi_align_rotated(const void* feat, int dtype, int C, const float* rois,
                                       const float* level_meta, const int* levels,
                                       const int* grid, int R, int PH, int PW, void* out,
                                       void* stream) {
  // a band of all PH bin rows by enough columns, two at least, for about
  // kTileBins bins
  const int tile_w = min(PW, max(2, kTileBins / max(PH, 1)));
  return launch_roi_align(feat, dtype, C, rois, level_meta, levels, grid, R, PH, PW, PH, tile_w,
                          out, (cudaStream_t)stream);
}
