// K2: rotated crops of the raw (H, W, 3) image, ROIAlignRotated at
// spatial_scale 1.  Hand-written for Hopper (sm_90a).
//
// Replaces: glass_tpu/ops/pallas_crop.py::_crop_kernel (entry point
// crop_rois_pallas), and the uint8 gather with the normalization folded in
// that glass_tpu ran through XLA (ops/roi_align_rotated.py::roi_align_rotated
// with normalize=(mean, std), glass_rcnn.py recognizer_encode).
//
// Inputs:
//   img    (H, W, 3) uint8, f32 or bf16, channels interleaved, at least two
//          pixels, its start aligned to two elements
//   rois   (R, 5) f32 (cx, cy, w, h, angle in degrees)
//   sampling_ratio > 0: fixed g x g grid per output pixel; 0: adaptive
//          ceil(extent / out) per axis, capped at max_sampling_ratio
//   mean, std (3,) f32, used when fold != 0 (uint8 input): the output is
//          sum_k w_k * (raw_k - mean) / std, i.e. the crop of the
//          normalized image, computed per sample as (sum w raw - sum w *
//          mean) / std so out-of-bounds taps stay exact zeros
//   out    (R, OH, OW, 3): f32 for uint8 input, else the image dtype
//
// What bounds it on the H100 (device times: chip_smoke.py phase 3 and
// glass_tpu_torch/study/kernel_variants.py).  100 crops of 128 x 128 x 3
// write 9.8 MB in bf16 and read a few bytes a tap from an image that sits
// in L2: the byte bound is ~4 us.  The first form (one 128-thread block per
// output row, one pixel a thread, every thread repeating the roi set-up,
// index division per pixel, 12 scalar tap loads and 3 address bases per
// sample) took ~7x that; this form ~4x.  The time is the scalar work of
// each sample, not bytes: sampling ratio 2 (4 samples a pixel) takes ~3x
// the time of ratio 1 while the bytes its bound counts grow by a tenth.  A
// sample is over a hundred instructions: coordinates, the tap rule's
// clamps and floors, four weights, two runs of tap elements and their
// weighted sums, with no FMA.
//
// Design: fewer instructions a sample.
// * A grid of (roi, band of kRowsPerBlock output rows) blocks, rois
//   fastest, so no block divides its index and a roi's bands spread over
//   the SMs.  3 rows a block is within ~2 % of the fastest of 1, 2, 4 and
//   8 in every case of the study.  A thread takes one output column of its
//   band (and every 128th after it): neighbouring threads take
//   neighbouring pixels (a warp's taps share cache lines, its stores are
//   contiguous), and the column's terms are computed once, the sample
//   offsets across the roi times cos and sin.  Each row adds its own terms:
//   two additions a coordinate, the plain version's operations in its
//   order.
// * Every thread computes the roi's frame (sincosf, bin sizes by exact
//   reciprocals): no shared memory, no barrier.  The frame computed once a
//   block by thread 0 into shared memory behind a barrier is as fast or
//   slower, by up to ~12 % (the study's kFrameOnce).
// * Stores: three scalar stores a pixel.  A run of 16 bytes' worth of
//   pixels a thread written as three 16-byte stores (the study's
//   kVectorStore) is as fast in bf16 at sampling ratio 1 and slower, by up
//   to ~22 %, in every other case: the stores do not set the time.
// * The wrapper's fixed sampling ratios 1 and 2 are compile-time grids:
//   their loops unroll and their divisions by the grid become the exact
//   multiplications by 1/2 and 1/4 (or nothing at 1), the same bits.  The
//   adaptive grid keeps runtime loops, power-of-two grids multiplied by the
//   exact inverse.
// * A sample reads the two horizontally adjacent taps of each image row as
//   one run of 6 elements from one address: three aligned pair loads and,
//   for odd runs, one single load, in place of 6 scalar loads.  A one-pixel
//   wide image (both taps of a row are one pixel) has its own instance.
// * The fold keeps (sum w raw - sum w mean) / std per sample.
#include "bilinear.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 3;  // output rows of one crop a block computes

struct CropFrame {
  float cx, cy, rw, rh, cos_t, sin_t, bin_h, bin_w, ghf, gwf, count;
  float inv_h, inv_w, inv_count;
  int gh, gw, pow2;
  float m[3], sd[3];
};

__device__ __forceinline__ CropFrame make_frame(const float* __restrict__ roi, int sampling_ratio,
                                                int max_sampling_ratio, int OH, int OW, int fold,
                                                const float* __restrict__ mean,
                                                const float* __restrict__ stdv) {
  CropFrame fr;
  fr.cx = __ldg(roi + 0) * 1.0f - 0.5f;
  fr.cy = __ldg(roi + 1) * 1.0f - 0.5f;
  fr.rw = __ldg(roi + 2) * 1.0f;
  fr.rh = __ldg(roi + 3) * 1.0f;
  const float theta = (__ldg(roi + 4) * 3.14159265358979323846f) * (1.0f / 180.0f);
  sincosf(theta, &fr.sin_t, &fr.cos_t);
  fr.bin_h = fr.rh * __frcp_rn((float)OH);
  fr.bin_w = fr.rw * __frcp_rn((float)OW);
  if (sampling_ratio > 0) {
    fr.gh = fr.gw = sampling_ratio;
  } else {
    fr.gh = (int)fminf(fmaxf(ceilf(fr.bin_h), 1.0f), (float)max_sampling_ratio);
    fr.gw = (int)fminf(fmaxf(ceilf(fr.bin_w), 1.0f), (float)max_sampling_ratio);
  }
  fr.ghf = (float)fr.gh;
  fr.gwf = (float)fr.gw;
  fr.count = fr.ghf * fr.gwf;
  fr.pow2 = power_of_two_grid(fr.gh, fr.gw);
  fr.inv_h = 1.0f / fr.ghf;
  fr.inv_w = 1.0f / fr.gwf;
  fr.inv_count = 1.0f / fr.count;
  for (int ch = 0; ch < 3; ++ch) {
    fr.m[ch] = fold ? __ldg(mean + ch) : 0.0f;
    fr.sd[ch] = fold ? __ldg(stdv + ch) : 1.0f;
  }
  return fr;
}

// One image element as f32.
__device__ __forceinline__ float load_elem(const uint8_t* p) { return (float)__ldg(p); }
__device__ __forceinline__ float load_elem(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ float load_elem(const float* p) { return __ldg(p); }

__device__ __forceinline__ void store_elem(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_elem(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }

// Two adjacent elements at an even element offset, as f32.
__device__ __forceinline__ void load_pair(const uint8_t* p, float& a, float& b) {
  const uchar2 v = __ldg(reinterpret_cast<const uchar2*>(p));
  a = (float)v.x;
  b = (float)v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a, float& b) {
  const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  a = v.x;
  b = v.y;
}

// The 6 elements of pixels b and b + 1 (elements 3b .. 3b + 5), from one
// address: three aligned pairs from the even element at or before 3b, and
// for odd b the element after them.
template <typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ img, int b, float v[6]) {
  const int odd = b & 1;
  const T* p = img + (3 * b - odd);
  float a[7];
  load_pair(p, a[0], a[1]);
  load_pair(p + 2, a[2], a[3]);
  load_pair(p + 4, a[4], a[5]);
  a[6] = odd ? load_elem(p + 6) : 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = odd ? a[k + 1] : a[k];
}

// Adds the bilinear sample at image point (y, x) to acc: the taps of
// bilinear_taps, each image row's two read as one run.  NARROW: a
// one-pixel-wide image, whose two taps of a row are always one pixel.
template <bool NARROW, typename T, typename Scale>
__device__ __forceinline__ void add_sample(const CropFrame& fr, const T* __restrict__ img, int H,
                                           int W, int fold, float y, float x, Scale per_count,
                                           float acc[3]) {
  const TapCoords c = tap_coords(y, x, H, W, per_count);
  if (!c.inside) return;
  float t[4][3];
  if (NARROW) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      t[0][ch] = t[1][ch] = load_elem(img + 3 * c.yi + ch);
      t[2][ch] = t[3][ch] = load_elem(img + 3 * c.yi1 + ch);
    }
  } else {
    // the run of pixels (xi, xi + 1); in the last column, where both taps
    // are pixel xi, the run (xi - 1, xi)
    const bool last = c.xi1 == c.xi;
    const int b = c.xi - last;
    float top[6], bot[6];
    load_run(img, c.yi * W + b, top);
    load_run(img, c.yi1 * W + b, bot);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      t[0][ch] = last ? top[3 + ch] : top[ch];
      t[1][ch] = top[3 + ch];
      t[2][ch] = last ? bot[3 + ch] : bot[ch];
      t[3][ch] = bot[3 + ch];
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float v = ((t[0][ch] * c.w00 + t[1][ch] * c.w01) + t[2][ch] * c.w10) + t[3][ch] * c.w11;
    if (fold) v = (v - (((c.w00 + c.w01) + c.w10) + c.w11) * fr.m[ch]) / fr.sd[ch];
    acc[ch] = acc[ch] + v;
  }
}

// A runtime grid: pixel (i, j), its samples in (iy, ix) order.  per_h,
// per_w, per_count divide by g_h, g_w and g_h * g_w.
template <bool NARROW, typename T, typename Scale>
__device__ __forceinline__ void runtime_grid_pixel(const CropFrame& fr, const T* __restrict__ img,
                                                   int H, int W, int fold, int i, int j,
                                                   Scale per_h, Scale per_w, Scale per_count,
                                                   float acc[3]) {
  for (int iy = 0; iy < fr.gh; ++iy) {
    const float yy = sample_offset(fr.rh, fr.bin_h, i, iy, per_h);
    for (int ix = 0; ix < fr.gw; ++ix) {
      const float xx = sample_offset(fr.rw, fr.bin_w, j, ix, per_w);
      add_sample<NARROW>(fr, img, H, W, fold, (yy * fr.cos_t - xx * fr.sin_t) + fr.cy,
                         (yy * fr.sin_t + xx * fr.cos_t) + fr.cx, per_count, acc);
    }
  }
}

// Divisions by a compile-time grid side G (1 or 2) and by G * G: exact.
template <int G> struct FixedScale;
template <> struct FixedScale<1> {
  __device__ static Identity side() { return Identity{}; }
  __device__ static Identity count() { return Identity{}; }
};
template <> struct FixedScale<2> {
  __device__ static MultiplyBy side() { return MultiplyBy{0.5f}; }
  __device__ static MultiplyBy count() { return MultiplyBy{0.25f}; }
};

template <typename TOut>
__device__ __forceinline__ void store_pixel(const float acc[3], TOut* o) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) store_elem(acc[ch], o + ch);
}

// Output rows [i0, i1) of crop r with frame f, one column a thread (and
// every kThreads-th after it).  G: the grid side when every roi has the
// fixed G x G grid (1 or 2), or 0 for each roi's grid at run time.
template <typename TIn, typename TOut, int G, bool NARROW>
__device__ __forceinline__ void crop_band(const CropFrame& f, const TIn* __restrict__ img, int H,
                                          int W, int OH, int OW, int fold, int r, int i0, int i1,
                                          TOut* __restrict__ out) {
  for (int j = threadIdx.x; j < OW; j += kThreads) {
    TOut* o = out + (((long long)r * OH + i0) * OW + j) * 3;
    if constexpr (G > 0) {
      // the column's sample offsets times sin and cos, once
      float xs[G], xc[G];
#pragma unroll
      for (int ix = 0; ix < G; ++ix) {
        const float xx = sample_offset(f.rw, f.bin_w, j, ix, FixedScale<G>::side());
        xs[ix] = xx * f.sin_t;
        xc[ix] = xx * f.cos_t;
      }
      for (int i = i0; i < i1; ++i, o += 3 * OW) {
        float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int iy = 0; iy < G; ++iy) {
          const float yy = sample_offset(f.rh, f.bin_h, i, iy, FixedScale<G>::side());
          const float yc = yy * f.cos_t, ys = yy * f.sin_t;
#pragma unroll
          for (int ix = 0; ix < G; ++ix)
            add_sample<NARROW>(f, img, H, W, fold, (yc - xs[ix]) + f.cy, (ys + xc[ix]) + f.cx,
                               FixedScale<G>::count(), acc);
        }
        store_pixel(acc, o);
      }
    } else {
      for (int i = i0; i < i1; ++i, o += 3 * OW) {
        float acc[3] = {0.0f, 0.0f, 0.0f};
        if (f.pow2) {
          runtime_grid_pixel<NARROW>(f, img, H, W, fold, i, j, MultiplyBy{f.inv_h},
                                     MultiplyBy{f.inv_w}, MultiplyBy{f.inv_count}, acc);
        } else {
          runtime_grid_pixel<NARROW>(f, img, H, W, fold, i, j, DivideBy{f.ghf}, DivideBy{f.gwf},
                                     DivideBy{f.count}, acc);
        }
        store_pixel(acc, o);
      }
    }
  }
}

// Block (r, b) computes output rows [b * rows_per_block, ...) of crop r.
template <typename TIn, typename TOut, int G, bool NARROW>
__global__ void __launch_bounds__(kThreads)
crop_rois_kernel(const TIn* __restrict__ img, int H, int W, const float* __restrict__ rois,
                 int sampling_ratio, int max_sampling_ratio, int OH, int OW, int fold,
                 const float* __restrict__ mean, const float* __restrict__ stdv,
                 int rows_per_block, TOut* __restrict__ out) {
  const int r = blockIdx.x;
  const int i0 = blockIdx.y * rows_per_block;
  // every thread computes the roi's frame: no shared memory, no barrier
  const CropFrame f =
      make_frame(rois + 5 * r, sampling_ratio, max_sampling_ratio, OH, OW, fold, mean, stdv);
  crop_band<TIn, TOut, G, NARROW>(f, img, H, W, OH, OW, fold, r, i0,
                                  min(i0 + rows_per_block, OH), out);
}

template <typename TIn, typename TOut, bool NARROW>
void launch(int sampling_ratio, dim3 blocks, int threads, cudaStream_t s, const void* img, int H,
            int W, const float* rois, int max_sampling_ratio, int OH, int OW, int fold,
            const float* mean, const float* stdv, int rows_per_block, void* out) {
  const TIn* im = static_cast<const TIn*>(img);
  TOut* o = static_cast<TOut*>(out);
  if (sampling_ratio == 1) {
    crop_rois_kernel<TIn, TOut, 1, NARROW><<<blocks, threads, 0, s>>>(
        im, H, W, rois, sampling_ratio, max_sampling_ratio, OH, OW, fold, mean, stdv,
        rows_per_block, o);
  } else if (sampling_ratio == 2) {
    crop_rois_kernel<TIn, TOut, 2, NARROW><<<blocks, threads, 0, s>>>(
        im, H, W, rois, sampling_ratio, max_sampling_ratio, OH, OW, fold, mean, stdv,
        rows_per_block, o);
  } else {
    crop_rois_kernel<TIn, TOut, 0, NARROW><<<blocks, threads, 0, s>>>(
        im, H, W, rois, sampling_ratio, max_sampling_ratio, OH, OW, fold, mean, stdv,
        rows_per_block, o);
  }
}

template <typename TIn, typename TOut>
void launch_any(int sampling_ratio, dim3 blocks, int threads, cudaStream_t s, const void* img,
                int H, int W, const float* rois, int max_sampling_ratio, int OH, int OW,
                int fold, const float* mean, const float* stdv, int rows_per_block, void* out) {
  if (W == 1) {
    launch<TIn, TOut, true>(sampling_ratio, blocks, threads, s, img, H, W, rois,
                            max_sampling_ratio, OH, OW, fold, mean, stdv, rows_per_block, out);
  } else {
    launch<TIn, TOut, false>(sampling_ratio, blocks, threads, s, img, H, W, rois,
                             max_sampling_ratio, OH, OW, fold, mean, stdv, rows_per_block, out);
  }
}

// Launches the kernel over R crops, one block per (roi, band of
// rows_per_block output rows).
int launch_crop(const void* img, int dtype, int H, int W, const float* rois, int R,
                int sampling_ratio, int max_sampling_ratio, int OH, int OW, int fold,
                const float* mean, const float* stdv, int rows_per_block, void* out,
                cudaStream_t s) {
  if (R == 0) return 0;
  const int bands = rows_per_block > 0 ? (OH + rows_per_block - 1) / rows_per_block : 0;
  // element offsets of the image are 32-bit; grid.y takes at most 65535 bands
  if (bands <= 0 || bands > 65535 || H * W < 2 || 3LL * H * W > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((unsigned)R, (unsigned)bands);
  const int threads = min(kThreads, ((OW + 31) / 32) * 32);
  if (dtype == kUInt8) {
    launch_any<uint8_t, float>(sampling_ratio, blocks, threads, s, img, H, W, rois,
                               max_sampling_ratio, OH, OW, fold, mean, stdv, rows_per_block, out);
  } else if (dtype == kFloat32) {
    launch_any<float, float>(sampling_ratio, blocks, threads, s, img, H, W, rois,
                             max_sampling_ratio, OH, OW, 0, mean, stdv, rows_per_block, out);
  } else if (dtype == kBFloat16) {
    launch_any<__nv_bfloat16, __nv_bfloat16>(sampling_ratio, blocks, threads, s, img, H, W, rois,
                                             max_sampling_ratio, OH, OW, 0, mean, stdv,
                                             rows_per_block, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int glass_crop_rois(const void* img, int dtype, int H, int W, const float* rois, int R,
                               int sampling_ratio, int max_sampling_ratio, int OH, int OW,
                               int fold, const float* mean, const float* stdv, void* out,
                               void* stream) {
  return launch_crop(img, dtype, H, W, rois, R, sampling_ratio, max_sampling_ratio, OH, OW, fold,
                     mean, stdv, kRowsPerBlock, out, (cudaStream_t)stream);
}
