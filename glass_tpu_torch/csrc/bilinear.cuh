// Shared device routines of the rotated RoIAlign kernels
// (roi_align_rotated.cu, crop_rois.cu): the detectron2 ROIAlignRotated
// bilinear tap rule and its sample offsets.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element types a kernel is instantiated for (the `dtype` argument of the
// C entry points).
enum GlassDtype { kFloat32 = 0, kBFloat16 = 1, kUInt8 = 2 };

// The four bilinear taps of one sample point on an H x W map: element
// offsets (row-major y * W + x) and weights already divided by the bin's
// sample count.  Follows detectron2's ROIAlignRotated boundary rule: a
// sample outside [-1, H] x [-1, W] contributes zero (its taps are element
// 0 with weight 0), coordinates are clamped at 0, and a sample in the last
// row/column snaps onto it.
struct Taps {
  int i00, i01, i10, i11;
  float w00, w01, w10, w11;
  bool inside;
};

// Weight scalings: a division by the bin's sample count, as the plain
// version does it, or a multiplication by its inverse, which gives the same
// bits when the count is a power of two (both are exact scalings by 2^-k,
// rounded once).
struct DivideBy {
  float count;
  __device__ __forceinline__ float operator()(float w) const { return w / count; }
};
struct MultiplyBy {
  float inverse;
  __device__ __forceinline__ float operator()(float w) const { return w * inverse; }
};
// The division by a count of 1.
struct Identity {
  __device__ __forceinline__ float operator()(float w) const { return w; }
};

// The same rule as map coordinates: tap rows yi, yi1 and columns xi, xi1
// (xi1 == xi in the last column) and the four weights; when !inside the
// other fields are unset.
struct TapCoords {
  int yi, yi1, xi, xi1;
  float w00, w01, w10, w11;
  bool inside;
};

template <typename Scale>
__device__ __forceinline__ TapCoords tap_coords(float y, float x, int H, int W, Scale scale) {
  TapCoords t;
  const float hf = (float)H, wf = (float)W;
  t.inside = !(y < -1.0f || y > hf || x < -1.0f || x > wf);
  if (!t.inside) return t;
  y = fmaxf(y, 0.0f);
  x = fmaxf(x, 0.0f);
  const float yl = fminf(floorf(y), hf - 1.0f);
  const float xl = fminf(floorf(x), wf - 1.0f);
  if (yl >= hf - 1.0f) y = yl;
  if (xl >= wf - 1.0f) x = xl;
  const float ly = y - yl;
  const float lx = x - xl;
  const float hy = 1.0f - ly;
  const float hx = 1.0f - lx;
  t.yi = (int)yl;
  t.xi = (int)xl;
  t.yi1 = min(t.yi + 1, H - 1);
  t.xi1 = min(t.xi + 1, W - 1);
  t.w00 = scale(hy * hx);
  t.w01 = scale(hy * lx);
  t.w10 = scale(ly * hx);
  t.w11 = scale(ly * lx);
  return t;
}

template <typename Scale>
__device__ __forceinline__ Taps bilinear_taps(float y, float x, int H, int W, Scale scale) {
  const TapCoords c = tap_coords(y, x, H, W, scale);
  Taps t;
  t.inside = c.inside;
  if (!c.inside) {
    t.i00 = t.i01 = t.i10 = t.i11 = 0;
    t.w00 = t.w01 = t.w10 = t.w11 = 0.0f;
    return t;
  }
  t.i00 = c.yi * W + c.xi;
  t.i01 = c.yi * W + c.xi1;
  t.i10 = c.yi1 * W + c.xi;
  t.i11 = c.yi1 * W + c.xi1;
  t.w00 = c.w00;
  t.w01 = c.w01;
  t.w10 = c.w10;
  t.w11 = c.w11;
  return t;
}

// Arithmetic convention of both kernels: every operation is the IEEE f32
// operation the plain PyTorch version performs on the card, in the same
// order, with no FMA contraction (-fmad=false).  PyTorch's CUDA kernels
// divide by a scalar as a multiplication by its reciprocal, so the kernels
// do too (the degree-to-radian step and the bin size), which keeps a
// kernel and its plain version bit-identical in f32.
//
// Roi-frame offset of sample (bin p, grid g) along one axis:
// -extent/2 + p * bin + (g + 0.5) * bin / grid, in the operation order of
// the plain PyTorch version (and of glass_tpu's XLA formulation);
// per_grid is the division by the grid (DivideBy or MultiplyBy).
template <typename Scale>
__device__ __forceinline__ float sample_offset(float extent, float bin, int p, int g,
                                               Scale per_grid) {
  return (-extent / 2.0f + (float)p * bin) + per_grid(((float)g + 0.5f) * bin);
}

// Whether a g_h x g_w grid has power-of-two sides, so that its divisions
// (by g_h, g_w and g_h * g_w) may be multiplications by exact inverses.
__device__ __forceinline__ bool power_of_two_grid(int gh, int gw) {
  return gh > 0 && gw > 0 && (gh & (gh - 1)) == 0 && (gw & (gw - 1)) == 0;
}
