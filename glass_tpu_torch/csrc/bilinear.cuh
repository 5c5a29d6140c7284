// Shared device routines of the rotated RoIAlign kernels
// (roi_align_rotated.cu, crop_rois.cu): dtype conversion and the
// detectron2 ROIAlignRotated bilinear tap rule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element types a kernel is instantiated for (the `dtype` argument of the
// C entry points).
enum GlassDtype { kFloat32 = 0, kBFloat16 = 1, kUInt8 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(uint8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The four bilinear taps of one sample point on an H x W map: element
// offsets (row-major y * W + x) and weights already divided by the bin's
// sample count.  Follows detectron2's ROIAlignRotated boundary rule: a
// sample outside [-1, H] x [-1, W] contributes zero, coordinates are
// clamped at 0, and a sample in the last row/column snaps onto it.
struct Taps {
  int i00, i01, i10, i11;
  float w00, w01, w10, w11;
  bool inside;
};

__device__ __forceinline__ Taps bilinear_taps(float y, float x, int H, int W, float count) {
  Taps t;
  const float hf = (float)H, wf = (float)W;
  t.inside = !(y < -1.0f || y > hf || x < -1.0f || x > wf);
  if (!t.inside) {
    t.i00 = t.i01 = t.i10 = t.i11 = 0;
    t.w00 = t.w01 = t.w10 = t.w11 = 0.0f;
    return t;
  }
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
  const int yi = (int)yl, xi = (int)xl;
  const int yi1 = min(yi + 1, H - 1), xi1 = min(xi + 1, W - 1);
  t.i00 = yi * W + xi;
  t.i01 = yi * W + xi1;
  t.i10 = yi1 * W + xi;
  t.i11 = yi1 * W + xi1;
  t.w00 = (hy * hx) / count;
  t.w01 = (hy * lx) / count;
  t.w10 = (ly * hx) / count;
  t.w11 = (ly * lx) / count;
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
// the plain PyTorch version (and of glass_tpu's XLA formulation).
__device__ __forceinline__ float sample_offset(float extent, float bin, int p, int g, float grid) {
  return (-extent / 2.0f + (float)p * bin) + ((float)g + 0.5f) * bin / grid;
}
