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
//   feat        (sum_l H_l * W_l, C) level maps concatenated row-wise, f32 or bf16
//   rois        (R, 5) f32 (cx, cy, w, h, angle in degrees), image coordinates
//   level_meta  (L, 4) f32 rows (spatial scale, H, W, row offset)
//   levels      (R,) int32 level of each roi
//   grid        (R, 2) int32 sampling grid (g_h, g_w) of each roi; the
//               wrapper resolves fixed, adaptive-capped and bulk/large-roi
//               budget grids into this table, so one launch serves them all
//   out         (R, PH, PW, C) in the feature dtype, f32 accumulation
//
// What bounds it on the H100: bytes.  At the main-path shapes (100 rois,
// C = 256 bf16) a bin does 8-64 flops per channel against 4 taps of 2 bytes
// per sample, far below the ~20 flop/byte ridge of f32 CUDA-core math, and
// the taps are scattered rows of the pyramid, so the cost is the latency of
// gathered row reads, not arithmetic.
//
// Design: one block per (roi, bin), threads across C.  Every bilinear tap
// is then one coalesced read of a contiguous C-vector (512 bytes in bf16),
// the sample coordinates are scalar math each thread repeats in registers,
// and neighbouring bins of a roi (adjacent blocks) share footprint rows in
// L2.  There is no tile and hence no limit on roi extent (the Pallas form
// DMAed a fixed 48x56 VMEM tile per roi).  Staging a roi's footprint in
// shared memory with TMA is later work.
#include "bilinear.cuh"

template <typename T>
__global__ void roi_align_rotated_kernel(const T* __restrict__ feat, int C,
                                         const float* __restrict__ rois,
                                         const float* __restrict__ level_meta,
                                         const int* __restrict__ levels,
                                         const int* __restrict__ grid, int PH, int PW,
                                         T* __restrict__ out) {
  const int bin = blockIdx.x;
  const int r = bin / (PH * PW);
  const int rem = bin - r * PH * PW;
  const int ph = rem / PW;
  const int pw = rem - ph * PW;

  const int lvl = levels[r];
  const float scale = level_meta[4 * lvl + 0];
  const int H = (int)level_meta[4 * lvl + 1];
  const int W = (int)level_meta[4 * lvl + 2];
  const long long base = (long long)level_meta[4 * lvl + 3];

  const float* roi = rois + 5 * r;
  const float cx = roi[0] * scale - 0.5f;
  const float cy = roi[1] * scale - 0.5f;
  const float rw = roi[2] * scale;
  const float rh = roi[3] * scale;
  const float theta = (roi[4] * 3.14159265358979323846f) * (1.0f / 180.0f);
  const float cos_t = cosf(theta);
  const float sin_t = sinf(theta);
  const int gh = grid[2 * r + 0];
  const int gw = grid[2 * r + 1];
  const float ghf = (float)gh, gwf = (float)gw;
  const float bin_h = rh * (1.0f / (float)PH);
  const float bin_w = rw * (1.0f / (float)PW);
  const float count = ghf * gwf;

  const T* f = feat + base * C;
  T* o = out + (long long)bin * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.0f;
    for (int iy = 0; iy < gh; ++iy) {
      const float yy = sample_offset(rh, bin_h, ph, iy, ghf);
      for (int ix = 0; ix < gw; ++ix) {
        const float xx = sample_offset(rw, bin_w, pw, ix, gwf);
        const float y = (yy * cos_t - xx * sin_t) + cy;
        const float x = (yy * sin_t + xx * cos_t) + cx;
        const Taps t = bilinear_taps(y, x, H, W, count);
        if (!t.inside) continue;
        const float v = ((to_float(f[(long long)t.i00 * C + c]) * t.w00 +
                          to_float(f[(long long)t.i01 * C + c]) * t.w01) +
                         to_float(f[(long long)t.i10 * C + c]) * t.w10) +
                        to_float(f[(long long)t.i11 * C + c]) * t.w11;
        acc = acc + v;
      }
    }
    o[c] = from_float<T>(acc);
  }
}

extern "C" int glass_roi_align_rotated(const void* feat, int dtype, int C, const float* rois,
                                       const float* level_meta, const int* levels,
                                       const int* grid, int R, int PH, int PW, void* out,
                                       void* stream) {
  if (R == 0) return 0;
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  const dim3 blocks((unsigned)(R * PH * PW));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32) {
    roi_align_rotated_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)feat, C, rois, level_meta, levels, grid, PH, PW, (float*)out);
  } else if (dtype == kBFloat16) {
    roi_align_rotated_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)feat, C, rois, level_meta, levels, grid, PH, PW,
        (__nv_bfloat16*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
