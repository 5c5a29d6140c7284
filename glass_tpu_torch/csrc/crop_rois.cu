// K2: rotated crops of the raw (H, W, 3) image, ROIAlignRotated at
// spatial_scale 1.  Hand-written for Hopper (sm_90a).
//
// Replaces: glass_tpu/ops/pallas_crop.py::_crop_kernel (entry point
// crop_rois_pallas), and the uint8 gather with the normalization folded in
// that glass_tpu ran through XLA (ops/roi_align_rotated.py::roi_align_rotated
// with normalize=(mean, std), glass_rcnn.py recognizer_encode).
//
// Inputs:
//   img    (H, W, 3) uint8, f32 or bf16, channels interleaved
//   rois   (R, 5) f32 (cx, cy, w, h, angle in degrees)
//   sampling_ratio > 0: fixed g x g grid per output pixel; 0: adaptive
//          ceil(extent / out) per axis, capped at max_sampling_ratio
//   mean, std (3,) f32, used when fold != 0 (uint8 input): the output is
//          sum_k w_k * (raw_k - mean) / std, i.e. the crop of the
//          normalized image, computed per sample as (sum w raw - sum w *
//          mean) / std so out-of-bounds taps stay exact zeros
//   out    (R, OH, OW, 3): f32 for uint8 input, else the image dtype
//
// What bounds it on the H100: bytes.  100 crops of 128 x 128 x 3 write
// 19.7 MB in f32 (9.8 MB in bf16) and read a few bytes per tap; a sample
// costs ~30 flops for 12 channel taps, below the f32 ridge.
//
// Design: one thread per output pixel computes all three channels, so the
// 12 tap reads of a sample come from two rows of 2 adjacent pixels, and
// the threads of a block walk one output row, whose samples lie on one
// straight line through the image: their taps share cache lines.  The
// stores are 3 contiguous elements per thread, coalesced across the row.
// There is no tile, so none of the Pallas form's role swap, lane-gather
// passes or large-roi rescue loop are needed.
#include "bilinear.cuh"

template <typename TIn, typename TOut>
__global__ void crop_rois_kernel(const TIn* __restrict__ img, int H, int W,
                                 const float* __restrict__ rois, int sampling_ratio,
                                 int max_sampling_ratio, int OH, int OW, int fold,
                                 const float* __restrict__ mean, const float* __restrict__ stdv,
                                 TOut* __restrict__ out) {
  const int r = blockIdx.y;
  const int i = blockIdx.x;
  const float* roi = rois + 5 * r;
  const float cx = roi[0] * 1.0f - 0.5f;
  const float cy = roi[1] * 1.0f - 0.5f;
  const float rw = roi[2] * 1.0f;
  const float rh = roi[3] * 1.0f;
  const float theta = (roi[4] * 3.14159265358979323846f) * (1.0f / 180.0f);
  const float cos_t = cosf(theta);
  const float sin_t = sinf(theta);
  const float bin_h = rh * (1.0f / (float)OH);
  const float bin_w = rw * (1.0f / (float)OW);
  int gh, gw;
  if (sampling_ratio > 0) {
    gh = gw = sampling_ratio;
  } else {
    gh = (int)fminf(fmaxf(ceilf(rh * (1.0f / (float)OH)), 1.0f), (float)max_sampling_ratio);
    gw = (int)fminf(fmaxf(ceilf(rw * (1.0f / (float)OW)), 1.0f), (float)max_sampling_ratio);
  }
  const float ghf = (float)gh, gwf = (float)gw;
  const float count = ghf * gwf;
  float m[3] = {0.0f, 0.0f, 0.0f}, sd[3] = {1.0f, 1.0f, 1.0f};
  if (fold) {
    for (int ch = 0; ch < 3; ++ch) {
      m[ch] = mean[ch];
      sd[ch] = stdv[ch];
    }
  }

  for (int j = threadIdx.x; j < OW; j += blockDim.x) {
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int iy = 0; iy < gh; ++iy) {
      const float yy = sample_offset(rh, bin_h, i, iy, ghf);
      for (int ix = 0; ix < gw; ++ix) {
        const float xx = sample_offset(rw, bin_w, j, ix, gwf);
        const float y = (yy * cos_t - xx * sin_t) + cy;
        const float x = (yy * sin_t + xx * cos_t) + cx;
        const Taps t = bilinear_taps(y, x, H, W, count);
        if (!t.inside) continue;
        const float wsum = ((t.w00 + t.w01) + t.w10) + t.w11;
        for (int ch = 0; ch < 3; ++ch) {
          float v = ((to_float(img[3 * t.i00 + ch]) * t.w00 +
                      to_float(img[3 * t.i01 + ch]) * t.w01) +
                     to_float(img[3 * t.i10 + ch]) * t.w10) +
                    to_float(img[3 * t.i11 + ch]) * t.w11;
          if (fold) v = (v - wsum * m[ch]) / sd[ch];
          acc[ch] = acc[ch] + v;
        }
      }
    }
    TOut* o = out + (((long long)r * OH + i) * OW + j) * 3;
    for (int ch = 0; ch < 3; ++ch) o[ch] = from_float<TOut>(acc[ch]);
  }
}

extern "C" int glass_crop_rois(const void* img, int dtype, int H, int W, const float* rois, int R,
                               int sampling_ratio, int max_sampling_ratio, int OH, int OW,
                               int fold, const float* mean, const float* stdv, void* out,
                               void* stream) {
  if (R == 0) return 0;
  const int threads = OW >= 128 ? 128 : ((OW + 31) / 32) * 32;
  const dim3 blocks((unsigned)OH, (unsigned)R);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kUInt8) {
    crop_rois_kernel<uint8_t, float><<<blocks, threads, 0, s>>>(
        (const uint8_t*)img, H, W, rois, sampling_ratio, max_sampling_ratio, OH, OW, fold,
        mean, stdv, (float*)out);
  } else if (dtype == kFloat32) {
    crop_rois_kernel<float, float><<<blocks, threads, 0, s>>>(
        (const float*)img, H, W, rois, sampling_ratio, max_sampling_ratio, OH, OW, 0, mean,
        stdv, (float*)out);
  } else if (dtype == kBFloat16) {
    crop_rois_kernel<__nv_bfloat16, __nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)img, H, W, rois, sampling_ratio, max_sampling_ratio, OH, OW, 0,
        mean, stdv, (__nv_bfloat16*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
