// K1b: the backward of K1 (rotated RoIAlign over a packed, channels-last
// feature pyramid) with respect to the features.  Hand-written for Hopper
// (sm_90a).
//
// Replaces: what glass_tpu gets from XLA autodiff of its pooler, a
// scatter-add of every sample's four weighted taps
// (glass_tpu/ops/roi_align_rotated.py::_packed_pool_impl and
// roi_align_rotated), which the reference ran as detectron2's hand-written
// ROIAlignRotated_backward.  The rois carry no gradient, as in detectron2.
//
// Inputs:
//   grad_out    (R, PH, PW, C) upstream gradient, f32 or bf16
//   rois, level_meta, levels, grid: as K1 (roi_align_rotated.cu)
//   grad_feat   (sum_l H_l * W_l, C) f32, zeroed by the wrapper; every
//               sample adds w * grad_out / count into its four tap rows
//
// What bounds it on the H100: the least bytes are the upstream gradient
// read once plus a read-modify-write of every f32 feature row that a tap
// touches (chip_smoke.py phase 7 prints that bound).  The kernel moves far
// more: each sample of each bin adds into four rows with one f32 atomic a
// channel, so a roi's overlapping samples hit the same rows many times and
// the atomics' throughput in L2, not DRAM, sets the time.
//
// Design (a simple form that is right; pre-reducing the taps that repeat
// within a roi in shared memory, and sorting rois, are later work):
// * Work unit: one 8-warp block per (roi, band of bin rows), about
//   kTileBins bins a block.  A warp takes every 8th bin of the band.
// * Set-up once: thread 0 computes the roi's frame into shared memory with
//   the forward's operations in its order, so that every sample position,
//   tap row and weight is bit-identical to K1's (the same bilinear.cuh
//   routines, -fmad=false).
// * Per sample, each lane computes the taps itself (no table: the lanes of
//   a warp do the same scalar work) and adds w * g into the four rows with
//   scalar float atomicAdd (RED.ADD.F32 in L2).  Lanes take consecutive
//   channels (c = lane + 32 k), so each warp instruction adds into 128
//   contiguous bytes of a row: four 32-byte sectors.  The first form gave
//   each lane a 16-byte vector of channels (8 bf16 or 4 f32), so one warp
//   instruction hit a sector per lane or per two lanes; bf16 ran at twice
//   f32's time (chip_smoke.py phase 7, PERF.md).  The upstream gradient's
//   row is read again for each sample, from L1.
// * The per-roi (g_h, g_w) table is read as in the forward, so glass_tpu's
//   bulk-plus-budget split grid gets its exact gradient.
#include "bilinear.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTileBins = 16;  // bins a block takes, about

struct RoiFrame {
  float cx, cy, rw, rh, cos_t, sin_t, bin_h, bin_w, ghf, gwf, count;
  float inv_h, inv_w, inv_count;
  int H, W, gh, gw, pow2;
  long long base;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Sample s (row-major over the g_h x g_w grid) of bin (ph, pw): K1's
// fill_entry, the same operations in the same order.
template <typename Scale>
__device__ __forceinline__ Taps sample_taps(const RoiFrame& fr, int ph, int pw, int iy, int ix,
                                            Scale per_h, Scale per_w, Scale per_count) {
  const float yy = sample_offset(fr.rh, fr.bin_h, ph, iy, per_h);
  const float xx = sample_offset(fr.rw, fr.bin_w, pw, ix, per_w);
  const float y = (yy * fr.cos_t - xx * fr.sin_t) + fr.cy;
  const float x = (yy * fr.sin_t + xx * fr.cos_t) + fr.cx;
  return bilinear_taps(y, x, fr.H, fr.W, per_count);
}

__device__ __forceinline__ Taps taps_of(const RoiFrame& fr, int ph, int pw, int s) {
  const int iy = s / fr.gw;
  const int ix = s - iy * fr.gw;
  if (fr.pow2) {
    return sample_taps(fr, ph, pw, iy, ix, MultiplyBy{fr.inv_h}, MultiplyBy{fr.inv_w},
                       MultiplyBy{fr.inv_count});
  }
  return sample_taps(fr, ph, pw, iy, ix, DivideBy{fr.ghf}, DivideBy{fr.gwf}, DivideBy{fr.count});
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
roi_align_rotated_backward_kernel(const T* __restrict__ grad_out, int C,
                                  const float* __restrict__ rois,
                                  const float* __restrict__ level_meta,
                                  const int* __restrict__ levels, const int* __restrict__ grid,
                                  int PH, int PW, int tile_h, float* __restrict__ grad_feat) {
  __shared__ RoiFrame fr;

  const int bands = (PH + tile_h - 1) / tile_h;
  const int r = blockIdx.x / bands;
  const int h0 = (blockIdx.x - r * bands) * tile_h;
  const int th = min(tile_h, PH - h0);
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

  const int n = fr.gh * fr.gw;
  if (n <= 0) return;  // an empty grid pooled zeros: no gradient
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* g_base = grad_feat + fr.base * C;
  for (int k = warp; k < th * PW; k += kWarps) {
    const int ph = h0 + k / PW;
    const int pw = k - (k / PW) * PW;
    const T* go = grad_out + (((long long)r * PH + ph) * PW + pw) * C;
    for (int s = 0; s < n; ++s) {
      const Taps t = taps_of(fr, ph, pw, s);
      if (!t.inside) continue;  // a sample outside the map added zero
      float* r00 = g_base + (long long)t.i00 * C;
      float* r01 = g_base + (long long)t.i01 * C;
      float* r10 = g_base + (long long)t.i10 * C;
      float* r11 = g_base + (long long)t.i11 * C;
      for (int c = lane; c < C; c += 32) {
        const float g = to_float(__ldg(go + c));
        // a tap of weight zero adds nothing
        if (t.w00 != 0.0f) atomicAdd(r00 + c, t.w00 * g);
        if (t.w01 != 0.0f) atomicAdd(r01 + c, t.w01 * g);
        if (t.w10 != 0.0f) atomicAdd(r10 + c, t.w10 * g);
        if (t.w11 != 0.0f) atomicAdd(r11 + c, t.w11 * g);
      }
    }
  }
}

}  // namespace

extern "C" int glass_roi_align_rotated_backward(const void* grad_out, int dtype, int C,
                                                const float* rois, const float* level_meta,
                                                const int* levels, const int* grid, int R, int PH,
                                                int PW, float* grad_feat, void* stream) {
  if (R == 0) return 0;
  if (PH <= 0 || PW <= 0) return (int)cudaErrorInvalidValue;
  const int tile_h = min(PH, max(1, kTileBins / PW));
  const dim3 blocks((unsigned)(R * ((PH + tile_h - 1) / tile_h)));
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32 && C % 4 == 0) {
    roi_align_rotated_backward_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        (const float*)grad_out, C, rois, level_meta, levels, grid, PH, PW, tile_h, grad_feat);
  } else if (dtype == kBFloat16 && C % 8 == 0) {
    roi_align_rotated_backward_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, s>>>(
        (const __nv_bfloat16*)grad_out, C, rois, level_meta, levels, grid, PH, PW, tile_h,
        grad_feat);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
