// Design alternatives of kernels K1 and K2, built beside the shipped
// kernels for a device-time comparison (kernel_variants.py).  Nothing on
// the port's path loads this library.
//
// K1 (roi_align_rotated.cu): the shipped kernel at other tiles of bins.
// K2 (crop_rois.cu): the shipped kernel at other rows per block, and two
// variants of the design its header weighs:
//   kFrameOnce:   thread 0 computes the roi's frame into shared memory and
//                 the block waits at a barrier (shipped: every thread
//                 computes it into registers);
//   kVectorStore: a thread computes a run of 16 / sizeof(out) pixels of
//                 one output row (8 bf16, 4 f32) and writes its 48 bytes as
//                 three 16-byte stores (shipped: one pixel a thread, three
//                 scalar stores).
// Both variants do the shipped arithmetic in the shipped order, so their
// output equals the shipped kernel's bit for bit.
#include "../csrc/crop_rois.cu"
#include "../csrc/roi_align_rotated.cu"

#include <type_traits>

namespace {

enum CropVariant { kFrameOnce = 1, kVectorStore = 2 };

template <typename TIn, typename TOut, int G>
__global__ void __launch_bounds__(kThreads)
frame_once_kernel(const TIn* __restrict__ img, int H, int W, const float* __restrict__ rois,
                  int sampling_ratio, int max_sampling_ratio, int OH, int OW, int fold,
                  const float* __restrict__ mean, const float* __restrict__ stdv,
                  int rows_per_block, TOut* __restrict__ out) {
  __shared__ CropFrame sf;
  const int r = blockIdx.x;
  const int i0 = blockIdx.y * rows_per_block;
  if (threadIdx.x == 0)
    sf = make_frame(rois + 5 * r, sampling_ratio, max_sampling_ratio, OH, OW, fold, mean, stdv);
  __syncthreads();
  crop_band<TIn, TOut, G, false>(sf, img, H, W, OH, OW, fold, r, i0,
                                 min(i0 + rows_per_block, OH), out);
}

template <typename TIn, typename TOut, int G>
__global__ void __launch_bounds__(kThreads)
vector_store_kernel(const TIn* __restrict__ img, int H, int W, const float* __restrict__ rois,
                    int sampling_ratio, int max_sampling_ratio, int OH, int OW, int fold,
                    const float* __restrict__ mean, const float* __restrict__ stdv,
                    int rows_per_block, TOut* __restrict__ out) {
  constexpr int kRun = 16 / sizeof(TOut);
  const int r = blockIdx.x;
  const int runs = OW / kRun;
  const int row = threadIdx.x / runs;
  const int i = blockIdx.y * rows_per_block + row;
  if (row >= rows_per_block || i >= OH) return;
  const int j0 = (threadIdx.x - row * runs) * kRun;
  const CropFrame f =
      make_frame(rois + 5 * r, sampling_ratio, max_sampling_ratio, OH, OW, fold, mean, stdv);
  alignas(16) TOut v[3 * kRun];
#pragma unroll
  for (int p = 0; p < kRun; ++p) {
    const int j = j0 + p;
    float acc[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (G > 0) {
#pragma unroll
      for (int iy = 0; iy < G; ++iy) {
        const float yy = sample_offset(f.rh, f.bin_h, i, iy, FixedScale<G>::side());
        const float yc = yy * f.cos_t, ys = yy * f.sin_t;
#pragma unroll
        for (int ix = 0; ix < G; ++ix) {
          const float xx = sample_offset(f.rw, f.bin_w, j, ix, FixedScale<G>::side());
          add_sample<false>(f, img, H, W, fold, (yc - xx * f.sin_t) + f.cy,
                            (ys + xx * f.cos_t) + f.cx, FixedScale<G>::count(), acc);
        }
      }
    } else if (f.pow2) {
      runtime_grid_pixel<false>(f, img, H, W, fold, i, j, MultiplyBy{f.inv_h},
                                MultiplyBy{f.inv_w}, MultiplyBy{f.inv_count}, acc);
    } else {
      runtime_grid_pixel<false>(f, img, H, W, fold, i, j, DivideBy{f.ghf}, DivideBy{f.gwf},
                                DivideBy{f.count}, acc);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) store_elem(acc[ch], v + 3 * p + ch);
  }
  uint4* o = reinterpret_cast<uint4*>(out + (((long long)r * OH + i) * OW + j0) * 3);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = reinterpret_cast<const uint4*>(v)[k];
}

template <typename TIn, typename TOut>
using CropKernel = void (*)(const TIn*, int, int, const float*, int, int, int, int, int,
                            const float*, const float*, int, TOut*);

template <typename TIn, typename TOut, int G>
CropKernel<TIn, TOut> pick(bool frame_once) {
  if (frame_once) return frame_once_kernel<TIn, TOut, G>;
  return vector_store_kernel<TIn, TOut, G>;
}

template <typename TIn, typename TOut>
int launch_variant(int variant, const void* img, int H, int W, const float* rois, int R,
                   int sampling_ratio, int max_sampling_ratio, int OH, int OW, int fold,
                   const float* mean, const float* stdv, void* out, cudaStream_t s) {
  constexpr int kRun = 16 / sizeof(TOut);
  const bool frame_once = variant == kFrameOnce;
  CropKernel<TIn, TOut> k = sampling_ratio == 1   ? pick<TIn, TOut, 1>(frame_once)
                            : sampling_ratio == 2 ? pick<TIn, TOut, 2>(frame_once)
                                                  : pick<TIn, TOut, 0>(frame_once);
  // kVectorStore: one run a thread, so a block takes kThreads runs
  if (!frame_once && (OW % kRun != 0 || OW > kThreads * kRun)) return (int)cudaErrorInvalidValue;
  const int rows = frame_once ? kRowsPerBlock : kThreads * kRun / OW;
  if (R == 0) return 0;
  if (W < 2) return (int)cudaErrorInvalidValue;
  const dim3 blocks((unsigned)R, (unsigned)((OH + rows - 1) / rows));
  const int threads = min(kThreads, ((OW + 31) / 32) * 32);
  k<<<blocks, frame_once ? threads : kThreads, 0, s>>>(
      static_cast<const TIn*>(img), H, W, rois, sampling_ratio, max_sampling_ratio, OH, OW,
      std::is_same<TIn, uint8_t>::value ? fold : 0, mean, stdv, rows, static_cast<TOut*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// K1 over tiles of tile_h x tile_w bins.
extern "C" int study_roi_align_tile(const void* feat, int dtype, int C, const float* rois,
                                    const float* level_meta, const int* levels, const int* grid,
                                    int R, int PH, int PW, int tile_h, int tile_w, void* out,
                                    void* stream) {
  return launch_roi_align(feat, dtype, C, rois, level_meta, levels, grid, R, PH, PW, tile_h,
                          tile_w, out, (cudaStream_t)stream);
}

// K2 with bands of rows_per_block output rows.
extern "C" int study_crop_rows(const void* img, int dtype, int H, int W, const float* rois, int R,
                               int sampling_ratio, int max_sampling_ratio, int OH, int OW,
                               int fold, const float* mean, const float* stdv,
                               int rows_per_block, void* out, void* stream) {
  return launch_crop(img, dtype, H, W, rois, R, sampling_ratio, max_sampling_ratio, OH, OW, fold,
                     mean, stdv, rows_per_block, out, (cudaStream_t)stream);
}

// K2 variant kFrameOnce or kVectorStore.
extern "C" int study_crop_variant(int variant, const void* img, int dtype, int H, int W,
                                  const float* rois, int R, int sampling_ratio,
                                  int max_sampling_ratio, int OH, int OW, int fold,
                                  const float* mean, const float* stdv, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (variant != kFrameOnce && variant != kVectorStore) return (int)cudaErrorInvalidValue;
  if (dtype == kUInt8)
    return launch_variant<uint8_t, float>(variant, img, H, W, rois, R, sampling_ratio,
                                          max_sampling_ratio, OH, OW, fold, mean, stdv, out, s);
  if (dtype == kFloat32)
    return launch_variant<float, float>(variant, img, H, W, rois, R, sampling_ratio,
                                        max_sampling_ratio, OH, OW, fold, mean, stdv, out, s);
  if (dtype == kBFloat16)
    return launch_variant<__nv_bfloat16, __nv_bfloat16>(variant, img, H, W, rois, R,
                                                        sampling_ratio, max_sampling_ratio, OH,
                                                        OW, fold, mean, stdv, out, s);
  return (int)cudaErrorInvalidValue;
}
