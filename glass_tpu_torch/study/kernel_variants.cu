// Design alternatives of kernels K1, K1b and K2, built beside the shipped
// kernels for a device-time comparison (kernel_variants.py).  Nothing on
// the port's path loads this library.
//
// K1 (roi_align_rotated.cu): the shipped kernel at other tiles of bins.
// K1b (roi_align_rotated_backward.cu): the shipped design at other plans
// (tiles of bins, footprint rows, accumulator rows; footprint rows of 1
// send every tile to the direct path), and these variants (K1bVariant):
//   kScalarFlush:  the flush as four scalar atomics, not one float4;
//   kVec1, kVec4:  1 or 4 channels a scatter thread (blocks of 256 or 64
//                  threads), not 2;
//   kSharedAtomics: the first form of the redesign: per (roi, tile, group
//                  of 32-channel chunks) a shared tile of all footprint rows
//                  x 32 channels, warps on bins adding with shared atomics,
//                  the table built once and the chunks taken in turn;
//   kMemsetCast:   no marks: the f32 accumulator zeroed whole
//                  (cudaMemsetAsync), the tiles' frames (info_kernel), the
//                  scatter, then every row read back and rounded;
// and the baseline: the per-tap form (k1b_baseline below; the wrapper zeroes its
// f32 buffer and casts it after), one scalar L2 atomic a tap and channel.
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
#include "../csrc/roi_align_rotated_backward.cu"

#include <type_traits>

// ---------------------------------------------------------------------------
// K1b baseline: the per-tap form that roi_align_rotated_backward.cu's
// design replaced (grad_feat zeroed by the caller; f32 accumulation, cast
// by the caller).
//
// * Work unit: one 8-warp block per (roi, band of bin rows), about
//   kTileBins bins a block.  A warp takes every 8th bin of the band.
// * Set-up once: thread 0 computes the roi's frame into shared memory with
//   the forward's operations in its order.
// * Per sample, each lane computes the taps itself and adds w * g into the
//   four rows with scalar float atomicAdd (RED.ADD.F32 in L2), lanes on
//   consecutive channels (c = lane + 32 k).
// ---------------------------------------------------------------------------
namespace k1b_baseline {

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

}  // namespace k1b_baseline

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

namespace {

enum K1bVariant {
  kShipped = 0,
  kScalarFlush = 1,
  kSharedAtomics = 2,
  kMemsetCast = 3,
  kVec1 = 4,
  kVec4 = 5
};

}  // namespace

namespace k1b_shared {
using k1b::Args;
using k1b::flush_add;
using k1b::Footprint;
using k1b::kTableSamples;
using k1b::kThreads;
using k1b::kWarps;
using k1b::make_frame;
using k1b::Plan;
using k1b::RoiFrame;
using k1b::tile_footprint;
using k1b::tile_sample;
using k1b::to_float;
using k1b::Unit;
using k1b::unit_of;

__host__ __device__ constexpr int shared_smem_bytes(int cap_rows, int cc) {
  return cap_rows * cc * 4 + kTableSamples * 32 + ((cap_rows + 15) / 16) * 16;
}

// kCC channels a shared tile holds; warps take bins and add with shared
// atomics.
template <typename T, int kCC>
__global__ void __launch_bounds__(kThreads)
shared_scatter_kernel(const T* __restrict__ grad_out, int C, const float* __restrict__ rois,
                      const float* __restrict__ level_meta, const int* __restrict__ levels,
                      const int* __restrict__ grid, int PH, int PW, Plan p,
                      float* __restrict__ acc, int* __restrict__ stats) {
  static_assert(kCC % 32 == 0, "a chunk is whole warps of channels");
  constexpr int kPerLane = kCC / 32;
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  int4* tap_row = reinterpret_cast<int4*>(tile + (size_t)p.cap_rows * kCC);
  float4* tap_w = reinterpret_cast<float4*>(tap_row + kTableSamples);
  unsigned char* touched = reinterpret_cast<unsigned char*>(tap_w + kTableSamples);
  __shared__ RoiFrame fr;
  __shared__ Footprint fp;
  __shared__ int direct;

  const Unit t = unit_of(blockIdx.x, p, PH, PW);
  if (threadIdx.x == 0) {
    make_frame(fr, rois, level_meta, levels, grid, t.r, PH, PW);
    fp = tile_footprint(fr, t);
    direct = fp.fh * fp.fw > p.cap_rows;
    if (direct && blockIdx.y == 0) atomicAdd(stats + 0, 1);
  }
  __syncthreads();
  const int n = fr.gh * fr.gw;
  if (n <= 0 || fp.fh == 0) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool is_direct = direct;
  const int n_fp = is_direct ? 0 : fp.fh * fp.fw;
  const int tw = t.w1 - t.w0;
  const int total = (t.h1 - t.h0) * tw * n;
  const bool one_pass = total <= kTableSamples;
  for (int i = threadIdx.x; i < n_fp; i += kThreads) touched[i] = 0;

  // The table: per sample its four tap rows (local to the footprint, or
  // packed rows on the direct path; -1: no tap) and weights.
  auto place = [&](int y, int x, float w) -> int {
    if (w == 0.0f) return -1;
    if (is_direct) return (int)(fr.base + (long long)y * fr.W + x);
    const int ly = y - fp.y0, lx = x - fp.x0;
    if (ly < 0 || ly >= fp.fh || lx < 0 || lx >= fp.fw) {
      atomicAdd(stats + 1, 1);
      return -1;
    }
    const int l = ly * fp.fw + lx;
    touched[l] = 1;
    return l;
  };
  auto build = [&](int s0, int cnt) {
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const TapCoords c = tile_sample(fr, t, s0 + e);
      int4 rows = make_int4(-1, -1, -1, -1);
      float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c.inside) {
        rows = make_int4(place(c.yi, c.xi, c.w00), place(c.yi, c.xi1, c.w01),
                         place(c.yi1, c.xi, c.w10), place(c.yi1, c.xi1, c.w11));
        w = make_float4(c.w00, c.w01, c.w10, c.w11);
      }
      tap_row[e] = rows;
      tap_w[e] = w;
    }
  };
  // Adds the table's samples [s0, s0 + cnt) times the gradient of channels
  // [c0, c0 + kCC): each bin's gradient is read once.
  auto accumulate = [&](int s0, int cnt, int c0) {
    const int kb = s0 / n, ke = (s0 + cnt - 1) / n;
    for (int k = kb + warp; k <= ke; k += kWarps) {
      const int ph = t.h0 + k / tw;
      const int pw = t.w0 + (k - (k / tw) * tw);
      const T* go = grad_out + (((long long)t.r * PH + ph) * PW + pw) * C + c0;
      float g[kPerLane];
      int ch[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        ch[q] = lane + 32 * q;
        g[q] = c0 + ch[q] < C ? to_float(go[ch[q]]) : 0.0f;
      }
      const int e1 = min(s0 + cnt, (k + 1) * n) - s0;
      for (int e = max(s0, k * n) - s0; e < e1; ++e) {
        const int4 rr = tap_row[e];
        const float4 ww = tap_w[e];
        const int rows[4] = {rr.x, rr.y, rr.z, rr.w};
        const float ws[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (rows[j] < 0) continue;
#pragma unroll
          for (int q = 0; q < kPerLane; ++q) {
            if (c0 + ch[q] >= C) continue;
            const float v = ws[j] * g[q];
            if (is_direct) {
              atomicAdd(acc + (long long)rows[j] * C + c0 + ch[q], v);
            } else {
              atomicAdd(tile + rows[j] * kCC + ch[q], v);
            }
          }
        }
      }
    }
  };

  if (one_pass) {
    __syncthreads();  // touched[] zeroed
    build(0, total);
  }
  for (int c0 = blockIdx.y * kCC; c0 < C; c0 += gridDim.y * kCC) {
    float4* tile4 = reinterpret_cast<float4*>(tile);
    for (int i = threadIdx.x; i < n_fp * kCC / 4; i += kThreads)
      tile4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s0 = 0; s0 < total; s0 += kTableSamples) {
      const int cnt = min(kTableSamples, total - s0);
      if (!one_pass) {
        __syncthreads();  // the last pass's table is used up
        build(s0, cnt);
      }
      __syncthreads();
      accumulate(s0, cnt, c0);
    }
    __syncthreads();
    if (is_direct) continue;
    // flush: one 16-byte reduction a (touched row, 4 channels)
    constexpr int kQuads = kCC / 4;
    const int quads = min(kQuads, (C - c0) / 4);
    for (int i = threadIdx.x; i < n_fp * kQuads; i += kThreads) {
      const int l = i / kQuads;
      const int q = i - l * kQuads;
      if (q >= quads || !touched[l]) continue;
      const int ly = l / fp.fw;
      const long long row = fr.base + (long long)(fp.y0 + ly) * fr.W + fp.x0 + (l - ly * fp.fw);
      flush_add<true>(acc + row * C + c0 + 4 * q, tile4[l * kQuads + q]);
    }
    __syncthreads();  // before the next chunk zeroes the tile
  }
}


template <typename T>
int launch(const Args& a, const Plan& p, int groups, cudaStream_t s) {
  auto kernel = shared_scatter_kernel<T, 32>;
  const int smem = shared_smem_bytes(p.cap_rows, 32);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  kernel<<<dim3((unsigned)(a.R * p.tiles), (unsigned)groups), kThreads, smem, s>>>(
      static_cast<const T*>(a.grad_out), a.C, a.rois, a.level_meta, a.levels, a.grid, a.PH,
      a.PW, p, a.acc, a.stats);
  return (int)cudaGetLastError();
}

// The (roi, tile) records of the mark kernel, without its marks.
__global__ void info_kernel(const float* __restrict__ rois, const float* __restrict__ level_meta,
                            const int* __restrict__ levels, const int* __restrict__ grid, int PH,
                            int PW, Plan p, k1b::UnitInfo* __restrict__ info) {
  const Unit t = unit_of(blockIdx.x, p, PH, PW);
  RoiFrame fr;
  make_frame(fr, rois, level_meta, levels, grid, t.r, PH, PW);
  info[blockIdx.x] = k1b::UnitInfo{fr, tile_footprint(fr, t)};
}

}  // namespace k1b_shared

// K1b's three kernels (kShipped) or a K1bVariant, at the plan given: the
// arguments of glass_roi_align_rotated_backward, and `groups` blocks over a
// tile's 32-channel chunks for kSharedAtomics (whose shared tile holds
// cap_rows footprint rows).
extern "C" int study_k1b_variant(int variant, const void* grad_out, int dtype, int out_dtype,
                                 int C, const float* rois, const float* level_meta,
                                 const int* levels, const int* grid, int R, int PH, int PW,
                                 int tile_h, int tile_w, int cap_rows, int cap_slots, int groups,
                                 long long n_rows, float* acc, void* out, int* flags, int* stats,
                                 void* info, void* stream) {
  const k1b::Args a{grad_out, dtype, out_dtype, C, rois, level_meta, levels, grid, R, PH, PW,
                    n_rows, acc, out, flags, stats, static_cast<k1b::UnitInfo*>(info)};
  const k1b::Plan p = k1b::make_plan(a, tile_h, tile_w, cap_rows, cap_slots);
  const int smem = variant == kSharedAtomics ? k1b_shared::shared_smem_bytes(cap_rows, 32)
                                             : k1b::scatter_smem_bytes(cap_rows, cap_slots, 4);
  const int bad = k1b::check(a, p, smem);
  if (bad) return bad;
  const cudaStream_t s = (cudaStream_t)stream;
  auto shared = [&] {
    return a.dtype == kFloat32 ? k1b_shared::launch<float>(a, p, groups, s)
                               : k1b_shared::launch<__nv_bfloat16>(a, p, groups, s);
  };
  switch (variant) {
    case kShipped:
      return k1b::launch_backward(
          a, p, s, [&] { return k1b::launch_scatter_any<k1b::kScatterVec, true>(a, p, s); });
    case kScalarFlush:
      return k1b::launch_backward(
          a, p, s, [&] { return k1b::launch_scatter_any<k1b::kScatterVec, false>(a, p, s); });
    case kVec1:
      return k1b::launch_backward(a, p, s, [&] { return k1b::launch_scatter_any<1, true>(a, p, s); });
    case kVec4:
      return k1b::launch_backward(a, p, s, [&] { return k1b::launch_scatter_any<4, true>(a, p, s); });
    case kSharedAtomics:
      return k1b::launch_backward(a, p, s, shared);
    case kMemsetCast: {
      cudaMemsetAsync(acc, 0, (size_t)n_rows * C * sizeof(float), s);
      cudaMemsetAsync(stats, 0, 2 * sizeof(int), s);
      if (R > 0)
        k1b_shared::info_kernel<<<(unsigned)(R * p.tiles), 1, 0, s>>>(
            rois, level_meta, levels, grid, PH, PW, p, static_cast<k1b::UnitInfo*>(info));
      const int status = R > 0 ? k1b::launch_scatter_any<k1b::kScatterVec, true>(a, p, s) : 0;
      const int fin = k1b::launch_finish<false>(a, s);
      return status ? status : fin;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The shipped kernels with the scatter's phase trace into `trace`
// (R x tiles x kTraceStamps stamps).
extern "C" int study_k1b_trace(const void* grad_out, int dtype, int C, const float* rois,
                               const float* level_meta, const int* levels, const int* grid, int R,
                               int PH, int PW, int tile_h, int tile_w, int cap_rows, int cap_slots,
                               long long n_rows, float* acc, void* out, int* flags, int* stats,
                               void* info, unsigned long long* trace, void* stream) {
  const k1b::Args a{grad_out, dtype, dtype, C, rois, level_meta, levels, grid, R, PH, PW,
                    n_rows, acc, out, flags, stats, static_cast<k1b::UnitInfo*>(info)};
  k1b::Plan p = k1b::make_plan(a, tile_h, tile_w, cap_rows, cap_slots);
  p.trace = trace;
  const int bad = k1b::check(a, p, k1b::scatter_smem_bytes(cap_rows, cap_slots, 4));
  if (bad) return bad;
  const cudaStream_t s = (cudaStream_t)stream;
  return k1b::launch_backward(
      a, p, s, [&] { return k1b::launch_scatter_any<k1b::kScatterVec, true>(a, p, s); });
}

// Resident blocks an SM of the shipped scatter kernel (bf16 gradient) at
// the given plan, after the launch set its shared-memory attributes.
extern "C" int study_k1b_occupancy(int cap_rows, int cap_slots) {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k1b::scatter_kernel<__nv_bfloat16, k1b::kScatterVec, true>,
      k1b::kGroup / k1b::kScatterVec, k1b::scatter_smem_bytes(cap_rows, cap_slots, 2));
  return e == cudaSuccess ? blocks : -(int)e;
}

// K1b baseline: the per-tap kernel into a zeroed f32 grad_feat.
extern "C" int study_k1b_baseline(const void* grad_out, int dtype, int C, const float* rois,
                                  const float* level_meta, const int* levels, const int* grid,
                                  int R, int PH, int PW, float* grad_feat, void* stream) {
  if (R == 0) return 0;
  if (PH <= 0 || PW <= 0) return (int)cudaErrorInvalidValue;
  const int tile_h = min(PH, max(1, k1b_baseline::kTileBins / PW));
  const dim3 blocks((unsigned)(R * ((PH + tile_h - 1) / tile_h)));
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32 && C % 4 == 0) {
    k1b_baseline::roi_align_rotated_backward_kernel<float>
        <<<blocks, k1b_baseline::kWarps * 32, 0, s>>>((const float*)grad_out, C, rois, level_meta,
                                                     levels, grid, PH, PW, tile_h, grad_feat);
  } else if (dtype == kBFloat16 && C % 8 == 0) {
    k1b_baseline::roi_align_rotated_backward_kernel<__nv_bfloat16>
        <<<blocks, k1b_baseline::kWarps * 32, 0, s>>>((const __nv_bfloat16*)grad_out, C, rois,
                                                     level_meta, levels, grid, PH, PW, tile_h,
                                                     grad_feat);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
