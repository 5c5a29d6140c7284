// K3: every word's 28x28 mask pasted through its rotated box into the word's
// window of the image and binarized, for all of an image's words in one
// launch.  Hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: glass_tpu (and the port before K3) pastes on the
// host, one cv2.warpAffine (INTER_LINEAR, float32, BORDER_CONSTANT 0) and
// one threshold a word (postprocess/paste.py::rotated_masks_to_polygons),
// then follows the largest contour with cv2.findContours.  The contours
// stay on the host; this kernel does the dense part, and writes the binary
// windows straight into pinned host memory that the host's contour pass
// reads in place.
//
// The windows must equal the host's bit for bit (the polygons are compared
// exactly), so the kernel repeats OpenCV's own arithmetic, in one of the two
// forms that OpenCV builds use for a float32 INTER_LINEAR warp (the host
// picks the form that its cv2 reproduces, postprocess/paste.py):
//   form 0, float (OpenCV 5's vectorised warp): the inverse map rounded to
//     float; the sample coordinate of column x, row y is
//     fma(m0, x, y*m1 + m2) in the columns of OpenCV's 16-lane vector loop
//     (the first (w / 16) * 16 of a row) and fma(x, m0, y*m1) + m2 in the
//     scalar tail after it; the fraction is the coordinate less its floor;
//     the taps are lerped as fma(a, p01 - p00, p00), then the two rows as
//     fma(b, v1 - v0, v0);
//   form 1, fixed (OpenCV 4's remap tables): the inverse map in double;
//     X = cvRound((m1*y + m2) * 1024) + 16 + cvRound(m0*x*1024), shifted
//     right 5 bits: the tap is X >> 5, the 1/32-pixel fraction X & 31 picks
//     the weights (1 - fy)(1 - fx), (1 - fy)fx, fy(1 - fx), fy*fx, and the
//     value is ((p00*w0 + p01*w1) + p10*w2) + p11*w3, each step rounded.
// Taps outside the mask read 0.  Every operation is an explicit
// round-to-nearest intrinsic, and the build keeps -fmad=false.
//
// Inputs (device memory unless said):
//   masks  (N, M, M) f32, M <= 64: the words' mask probabilities
//   maps   (N, 6) f64: each word's inverse affine map (window pixel to mask
//          coordinate), as cv2.warpAffine inverts the word's forward map
//   geo    (N, 3) int64: the window's byte offset in `out` (a multiple of
//          16), its width and its height
//   tiles  (T, 2) int32: block t pastes pixels [tiles[t][1], + 4096) of
//          word tiles[t][0]'s window (row-major flat index)
//   out    pinned, mapped host memory: each window's binary bytes
//          (v >= thr), row-major at its offset, zero-padded to 16 bytes
//   flags  pinned, mapped host memory, (N,) int32, zero on entry: set to 1
//          for a word with a pixel |v - thr| <= eps (the host re-warps
//          such a word with cv2), in the fixed form only where that
//          pixel's value carries a rounding error: the fixed form's
//          products and sums are exact for most ties (fp16 probabilities
//          times weights on a 1/1024 grid), and an exact value is the same
//          in any implementation of the form
//   fg     (N, 4) int32, (INT_MAX, INT_MAX, -1, -1) on entry: the window's
//          foreground bounding box (x0, y0, x1, y1), inclusive, so that the
//          host follows contours over the box alone
//
// What bounds it on the H100: each pixel is ~30 flops of independent work
// (~60 with the fixed form's doubles) and one byte written, over PCIe, to
// host memory; a serving image's windows are 5-14 M pixels, so the writes
// set the time: 11.1 M pixels took 0.24-0.25 ms (chip_smoke.py phase 16),
// ~45 GB/s, against 0.0034 ms for its bytes at HBM's 3.35 TB/s, a path
// the windows do not take.  Design: one block of 256 threads a 4096-pixel
// tile of one word's window, the word's mask staged once in shared memory;
// a thread computes 16 consecutive pixels of the flat window and writes
// them with one 16-byte store, so a warp writes 512 contiguous bytes.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 16;                // pixels a thread: one 16-byte store
constexpr int kTile = kThreads * kPixels;  // pixels a block
constexpr int kSimdCols = 16;              // form 0: columns of OpenCV's vector loop
constexpr int kMaxMask = 64;
static_assert(kTile == 4096, "ops/paste_masks_rotated.py::TILE is the pixels a block");

__device__ __forceinline__ float tap(const float* s, int m, int y, int x) {
  return ((unsigned)y < (unsigned)m && (unsigned)x < (unsigned)m) ? s[y * m + x] : 0.f;
}

template <int kForm>
__global__ void __launch_bounds__(kThreads)
    paste_kernel(const float* __restrict__ masks, int m, const double* __restrict__ maps,
                 const long long* __restrict__ geo, const int2* __restrict__ tiles, float thr,
                 float eps, unsigned char* __restrict__ out, int* __restrict__ flags,
                 int* __restrict__ fg) {
  extern __shared__ float s[];
  __shared__ int box[4];
  if (threadIdx.x < 4) box[threadIdx.x] = threadIdx.x < 2 ? INT_MAX : -1;
  const int2 t = tiles[blockIdx.x];
  const int word = t.x;
  const long long off = geo[3 * word];
  const int w = (int)geo[3 * word + 1], h = (int)geo[3 * word + 2];
  const float* src = masks + (size_t)word * m * m;
  for (int i = threadIdx.x; i < m * m; i += kThreads) s[i] = src[i];
  const double* d = maps + 6 * word;
  const double d0 = d[0], d1 = d[1], d2 = d[2], d3 = d[3], d4 = d[4], d5 = d[5];
  __syncthreads();

  const int area = w * h;
  const int f0 = t.y + threadIdx.x * kPixels;
  int y = f0 / w, x = f0 - y * w;
  int bx0 = INT_MAX, by0 = INT_MAX, bx1 = -1, by1 = -1;
  const int simd_end = (w / kSimdCols) * kSimdCols;
  const float m0 = __double2float_rn(d0), m1 = __double2float_rn(d1), m2 = __double2float_rn(d2);
  const float m3 = __double2float_rn(d3), m4 = __double2float_rn(d4), m5 = __double2float_rn(d5);
  uint32_t packed[4] = {0u, 0u, 0u, 0u};
  bool edge = false;
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    if (f0 + k < area) {
      float v;
      bool exact = false;
      if (kForm == 0) {
        const float fx = (float)x, fy = (float)y;
        float sx, sy;
        if (x < simd_end) {
          sx = __fmaf_rn(m0, fx, __fadd_rn(__fmul_rn(fy, m1), m2));
          sy = __fmaf_rn(m3, fx, __fadd_rn(__fmul_rn(fy, m4), m5));
        } else {
          sx = __fadd_rn(__fmaf_rn(fx, m0, __fmul_rn(fy, m1)), m2);
          sy = __fadd_rn(__fmaf_rn(fx, m3, __fmul_rn(fy, m4)), m5);
        }
        const float flx = floorf(sx), fly = floorf(sy);
        const int ix = (int)flx, iy = (int)fly;
        const float a = __fsub_rn(sx, flx), b = __fsub_rn(sy, fly);
        const float p00 = tap(s, m, iy, ix), p01 = tap(s, m, iy, ix + 1);
        const float p10 = tap(s, m, iy + 1, ix), p11 = tap(s, m, iy + 1, ix + 1);
        const float v0 = __fmaf_rn(a, __fsub_rn(p01, p00), p00);
        const float v1 = __fmaf_rn(a, __fsub_rn(p11, p10), p10);
        v = __fmaf_rn(b, __fsub_rn(v1, v0), v0);
      } else {
        const double dx = (double)x, dy = (double)y;
        const int x0 = __double2int_rn(__dmul_rn(__dadd_rn(__dmul_rn(d1, dy), d2), 1024.0)) + 16;
        const int y0 = __double2int_rn(__dmul_rn(__dadd_rn(__dmul_rn(d4, dy), d5), 1024.0)) + 16;
        const int X = (x0 + __double2int_rn(__dmul_rn(__dmul_rn(d0, dx), 1024.0))) >> 5;
        const int Y = (y0 + __double2int_rn(__dmul_rn(__dmul_rn(d3, dx), 1024.0))) >> 5;
        const int ix = X >> 5, iy = Y >> 5;
        const float fx = __fmul_rn((float)(X & 31), 1.f / 32), fy = __fmul_rn((float)(Y & 31), 1.f / 32);
        const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
        const float w0 = __fmul_rn(gy, gx), w1 = __fmul_rn(gy, fx);
        const float w2 = __fmul_rn(fy, gx), w3 = __fmul_rn(fy, fx);
        const float p00 = tap(s, m, iy, ix), p01 = tap(s, m, iy, ix + 1);
        const float p10 = tap(s, m, iy + 1, ix), p11 = tap(s, m, iy + 1, ix + 1);
        const float q0 = __fmul_rn(p00, w0), q1 = __fmul_rn(p01, w1);
        const float q2 = __fmul_rn(p10, w2), q3 = __fmul_rn(p11, w3);
        const float s1 = __fadd_rn(q0, q1), s2 = __fadd_rn(s1, q2);
        v = __fadd_rn(s2, q3);
        // each float step against the same step in double, where the
        // products of two floats and these sums are exact
        exact = (double)q0 == __dmul_rn(p00, w0) && (double)q1 == __dmul_rn(p01, w1) &&
                (double)q2 == __dmul_rn(p10, w2) && (double)q3 == __dmul_rn(p11, w3) &&
                (double)s1 == __dadd_rn(q0, q1) && (double)s2 == __dadd_rn(s1, q2) &&
                (double)v == __dadd_rn(s2, q3);
      }
      const bool on = v >= thr;
      packed[k >> 2] |= (uint32_t)on << (8 * (k & 3));
      edge |= fabsf(__fsub_rn(v, thr)) <= eps && !exact;
      if (on) {
        bx0 = min(bx0, x);
        bx1 = max(bx1, x);
        by0 = min(by0, y);
        by1 = max(by1, y);
      }
      if (++x == w) {
        x = 0;
        ++y;
      }
    }
  }
  if (f0 < area) {
    *reinterpret_cast<uint4*>(out + off + f0) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    if (edge) flags[word] = 1;
  }
  // the tile's foreground box: warps, then the block, then one set of
  // atomics a block with foreground
  bx0 = __reduce_min_sync(0xffffffffu, bx0);
  by0 = __reduce_min_sync(0xffffffffu, by0);
  bx1 = __reduce_max_sync(0xffffffffu, bx1);
  by1 = __reduce_max_sync(0xffffffffu, by1);
  if ((threadIdx.x & 31) == 0 && bx1 >= 0) {
    atomicMin(&box[0], bx0);
    atomicMin(&box[1], by0);
    atomicMax(&box[2], bx1);
    atomicMax(&box[3], by1);
  }
  __syncthreads();
  if (threadIdx.x == 0 && box[2] >= 0) {
    atomicMin(&fg[4 * word], box[0]);
    atomicMin(&fg[4 * word + 1], box[1]);
    atomicMax(&fg[4 * word + 2], box[2]);
    atomicMax(&fg[4 * word + 3], box[3]);
  }
}

}  // namespace

// One launch over the tile table; `out` and `flags` are pinned host buffers
// (the start of their allocations), mapped into the device's address space.
extern "C" int glass_paste_masks_rotated(const float* masks, int m, const double* maps,
                                         const long long* geo, const int* tiles, int n_tiles,
                                         int form, float thr, float eps, void* out_host,
                                         void* flags_host, int* fg, void* stream) {
  if (n_tiles == 0) return 0;
  if (m <= 0 || m > kMaxMask || n_tiles < 0 || (form != 0 && form != 1))
    return (int)cudaErrorInvalidValue;
  void* out = nullptr;
  void* flags = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&out, out_host, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaHostGetDevicePointer(&flags, flags_host, 0);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)m * m * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  const int2* t = reinterpret_cast<const int2*>(tiles);
  if (form == 0) {
    paste_kernel<0><<<n_tiles, kThreads, smem, s>>>(masks, m, maps, geo, t, thr, eps,
                                                     (unsigned char*)out, (int*)flags, fg);
  } else {
    paste_kernel<1><<<n_tiles, kThreads, smem, s>>>(masks, m, maps, geo, t, thr, eps,
                                                     (unsigned char*)out, (int*)flags, fg);
  }
  return (int)cudaGetLastError();
}
