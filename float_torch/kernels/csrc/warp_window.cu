// K5: the windowed bilinear warp of the TPU's selection-matmul experiment,
// as a gather on the CUDA cores.
//
//   feat (B, H, W, C) bf16, grid (B, H, W, 2) f32 (x, y in [-1, 1]),
//   out (B, H, W, C) bf16; H % 8 == 0, W % 128 == 0, any C.
//   An output pixel (b, y, x) lies in tile (i, j) = (y / 8, x / 128), whose
//   window is rows [rs, rs + wr) x columns [cs, cs + wc):
//     wr = min(H, 8 + 2 my), rs = clip(8 i - my, 0, H - wr),
//     wc = min(W, 128 + 2 mx), cs = clip(128 j - mx, 0, W - wc).
//   A pixel none of whose in-image taps (on either axis) leaves the window
//   ("in window"):
//     out = bf16( (s00 f00 + s01 f01) + (s10 f10 + s11 f11) ), s = bf16(wy wx)
//   in f32, each product exact and each sum rounded to nearest.  Any other
//   pixel ("overflow"): the exact warp, the four taps' f32 products summed
//   in order.  Taps: grid_sample's bilinear taps, zeros padding,
//   align_corners=False, floor(f) an integer as float_tpu converts it (far
//   and infinite values saturate; a NaN coordinate makes the pixel NaN,
//   warp_common.cuh's nan_pixel).  So every element equals the plain
//   version (float_torch/experiments/warp_selection_matmul.py::
//   warp_bilinear_windowed_ref) bit for bit.
//
// Replaces the TPU kernel experiments/pallas_warp_selection_matmul.py:36
// _kernel (launched by _warp_pallas_nhwc, :105; wrapped by
// warp_bilinear_pallas, which fixes the overflow pixels with a second,
// exact warp under a lax.cond).  The TPU kernel copies each tile's window
// into VMEM and contracts it against one-hot selection matrices on the
// matrix unit, because Mosaic has no vector gather.
//
// What bounds it on an H100: bytes.  feat and grid are read once and out
// written once: at 512^2 x 32, B=16 that is 0.570 GB, 0.1703 ms at
// 3.35 TB/s.  The function does about two operations a byte, where the
// tensor cores need ~295 before they, and not the memory, set the pace.
//
// Why a gather and not selection products: the earlier version of this
// kernel (warp_window_mma.cu) issued bf16 mma.sync selection products,
// only those that could hold a nonzero weight (2-4 % of the dense count),
// with one accumulator per tap to stay exact.  On an NVIDIA H100 80GB
// HBM3 (700 W) it took 0.6145 ms at 512^2 x 32, B=16, 27.7 % of the bound,
// at 5.7 % of the tensor cores' peak: two blocks an SM (128 registers a
// thread, 105 KB of shared memory), a barrier between ring chunks and
// 4-byte stores; 1.0747 ms over the experiment's three levels, where
// F.grid_sample took 0.8292 ms and K3, the gather that computes the exact
// warp, 0.4028 ms (0.2314 ms, 73.6 % of the same bound, at 512^2).  So
// this kernel takes K3's structure (warp_shared.cu gather_kernel):
//   - a pixel's C / 8 16-byte vectors go to G = C / 16 neighbouring
//     threads, two vectors each (g and g + G), where C % 16 == 0, else one
//     each; one channel a thread where C % 8 != 0 (Scalar).  A warp's
//     loads of a tap and its stores then cover whole 32-byte sectors, and
//     a thread's tap and window arithmetic serves two vectors: with one
//     vector a thread that arithmetic, not the bytes, held a trial of
//     this kernel near 60 % of the bound;
//   - one 8-byte grid read per thread (a pixel's threads read the same
//     entry in one transaction); 16-byte ld.global.nc tap loads at 32-bit
//     offsets within the frame;
//   - the overflow test (integer arithmetic on the taps) before any load,
//     then each tap streamed into its sum: the in-window pixel's pairs or
//     the overflow pixel's running sum;
//   - 256-thread blocks, frames on the grid's y dimension, no shared
//     memory and no barrier.

#include "warp_common.cuh"

namespace {

using warp::kThreads;
using warp::nan_pixel;
using warp::nan_value;
using warp::Scalar;
using warp::source_coord;
using warp::Vec;

using bf16 = __nv_bfloat16;

constexpr int kTR = 8;     // the TPU tile: rows
constexpr int kTC = 128;   // and columns

// One axis of a pixel's taps, for a coordinate f that is not NaN: the
// first tap i0 = floor(f) as an integer (saturated at +-2^30, where every
// tap lies outside the image either way, as float_tpu's int32 saturates),
// whether taps i0 and i0 + 1 lie in [0, size), and their weights 1 - t
// and t, 0 for a tap outside.
struct Axis {
  int i0;
  bool v[2];
  float w[2];
};

__device__ __forceinline__ Axis axis_taps(float f, int size) {
  // floorf, not an int cast: negative coordinates must round down.
  const float f0 = floorf(f);
  const float t = __fsub_rn(f, f0);
  Axis a;
  a.i0 = static_cast<int>(fminf(fmaxf(f0, -1073741824.0f), 1073741824.0f));
  a.v[0] = static_cast<unsigned>(a.i0) < static_cast<unsigned>(size);
  a.v[1] = static_cast<unsigned>(a.i0 + 1) < static_cast<unsigned>(size);
  a.w[0] = a.v[0] ? __fsub_rn(1.0f, t) : 0.0f;
  a.w[1] = a.v[1] ? t : 0.0f;
  return a;
}

// An in-image tap of the axis leaves the window [lo, lo + n).
__device__ __forceinline__ bool leaves(const Axis& a, int lo, int n) {
  bool out = false;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    out |= a.v[d] &&
           static_cast<unsigned>(a.i0 + d - lo) >= static_cast<unsigned>(n);
  }
  return out;
}

// bf16(w) as the f32 it widens to.
__device__ __forceinline__ float round_bf16(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// Block (x, b): threads x * kThreads + threadIdx.x of frame b, G = C /
// (L::N VPT) a pixel, thread g of a pixel taking channel vectors g,
// g + G, ...; n = H * W * G.
template <typename L, int VPT>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const bf16* __restrict__ feat,
                  const float2* __restrict__ grid, bf16* __restrict__ out,
                  int H, int W, int C, int my, int mx, int n) {
  constexpr int V = L::N;
  const int t = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;
  const int G = C / (V * VPT);
  const int p = t / G;  // y * W + x
  const int g = t - p * G;
  const long long frame = static_cast<long long>(blockIdx.y) * H * W;
  const bf16* map = feat + frame * C;
  bf16* dst = out + (frame + p) * C + g * V;

  const float2 gg = __ldg(grid + frame + p);
  const float fx = source_coord(gg.x, W);
  const float fy = source_coord(gg.y, H);
  if (nan_pixel(fx, fy)) {
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = nan_value();
#pragma unroll
    for (int u = 0; u < VPT; ++u) L::store(dst + u * G * V, v);
    return;
  }
  const Axis ax = axis_taps(fx, W);
  const Axis ay = axis_taps(fy, H);
  const int y = p / W;
  const int x = p - y * W;
  const int wr = min(H, kTR + 2 * my);
  const int wc = min(W, kTC + 2 * mx);
  const int rs = min(max(y / kTR * kTR - my, 0), H - wr);
  const int cs = min(max(x / kTC * kTC - mx, 0), W - wc);
  const bool ovf = leaves(ay, rs, wr) || leaves(ax, cs, wc);

  // the taps' weights (bf16 selection weights in the window) and offsets
  // in the frame, modulo 2^32: a tap in the image is below H * W * C
  const unsigned row = static_cast<unsigned>(W) * C;
  const unsigned o00 = (static_cast<unsigned>(ay.i0) * W + ax.i0) * C + g * V;
  const unsigned off[4] = {o00, o00 + C, o00 + row, o00 + row + C};
  bool val[4];
  float s[4];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int k = 2 * dy + dx;
      const float w = __fmul_rn(ay.w[dy], ax.w[dx]);
      s[k] = ovf ? w : round_bf16(w);
      val[k] = ay.v[dy] && ax.v[dx];
    }
  }
#pragma unroll
  for (int u = 0; u < VPT; ++u) {
    float acc[V], part[V];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[V];
      if (val[k]) {
        L::load(map + off[k] + u * G * V, v);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = 0.0f;  // w * 0 adds +-0
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float term = __fmul_rn(s[k], v[i]);
        if (ovf) {
          // overflow: the exact warp, ((t00 + t01) + t10) + t11
          acc[i] = k == 0 ? term : __fadd_rn(acc[i], term);
        } else {
          // in window: (t00 + t01) + (t10 + t11)
          part[i] = k % 2 == 0 ? term : __fadd_rn(part[i], term);
          if (k == 1) acc[i] = part[i];
          if (k == 3) acc[i] = __fadd_rn(acc[i], part[i]);
        }
      }
    }
    L::store(dst + u * G * V, acc);
  }
}

template <typename L, int VPT>
cudaError_t launch(const void* feat, const void* grid, void* out, int B,
                   int H, int W, int C, int my, int mx, cudaStream_t stream) {
  const long long n = static_cast<long long>(H) * W * (C / (L::N * VPT));
  if (static_cast<long long>(H) * W * C > 0x7fffffffLL || B > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  const dim3 blocks(static_cast<unsigned int>((n + kThreads - 1) / kThreads),
                    B);
  window_kernel<L, VPT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const bf16*>(feat), static_cast<const float2*>(grid),
      static_cast<bf16*>(out), H, W, C, my, mx, static_cast<int>(n));
  return cudaGetLastError();
}

}  // namespace

// The caller checks dtypes, shapes, contiguity, grid 8-byte alignment and,
// where C % 8 == 0, feat 16-byte alignment.  Returns a cudaError_t:
// cudaErrorInvalidValue for H % 8, W % 128 or a margin below 0,
// cudaErrorInvalidConfiguration for H * W * C >= 2^31 or B > 65535.
extern "C" int warp_window_launch(const void* feat, const void* grid,
                                  void* out, int B, int H, int W, int C,
                                  int my, int mx, int device, void* stream) {
  if (B < 0 || H < 0 || W < 0 || C < 0 || H % kTR || W % kTC || my < 0 ||
      mx < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = Vec<bf16>::N;
  if (C % (2 * V) == 0) {
    err = launch<Vec<bf16>, 2>(feat, grid, out, B, H, W, C, my, mx, s);
  } else if (C % V == 0) {
    err = launch<Vec<bf16>, 1>(feat, grid, out, B, H, W, C, my, mx, s);
  } else {
    err = launch<Scalar<bf16>, 1>(feat, grid, out, B, H, W, C, my, mx, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* warp_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
