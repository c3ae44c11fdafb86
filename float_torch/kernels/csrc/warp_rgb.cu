// Bilinear warp of ONE shared NHWC feature map by B per-frame grids, with
// the synthesis' last 1x1 ToRGB contracted on the f32 sums:
//
//   feat (1, H, W, C) bf16 or f32, grid (B, H, W, 2) f32, wk (3, C) f32
//   out[b, y, x, o] = round_to_T( sum_c wk[o, c] * warp_f32[b, y, x, c] )
//   warp_f32 = the four-tap f32 sum of warp_shared.cu (grid_sample,
//   bilinear, zeros padding, align_corners=False), before any rounding.
//
// Replaces the TPU kernel float_tpu/ops/pallas/shift_warp_v2.py::_kernel_rgb
// (launched by _packed_warp_v2_rgb): K1 with the ToRGB contraction in its
// epilogue, so the (B, H, W, C) warped map never reaches device memory.
// The TPU kernel contracts lane-packed frames against kron(I_groups, W);
// that packing exists for the TPU's 128-lane registers and is not carried
// over.
//
// What bounds it on an H100: at 512^2, C=32, B=24 in bf16 it reads the
// 50 MB grid and the 17 MB map (which then stays in the 50 MB L2) and
// writes 38 MB of RGB — 0.031 ms of HBM time — while its 14*C f32
// operations per pixel (4 taps x C multiply-adds, 3 x C for the
// contraction) take 0.042 ms at the 67 TFLOP/s f32 rate: the FMA pipes
// bound it, then the L2 bandwidth of the 4*C tap loads per pixel.
// Design: one thread per output pixel.  Its 4 tap offsets and weights are
// computed once; it then walks C in 16-byte vectors (8 bf16 or 4 f32
// channels), loads the 4 taps of each vector, sums them in f32 exactly as
// the plain version does (op by op, no FMA contraction), and folds the
// vector into its 3 running RGB sums.  wk (3 x C f32) sits in shared memory
// and every thread of a warp reads the same word at once (a broadcast).
// Stores: a thread's 3 outputs are 6 (bf16) or 12 (f32) bytes, so the
// block first writes its 3 x 256 outputs to shared memory, then copies them
// out as one contiguous run of the output, consecutive threads on
// consecutive elements: each warp store instruction writes 64 (bf16) or
// 128 (f32) contiguous bytes.

#include "warp_common.cuh"

namespace {

using warp::source_coord;
using warp::Vec;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    warp_rgb_kernel(const T* __restrict__ feat,
                    const float2* __restrict__ grid,
                    const float* __restrict__ wk, T* __restrict__ out, int H,
                    int W, int C, long long npix) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  float* w_s = smem;                                     // (3, C)
  T* tile = reinterpret_cast<T*>(smem + 3 * C);          // (kThreads, 3)
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) w_s[i] = wk[i];
  __syncthreads();

  const long long block0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long pix = block0 + threadIdx.x;  // (b * H + y) * W + x
  if (pix < npix) {
    const float2 g = __ldg(grid + pix);
    const float fx = source_coord(g.x, W);
    const float fy = source_coord(g.y, H);
    // floorf, not an int cast: negative coordinates must round down.
    // Validity is tested in float, so a far-off or NaN coordinate never
    // becomes an index.
    const float x0 = floorf(fx);
    const float y0 = floorf(fy);
    const float tx = __fsub_rn(fx, x0);
    const float ty = __fsub_rn(fy, y0);
    const float wx[2] = {__fsub_rn(1.0f, tx), tx};
    const float wy[2] = {__fsub_rn(1.0f, ty), ty};
    bool valid[4];
    float w[4];
    long long src[4];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yy = y0 + static_cast<float>(dy);
      const bool vy = yy >= 0.0f && yy < static_cast<float>(H);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float xx = x0 + static_cast<float>(dx);
        const int k = 2 * dy + dx;
        valid[k] = vy && xx >= 0.0f && xx < static_cast<float>(W);
        w[k] = __fmul_rn(wy[dy], wx[dx]);
        src[k] = valid[k] ? (static_cast<long long>(yy) * W +
                             static_cast<long long>(xx)) * C
                          : 0;
      }
    }

    float rgb[3] = {0.0f, 0.0f, 0.0f};
    for (int c0 = 0; c0 < C; c0 += V) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!valid[k]) continue;
        float v[V];
        Vec<T>::load(feat + src[k] + c0, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          acc[i] = __fadd_rn(acc[i], __fmul_rn(w[k], v[i]));
        }
      }
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const float* wo = w_s + o * C + c0;
#pragma unroll
        for (int i = 0; i < V; ++i) rgb[o] = fmaf(wo[i], acc[i], rgb[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      tile[3 * threadIdx.x + o] = Vec<T>::from_float(rgb[o]);
    }
  }
  __syncthreads();

  const long long left = npix - block0;
  const int n_out = 3 * static_cast<int>(left < blockDim.x ? left : blockDim.x);
  T* dst = out + 3 * block0;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) dst[i] = tile[i];
}

template <typename T>
cudaError_t launch(const void* feat, const void* grid, const void* wk,
                   void* out, int B, int H, int W, int C,
                   cudaStream_t stream) {
  const long long npix = static_cast<long long>(B) * H * W;
  if (npix == 0) return cudaSuccess;
  const long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = 3 * static_cast<size_t>(C) * sizeof(float) +
                      3 * static_cast<size_t>(kThreads) * sizeof(T);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  warp_rgb_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, smem,
                       stream>>>(
      static_cast<const T*>(feat), static_cast<const float2*>(grid),
      static_cast<const float*>(wk), static_cast<T*>(out), H, W, C, npix);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = f32.  The caller checks shapes, contiguity, 16-byte
// alignment of feat, C % (16 / sizeof(T)) == 0 and C <= 2048 (wk and the
// output tile in 48 KB of shared memory).  Returns a cudaError_t.
extern "C" int warp_rgb_launch(const void* feat, const void* grid,
                               const void* wk, void* out, int B, int H,
                               int W, int C, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<__nv_bfloat16>(feat, grid, wk, out, B, H, W, C, s);
  } else if (dtype == 1) {
    err = launch<float>(feat, grid, wk, out, B, H, W, C, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* warp_rgb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
