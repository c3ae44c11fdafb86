// Bilinear warp of NHWC feature maps by B per-frame sampling grids:
// grid_sample with bilinear taps, zeros padding, align_corners=False.
//
//   feat (1 or B, H, W, C) bf16 or f32, grid (B, H, W, 2) f32 (x, y in
//   [-1, 1]); out[b, y, x, :] = sum over the 4 taps of w * map_b[ty, tx, :]
//   fx = ((gx + 1) * W - 1) / 2, likewise fy; taps outside the image add 0.
//   map_b is feat[0] for every frame (warp_shared_launch) or feat[b]
//   (warp_per_frame_launch).
//
// Replaces the TPU kernels
//   float_tpu/ops/pallas/shift_warp_v2.py::_kernel (K1, the shared map,
//     launched by _packed_warp_v2),
//   float_tpu/ops/pallas/shift_warp_packed.py::_kernel (K4, the same
//     function for C <= 32 with 4 frames packed into the TPU's 128 lanes),
//   float_tpu/ops/pallas/shift_warp_kernel.py::_kernel (K3, per-frame maps,
//     launched by _shift_warp_nhwc).
// Those kernels read a static window of +-D shifted copies of the map,
// because the TPU's vector unit has no gather; this one gathers its 4 taps
// directly, so it is exact for any displacement and needs none of the TPU's
// overflow flags, fixups or lane packing.
//
// What bounds it on an H100: writing the B*H*W*C outputs (at 512^2, C=32,
// B=24 in bf16 that is ~400 MB per call, against 3.35 TB/s of HBM).  A
// shared map is at most 16 MiB (512^2 x 32 bf16) and stays in the 50 MB L2,
// so the 4 tap reads per output are L2 hits; a per-frame map is read about
// once from HBM.  At B=1 (one-frame decode chunks) a call moves 8.5 MB at
// 128^2 and 36 MB at 512^2: its bound is below the launch latency.
// Design: one thread per (pixel, 16-byte channel vector) — 8 bf16 or 4 f32
// channels — so each tap and each store is one 16-byte access, and
// neighbouring threads take neighbouring channels of a pixel.  Sums are in
// f32 and are rounded op by op (no FMA contraction), in the plain PyTorch
// version's order, so the two agree bit for bit up to the final rounding to
// the feature dtype.

#include "warp_common.cuh"

namespace {

using warp::source_coord;
using warp::Vec;

// kPerFrame: frame b reads map b (feature batch stride H*W*C); otherwise
// every frame reads map 0 (stride 0).
template <typename T, bool kPerFrame>
__global__ void __launch_bounds__(256)
    warp_kernel(const T* __restrict__ feat, const float2* __restrict__ grid,
                T* __restrict__ out, int H, int W, int C, long long total) {
  constexpr int V = Vec<T>::N;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int cvec = C / V;
  const long long pix = t / cvec;  // (b * H + y) * W + x
  const int c0 = static_cast<int>(t - pix * cvec) * V;
  const T* map = feat;
  if (kPerFrame) {
    const long long hw = static_cast<long long>(H) * W;
    map += (pix / hw) * hw * C;
  }

  const float2 g = __ldg(grid + pix);
  const float fx = source_coord(g.x, W);
  const float fy = source_coord(g.y, H);
  // floorf, not an int cast: negative coordinates must round down.
  // Tap validity is tested in float, so a far-off or NaN coordinate
  // never becomes an index.
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float tx = __fsub_rn(fx, x0);
  const float ty = __fsub_rn(fy, y0);
  const float wx[2] = {__fsub_rn(1.0f, tx), tx};
  const float wy[2] = {__fsub_rn(1.0f, ty), ty};

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const float yy = y0 + static_cast<float>(dy);
    if (!(yy >= 0.0f && yy < static_cast<float>(H))) continue;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float xx = x0 + static_cast<float>(dx);
      if (!(xx >= 0.0f && xx < static_cast<float>(W))) continue;
      const float w = __fmul_rn(wy[dy], wx[dx]);
      const long long src =
          (static_cast<long long>(yy) * W + static_cast<long long>(xx)) * C +
          c0;
      float v[V];
      Vec<T>::load(map + src, v);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, v[i]));
    }
  }
  Vec<T>::store(out + pix * C + c0, acc);
}

template <typename T, bool kPerFrame>
cudaError_t launch(const void* feat, const void* grid, void* out, int B,
                   int H, int W, int C, cudaStream_t stream) {
  const long long total =
      static_cast<long long>(B) * H * W * (C / Vec<T>::N);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  warp_kernel<T, kPerFrame><<<static_cast<unsigned int>(blocks), threads, 0,
                              stream>>>(
      static_cast<const T*>(feat), static_cast<const float2*>(grid),
      static_cast<T*>(out), H, W, C, total);
  return cudaGetLastError();
}

template <bool kPerFrame>
int dispatch(const void* feat, const void* grid, void* out, int B, int H,
             int W, int C, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<__nv_bfloat16, kPerFrame>(feat, grid, out, B, H, W, C, s);
  } else if (dtype == 1) {
    err = launch<float, kPerFrame>(feat, grid, out, B, H, W, C, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = bf16, 1 = f32.  The caller checks shapes, contiguity, 16-byte
// alignment and C % (16 / sizeof(T)) == 0.  Each returns a cudaError_t.
// feat (1, H, W, C): one map shared by the B frames.
extern "C" int warp_shared_launch(const void* feat, const void* grid,
                                  void* out, int B, int H, int W, int C,
                                  int dtype, int device, void* stream) {
  return dispatch<false>(feat, grid, out, B, H, W, C, dtype, device, stream);
}

// feat (B, H, W, C): frame b's own map.
extern "C" int warp_per_frame_launch(const void* feat, const void* grid,
                                     void* out, int B, int H, int W, int C,
                                     int dtype, int device, void* stream) {
  return dispatch<true>(feat, grid, out, B, H, W, C, dtype, device, stream);
}

extern "C" const char* warp_shared_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
