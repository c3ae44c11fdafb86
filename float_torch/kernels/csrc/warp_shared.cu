// Bilinear warp of ONE shared NHWC feature map by B per-frame sampling
// grids: grid_sample with bilinear taps, zeros padding, align_corners=False.
//
//   feat (1, H, W, C) bf16 or f32, grid (B, H, W, 2) f32 (x, y in [-1, 1])
//   out[b, y, x, :] = sum over the 4 taps of w * feat[0, ty, tx, :]
//   fx = ((gx + 1) * W - 1) / 2, likewise fy; taps outside the image add 0.
//
// Replaces the TPU kernel float_tpu/ops/pallas/shift_warp_v2.py::_kernel
// (launched by _packed_warp_v2).  That kernel reads a static window of
// +-D shifted copies of the map, because the TPU's vector unit has no
// gather; this one gathers its 4 taps directly, so it is exact for any
// displacement and needs none of the TPU's overflow flags or fixups.
//
// What bounds it on an H100: writing the B*H*W*C outputs (at 512^2, C=32,
// B=24 in bf16 that is ~400 MB per call, against 3.35 TB/s of HBM).  The
// shared map is at most 16 MiB (512^2 x 32 bf16) and stays in the 50 MB L2,
// so the 4 tap reads per output are L2 hits.  Design: one thread per
// (pixel, 16-byte channel vector) — 8 bf16 or 4 f32 channels — so each
// tap and each store is one 16-byte access, and neighbouring threads take
// neighbouring channels of a pixel.  Sums are in f32 and are rounded op by
// op (no FMA contraction), in the plain PyTorch version's order, so the
// two agree bit for bit up to the final rounding to the feature dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// ((g + 1) * size - 1) * 0.5, rounded op by op like the plain version.
__device__ __forceinline__ float source_coord(float g, int size) {
  return __fmul_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), static_cast<float>(size)), 1.0f),
      0.5f);
}

template <typename T>
__global__ void __launch_bounds__(256)
    warp_shared_kernel(const T* __restrict__ feat,
                       const float2* __restrict__ grid, T* __restrict__ out,
                       int H, int W, int C, long long total) {
  constexpr int V = Vec<T>::N;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int cvec = C / V;
  const long long pix = t / cvec;  // (b * H + y) * W + x
  const int c0 = static_cast<int>(t - pix * cvec) * V;

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
      Vec<T>::load(feat + src, v);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, v[i]));
    }
  }
  Vec<T>::store(out + pix * C + c0, acc);
}

template <typename T>
cudaError_t launch(const void* feat, const void* grid, void* out, int B,
                   int H, int W, int C, cudaStream_t stream) {
  const long long total =
      static_cast<long long>(B) * H * W * (C / Vec<T>::N);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  warp_shared_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0,
                          stream>>>(
      static_cast<const T*>(feat), static_cast<const float2*>(grid),
      static_cast<T*>(out), H, W, C, total);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = f32.  The caller checks shapes, contiguity, 16-byte
// alignment and C % (16 / sizeof(T)) == 0.  Returns a cudaError_t.
extern "C" int warp_shared_launch(const void* feat, const void* grid,
                                  void* out, int B, int H, int W, int C,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<__nv_bfloat16>(feat, grid, out, B, H, W, C, s);
  } else if (dtype == 1) {
    err = launch<float>(feat, grid, out, B, H, W, C, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* warp_shared_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
