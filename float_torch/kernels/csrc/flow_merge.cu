// K8: a decode level's flow merge, one pass over channels_last (NHWC)
// maps, bf16 or f32, computed in f32 and rounded once:
//
//   mask   = sigmoid(z)               z: channel 2 of ToFlow's raw output
//   feat   = warped * mask            the warped feature, ToRGB's input
//   merged = (feat + x * (1 - mask)) * scale
//
// warped (B, H, W, C) is the warp's output (K1 or K3), x (B, H, W, C) the
// level's map, z read through its strides (b, h, w), scale (B, C) the next
// level's up conv modulation in the map's dtype: merged is that conv's
// input, already modulated.  Without scale (the last level, where the
// merged map is dead) merged is not written and x is not read.
//
// Plain version: float_torch/ops/tails.py flow_merge_ref, the op sequence
// of float_tpu's _to_flow (sigmoid, two products, a difference and a sum)
// and the next conv's x * s.  The kernel replaces no TPU kernel: float_tpu
// leaves these ops to XLA, which fuses them.  On the card they were five
// of PyTorch's broadcast elementwise passes over the map (the mask's two
// products, the sum, the modulation), each reading and writing it whole.
//
// What bounds it on an H100: bytes.  It reads warped and x and writes two
// maps, four map accesses a level (two at the last: warped read, feat
// written): at 512^2 x 32, B = 24, bf16, 1.61 GB, 0.481 ms at 3.35 TB/s;
// under one f32 operation a byte.  So the design moves each byte once: a
// pixel's C channels go to G = C / N neighbouring threads, one 16-byte
// vector each (N = 8 bf16, 4 f32), where C % N == 0 and the maps are
// 16-byte aligned, else one channel a thread (Scalar); the G threads of a
// pixel read its one z value, served by L1; the scale vector is read from
// L2 (a (B, C) vector, under 25 KB).

#include "warp_common.cuh"

namespace {

using warp::kThreads;
using warp::Scalar;
using warp::Vec;
using warp::widen;

using bf16 = __nv_bfloat16;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// Thread t takes vector g = t % G of pixel p = t / G (pixels in (b, y, x)
// order), G = C / L::N.
template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
    flow_merge_kernel(const T* __restrict__ warped,
                      const T* __restrict__ z, long long zsb, long long zsh,
                      long long zsw, const T* __restrict__ x,
                      const T* __restrict__ scale, T* __restrict__ feat,
                      T* __restrict__ merged, int H, int W, int C,
                      long long n) {
  constexpr int V = L::N;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;
  const int G = C / V;
  const long long p = t / G;
  const long long off = p * C + (t - p * G) * V;
  const long long hw = static_cast<long long>(H) * W;
  const long long b = p / hw;
  const int yx = static_cast<int>(p - b * hw);
  const int y = yx / W;
  const float zv = widen(z[b * zsb + y * zsh + (yx - y * W) * zsw]);
  const float m = 1.0f / (1.0f + expf(-zv));

  float w[V];
  L::load(warped + off, w);
#pragma unroll
  for (int i = 0; i < V; ++i) w[i] *= m;
  L::store(feat + off, w);
  if (merged != nullptr) {
    float v[V];
    L::load(x + off, v);
    const T* s = scale + b * C + (off - p * C);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] = (w[i] + v[i] * (1.0f - m)) * widen(s[i]);
    }
    L::store(merged + off, v);
  }
}

template <typename T, typename L>
cudaError_t launch(const void* warped, const void* z, long long zsb,
                   long long zsh, long long zsw, const void* x,
                   const void* scale, void* feat, void* merged, int B, int H,
                   int W, int C, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * H * W * (C / L::N);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flow_merge_kernel<T, L><<<static_cast<unsigned int>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<const T*>(warped), static_cast<const T*>(z), zsb, zsh, zsw,
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(feat), static_cast<T*>(merged), H, W, C, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t merge(const void* warped, const void* z, long long zsb,
                  long long zsh, long long zsw, const void* x,
                  const void* scale, void* feat, void* merged, int B, int H,
                  int W, int C, cudaStream_t stream) {
  const bool vec = C % Vec<T>::N == 0 && aligned16(warped) &&
                   aligned16(feat) &&
                   (merged == nullptr || (aligned16(x) && aligned16(merged)));
  return vec ? launch<T, Vec<T>>(warped, z, zsb, zsh, zsw, x, scale, feat,
                                 merged, B, H, W, C, stream)
             : launch<T, Scalar<T>>(warped, z, zsb, zsh, zsw, x, scale, feat,
                                    merged, B, H, W, C, stream);
}

}  // namespace

// warped, x, feat, merged (B, H, W, C) contiguous; z's element (b, y, x)
// at b * zsb + y * zsh + x * zsw; x and scale (B, C) contiguous, or
// null with merged null (the last level); dtype 0 bf16, 1 f32 for every
// map and scale.  The caller checks shapes, dtypes, devices and
// contiguity.  Returns a cudaError_t: cudaErrorInvalidValue for a
// negative size, an unknown dtype or a merged map without x or scale,
// cudaErrorInvalidConfiguration for a grid too large.
extern "C" int flow_merge_launch(const void* warped, const void* z,
                                 long long zsb, long long zsh, long long zsw,
                                 const void* x, const void* scale, void* feat,
                                 void* merged, int B, int H, int W, int C,
                                 int dtype, int device, void* stream) {
  if (B < 0 || H < 0 || W < 0 || C < 0 || (dtype != 0 && dtype != 1) ||
      (merged != nullptr && (x == nullptr || scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? merge<bf16>(warped, z, zsb, zsh, zsw, x, scale, feat,
                                 merged, B, H, W, C, s)
                   : merge<float>(warped, z, zsb, zsh, zsw, x, scale, feat,
                                  merged, B, H, W, C, s);
  return static_cast<int>(err);
}

extern "C" const char* flow_merge_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
