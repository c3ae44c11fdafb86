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
// because the TPU's vector unit has no gather, and flag the taps beyond D
// for a fixup re-decode.  These kernels gather their 4 taps directly, so
// they are exact for any displacement and need no flags or fixups.
//
// K1, the shared map (staged_kernel).  What bounds it on an H100: writing
// the B*H*W*C outputs (at 512^2, C=32, B=24 in bf16 ~400 MB per call,
// against 3.35 TB/s of HBM).  The first version (gather_kernel) gathers
// the 4 taps of every output from the L2-resident map, 4x the output's
// bytes through L2, and ran at ~45 % of that bound.  The TPU kernel's own
// idea replaces the gathers: a block owns one output tile (tile_h x tile_w
// pixels x cslice channels x a group of frames), copies its frames' grid
// entries for the tile into shared memory, reduces their tap rows and
// columns (the footprint), copies that window of the map (at most the
// tile + halo px each side + 1) into shared memory once, and every frame
// gathers its taps from there.  A tap outside the window reads device
// memory, so the kernel stays exact for any flow.  Every global load is
// an asynchronous bulk copy, so no thread waits on device memory inside
// the frame loop.  The plan (tile, slice, frames, halo, vectors per
// thread) is chosen per shape in float_torch/kernels/warp_plan.py; below
// ~16 MB of output the direct plan (the first version) wins, because a
// staged block's three copy-and-barrier steps do not pay for themselves.
// cp.async, not TMA: the window's size follows the data (the footprint
// union, cut to the cap), which a tensor map's fixed box cannot express
// without copying the whole cap, and the copies are a few instructions
// per thread per tile against tens of output vectors.
// Taps: a pixel's vectors go to G neighbouring threads (two in the
// plans), so each warp store writes whole 32-byte sectors; window loads
// are one ld.shared.v4 each (a plain 16-byte dereference was split into
// four 32-bit loads, which conflict across the warp), and the window's
// swizzle (warp_common.cuh) keeps a quarter-warp on 8 bank groups.
//
// K3, per-frame maps (gather_kernel<T, true>), keeps the first version:
// at B=1 a window has no frames to share.  Like the TPU kernel it takes
// any C: where C is not a whole number of 16-byte vectors (an RGB image),
// each thread gathers one channel (Scalar) instead of one vector.
//
// Both round every sum op by op (no FMA contraction) in the plain PyTorch
// version's order, so they agree with it bit for bit up to the final
// rounding to the feature dtype.

#include "warp_common.cuh"

namespace {

using warp::kSmemLimit;
using warp::kThreads;
using warp::pixel_taps;
using warp::source_coord;
using warp::Taps;
using warp::Tile;
using warp::Vec;
using warp::Window;
using warp::block_tile;
using warp::grid_bytes;
using warp::stage_grid;
using warp::stage_window;
using warp::Swizzle;
using warp::window_bytes;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One channel per load and store: Vec's interface for a C that is not a
// whole number of 16-byte vectors.
template <typename T>
struct Scalar {
  static constexpr int N = 1;
  __device__ __forceinline__ static void load(const T* p, float* v) {
    v[0] = widen(p[0]);
  }
  __device__ __forceinline__ static void store(T* p, const float* v) {
    p[0] = Vec<T>::from_float(v[0]);
  }
};

// The first version: one thread per (pixel, L::N channels: a 16-byte
// vector, or one channel for Scalar), the 4 taps gathered from device
// memory.  kPerFrame (K3): frame b reads map b (feature batch stride
// H*W*C); otherwise (K1's direct plan) every frame reads map 0.
template <typename T, bool kPerFrame, typename L>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const T* __restrict__ feat, const float2* __restrict__ grid,
                  T* __restrict__ out, int H, int W, int C, long long total) {
  constexpr int V = L::N;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int cvec = C / V;
  const long long pix = t / cvec;  // (b * H + y) * W + x
  const int c0 = static_cast<int>(t - pix * cvec) * V;
  const long long hw = static_cast<long long>(H) * W;
  const T* map = kPerFrame ? feat + (pix / hw) * hw * C : feat;

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
      L::load(map + src, v);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, v[i]));
    }
  }
  L::store(out + pix * C + c0, acc);
}

// K1: one map shared by the B frames, staged per tile (see the top).
// A pixel's nv vectors go to G = nv / VPT neighbouring threads, thread g
// taking vectors g, g + G, ...: each store instruction of a warp then
// writes whole 32-byte sectors (all 512 bytes contiguous when G covers
// 64 bytes or more).
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
    staged_kernel(const T* __restrict__ feat, const float2* __restrict__ grid,
                  T* __restrict__ out, int B, int H, int W, int C, int tile_h,
                  int tile_w, int cslice, int frames, int halo) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  float2* s_grid = reinterpret_cast<float2*>(
      smem_raw +
      window_bytes(tile_h, tile_w, halo, H, W, cslice, sizeof(T)));
  const int G = cslice / (V * VPT);  // threads per pixel
  const Tile t = block_tile(B, H, W, tile_h, tile_w, frames);
  const int c0 = static_cast<int>(blockIdx.y) * cslice;
  const Window box = stage_grid(grid, s_grid, t, H, W, tile_h, tile_w, halo,
                                Swizzle(cslice / V, G));
  stage_window(feat, win, box, W, C, c0, cslice);

  const int npx = t.h * t.w;
  const long long hw = static_cast<long long>(H) * W;
  for (int i = threadIdx.x; i < npx * G; i += kThreads) {
    const int p = i / G;
    const int g = i - p * G;
    const int py = p / t.w;
    const long long pix0 =
        static_cast<long long>(t.y0 + py) * W + t.x0 + (p - py * t.w);
    for (int f = 0; f < t.nf; ++f) {
      const long long pix = (t.b0 + f) * hw + pix0;
      const Taps tp = pixel_taps(s_grid[f * npx + p], H, W);
      float acc[VPT][V];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!tp.valid[k]) {
          if (k == 0) {
#pragma unroll
            for (int u = 0; u < VPT; ++u) {
#pragma unroll
              for (int j = 0; j < V; ++j) acc[u][j] = 0.0f;
            }
          }
          continue;
        }
        float x[VPT][V];
        const int q = box.offset(tp.iy[k], tp.ix[k]);
        if (q >= 0) {
          const T* px = win + static_cast<long long>(q) * cslice;
#pragma unroll
          for (int u = 0; u < VPT; ++u) {
            Vec<T>::load_shared(px + box.sw.slot(q, g + u * G) * V, x[u]);
          }
        } else {
          const T* px = feat +
                        (static_cast<long long>(tp.iy[k]) * W + tp.ix[k]) * C +
                        c0 + g * V;
#pragma unroll
          for (int u = 0; u < VPT; ++u) Vec<T>::load(px + u * G * V, x[u]);
        }
        // the plain version's order: t00 + t01 + t10 + t11, each product
        // and sum rounded (an invalid tap adds +-0, which changes nothing)
#pragma unroll
        for (int u = 0; u < VPT; ++u) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float term = __fmul_rn(tp.w[k], x[u][j]);
            acc[u][j] = k == 0 ? term : __fadd_rn(acc[u][j], term);
          }
        }
      }
      T* dst = out + pix * C + c0 + g * V;
#pragma unroll
      for (int u = 0; u < VPT; ++u) Vec<T>::store(dst + u * G * V, acc[u]);
    }
  }
}

template <typename T, bool kPerFrame, typename L>
cudaError_t launch_gather_as(const void* feat, const void* grid, void* out,
                             int B, int H, int W, int C,
                             cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * H * W * (C / L::N);
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gather_kernel<T, kPerFrame, L><<<static_cast<unsigned int>(blocks),
                                   kThreads, 0, stream>>>(
      static_cast<const T*>(feat), static_cast<const float2*>(grid),
      static_cast<T*>(out), H, W, C, total);
  return cudaGetLastError();
}

// 16-byte vectors where C fills them; otherwise one channel per thread,
// which only the per-frame entry (K3) takes.
template <typename T, bool kPerFrame>
cudaError_t launch_gather(const void* feat, const void* grid, void* out,
                          int B, int H, int W, int C, cudaStream_t stream) {
  if (C % Vec<T>::N == 0) {
    return launch_gather_as<T, kPerFrame, Vec<T>>(feat, grid, out, B, H, W,
                                                  C, stream);
  }
  if constexpr (kPerFrame) {
    return launch_gather_as<T, true, Scalar<T>>(feat, grid, out, B, H, W, C,
                                                stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T, int VPT>
cudaError_t launch_staged_vpt(const dim3& blocks, size_t smem,
                              cudaStream_t stream, const void* feat,
                              const void* grid, void* out, int B, int H,
                              int W, int C, int tile_h, int tile_w,
                              int cslice, int frames, int halo) {
  cudaError_t err = warp::allow_smem<staged_kernel<T, VPT>>();
  if (err != cudaSuccess) return err;
  staged_kernel<T, VPT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const float2*>(grid),
      static_cast<T*>(out), B, H, W, C, tile_h, tile_w, cslice, frames, halo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_staged(const void* feat, const void* grid, void* out,
                          int B, int H, int W, int C, int tile_h, int tile_w,
                          int cslice, int frames, int halo, int vpt,
                          cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  if (tile_h == 0) {  // the direct plan
    return launch_gather<T, false>(feat, grid, out, B, H, W, C, stream);
  }
  if (tile_h < 1 || tile_w < 1 || frames < 1 || halo < 0 || cslice < V ||
      cslice % V || C % cslice || (vpt != 1 && vpt != 2 && vpt != 4) ||
      (cslice / V) % vpt) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = static_cast<long long>((H + tile_h - 1) / tile_h) *
                          ((W + tile_w - 1) / tile_w);
  const int slices = C / cslice;
  const int groups = (B + frames - 1) / frames;
  if (tiles > 0x7fffffffLL || slices > 65535 || groups > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  const size_t smem =
      window_bytes(tile_h, tile_w, halo, H, W, cslice, sizeof(T)) +
      grid_bytes(tile_h, tile_w, frames);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  const dim3 blocks(static_cast<unsigned int>(tiles), slices, groups);
  auto launch = vpt == 4   ? launch_staged_vpt<T, 4>
                : vpt == 2 ? launch_staged_vpt<T, 2>
                           : launch_staged_vpt<T, 1>;
  return launch(blocks, smem, stream, feat, grid, out, B, H, W, C, tile_h,
                tile_w, cslice, frames, halo);
}

}  // namespace

// dtype: 0 = bf16, 1 = f32.  The caller checks shapes, contiguity and,
// where C % (16 / sizeof(T)) == 0, 16-byte alignment; warp_shared_launch
// takes only such C.  Each returns a cudaError_t.
// feat (1, H, W, C): one map shared by the B frames, staged by the plan
// (tile_h, tile_w, cslice, frames, halo, vpt) of warp_plan.plan_shared, or
// gathered directly for tile_h = 0 (the direct plan);
// cudaErrorInvalidValue for a plan it does not take.
extern "C" int warp_shared_launch(const void* feat, const void* grid,
                                  void* out, int B, int H, int W, int C,
                                  int tile_h, int tile_w, int cslice,
                                  int frames, int halo, int vpt, int dtype,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_staged<__nv_bfloat16>(feat, grid, out, B, H, W, C, tile_h,
                                       tile_w, cslice, frames, halo, vpt, s);
  } else if (dtype == 1) {
    err = launch_staged<float>(feat, grid, out, B, H, W, C, tile_h, tile_w,
                               cslice, frames, halo, vpt, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// feat (B, H, W, C): frame b's own map, any C.
extern "C" int warp_per_frame_launch(const void* feat, const void* grid,
                                     void* out, int B, int H, int W, int C,
                                     int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_gather<__nv_bfloat16, true>(feat, grid, out, B, H, W, C, s);
  } else if (dtype == 1) {
    err = launch_gather<float, true>(feat, grid, out, B, H, W, C, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* warp_shared_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
