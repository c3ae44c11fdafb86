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
// 50 MB grid and the 17 MB map and writes 38 MB of RGB: 0.031 ms of HBM
// time, far above its least arithmetic (below).
// Design: the warp and the 1x1 contraction are both linear and per pixel,
// so they commute: sum_c wk[o,c] sum_k w_k f[q_k, c] = sum_k w_k y[q_k, o]
// with y = the map contracted to 3 channels.  Each block contracts a window
// of the map once, its tile + halo px each side (+1), into shared memory
// (y, f32, 16 bytes a pixel); every frame then warps 3 channels: 12 FMAs
// and 4 16-byte shared loads per output pixel, against 14*C f32 operations
// to warp C channels and contract them.  A tap outside the window
// contracts its map pixel from device memory, so any flow stays exact.
// The sums are taken in another order than the plain version's
// (contraction before the taps, FMAs): a few f32 ulp, far inside the 2^-7
// (bf16) or 1e-5 (f32) of max|feat| x max_o sum_c |wk[o, c]| the kernel is
// held to.  Threads take pixels, each walking its frames with no barrier
// and reading each grid entry from device memory two frames ahead of its
// use; a pixel whose 4 taps all lie in the window skips the per-tap tests.
// A warp's pixels are a run of a tile row, so its 3 stores of a frame
// cover 32 x 3 contiguous outputs, which L2 merges into whole sectors.

#include "warp_common.cuh"

namespace {

using warp::kSmemLimit;
using warp::kThreads;
using warp::pixel_taps;
using warp::Swizzle;
using warp::Taps;
using warp::Tile;
using warp::Vec;
using warp::Window;
using warp::block_tile;
using warp::window_bytes;

// y[o] = sum_c wk[o, c] * px[c] for o < 3 (f32 FMAs in channel order), with
// wk (3, C) f32 in shared memory, read in 16-byte broadcasts.
template <typename T>
__device__ __forceinline__ float4 contract(const T* __restrict__ px,
                                           const float* w_s, int C) {
  constexpr int V = Vec<T>::N;
  float y[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int c = 0; c < C; c += V) {
    float x[V];
    Vec<T>::load(px + c, x);
#pragma unroll
    for (int o = 0; o < 3; ++o) {
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const uint4 w = warp::ld_shared16(w_s + o * C + c + i);
        y[o] = fmaf(__uint_as_float(w.x), x[i], y[o]);
        y[o] = fmaf(__uint_as_float(w.y), x[i + 1], y[o]);
        y[o] = fmaf(__uint_as_float(w.z), x[i + 2], y[o]);
        y[o] = fmaf(__uint_as_float(w.w), x[i + 3], y[o]);
      }
    }
  }
  return make_float4(y[0], y[1], y[2], 0.0f);
}

// contract() of a map pixel outside the window, kept out of line: inlined
// into the frame loop it costs the loop registers, and the card blocks.
template <typename T>
__device__ __noinline__ float4 contract_global(const T* __restrict__ px,
                                               const float* w_s, int C) {
  return contract(px, w_s, C);
}

// One output pixel of one frame, any grid entry: each valid tap reads its
// contracted map pixel from the window, or contracts it from device memory
// when it lies outside; a pixel with a NaN coordinate is NaN (nan_pixel).
template <typename T>
__device__ __forceinline__ float4 warp_pixel(const T* __restrict__ feat,
                                             const float* w_s,
                                             const float4* win, Window box,
                                             float2 g, int H, int W, int C) {
  const Taps tp = pixel_taps(g, H, W);
  // 0, or NaN for a NaN coordinate (its taps all fail their float tests)
  const float rgb0 = tp.nan ? warp::nan_value() : 0.0f;
  float rgb[3] = {rgb0, rgb0, rgb0};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!tp.valid[k]) continue;
    const int q = box.offset(tp.iy[k], tp.ix[k]);
    const float4 y =
        q >= 0 ? win[q]
               : contract_global(
                     feat + (static_cast<long long>(tp.iy[k]) * W + tp.ix[k]) *
                                C,
                     w_s, C);
    rgb[0] = fmaf(tp.w[k], y.x, rgb[0]);
    rgb[1] = fmaf(tp.w[k], y.y, rgb[1]);
    rgb[2] = fmaf(tp.w[k], y.z, rgb[2]);
  }
  return make_float4(rgb[0], rgb[1], rgb[2], 0.0f);
}

// At most 64 registers a thread, so that 4 blocks share an SM: the frame
// loop waits on device memory for its grid entries, and more warps hide it.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    warp_rgb_kernel(const T* __restrict__ feat,
                    const float2* __restrict__ grid,
                    const float* __restrict__ wk, T* __restrict__ out, int B,
                    int H, int W, int C, int tile_h, int tile_w, int frames,
                    int halo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = block_tile(B, H, W, tile_h, tile_w, frames);
  // y of the window: one float4 (3 channels + pad) a pixel
  float4* win = reinterpret_cast<float4*>(smem_raw);
  float* w_s = reinterpret_cast<float*>(
      smem_raw + window_bytes(tile_h, tile_w, halo, H, W, 1, 16));
  for (int i = threadIdx.x; i < 3 * C; i += kThreads) w_s[i] = wk[i];
  // the window: the tile + halo px each side (+1 on the far side for the
  // second tap), cut to the map
  Window box{max(t.y0 - halo, 0), max(t.x0 - halo, 0), 0, 0, Swizzle(1, 1)};
  box.h = min(t.y0 + t.h + halo + 1, H) - box.y0;
  box.w = min(t.x0 + t.w + halo + 1, W) - box.x0;
  __syncthreads();
  for (int i = threadIdx.x; i < box.h * box.w; i += kThreads) {
    const int ry = i / box.w;
    win[i] = contract(
        feat + (static_cast<long long>(box.y0 + ry) * W + box.x0 +
                (i - ry * box.w)) * C,
        w_s, C);
  }
  __syncthreads();

  // the top-left taps whose 2x2 square lies in the window (float bounds:
  // a NaN or far-off coordinate fails them and takes warp_pixel)
  const float x_lo = static_cast<float>(box.x0);
  const float x_hi = static_cast<float>(box.x0 + box.w - 2);
  const float y_lo = static_cast<float>(box.y0);
  const float y_hi = static_cast<float>(box.y0 + box.h - 2);
  const int npx = t.h * t.w;
  const long long hw = static_cast<long long>(H) * W;
  for (int p = threadIdx.x; p < npx; p += kThreads) {
    const int py = p / t.w;
    const long long pix0 =
        static_cast<long long>(t.y0 + py) * W + t.x0 + (p - py * t.w);
    const float2* g = grid + t.b0 * hw + pix0;
    T* dst = out + (t.b0 * hw + pix0) * 3;
    // grid entries are loaded two frames ahead of their use
    float2 g0 = __ldg(g);
    float2 g1 = t.nf > 1 ? __ldg(g + hw) : g0;
#pragma unroll 1
    for (int f = 0; f < t.nf; ++f) {
      const float2 gv = g0;
      g0 = g1;
      if (f + 2 < t.nf) g1 = __ldg(g + (f + 2) * hw);
      const float fx = warp::source_coord(gv.x, W);
      const float fy = warp::source_coord(gv.y, H);
      const float x0 = floorf(fx);
      const float y0 = floorf(fy);
      float4 rgb;
      if (x0 >= x_lo && x0 <= x_hi && y0 >= y_lo && y0 <= y_hi) {
        // all 4 taps staged and in the image: warp_pixel's sums, in its
        // order, without its tests
        const float tx = __fsub_rn(fx, x0);
        const float ty = __fsub_rn(fy, y0);
        const float wx0 = __fsub_rn(1.0f, tx);
        const float wy0 = __fsub_rn(1.0f, ty);
        const float w[4] = {__fmul_rn(wy0, wx0), __fmul_rn(wy0, tx),
                            __fmul_rn(ty, wx0), __fmul_rn(ty, tx)};
        const int q = (static_cast<int>(y0) - box.y0) * box.w +
                      static_cast<int>(x0) - box.x0;
        const int qs[4] = {q, q + 1, q + box.w, q + box.w + 1};
        rgb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 y = win[qs[k]];
          rgb.x = fmaf(w[k], y.x, rgb.x);
          rgb.y = fmaf(w[k], y.y, rgb.y);
          rgb.z = fmaf(w[k], y.z, rgb.z);
        }
      } else {
        rgb = warp_pixel(feat, w_s, win, box, gv, H, W, C);
      }
      // a warp's pixels are a run of its tile row: 32 x 3 contiguous
      // outputs, written as 3 stores each
      T* d = dst + f * hw * 3;
      d[0] = Vec<T>::from_float(rgb.x);
      d[1] = Vec<T>::from_float(rgb.y);
      d[2] = Vec<T>::from_float(rgb.z);
    }
  }
}

template <typename T>
cudaError_t launch(const void* feat, const void* grid, const void* wk,
                   void* out, int B, int H, int W, int C, int tile_h,
                   int tile_w, int frames, int halo, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  if (tile_h < 1 || tile_w < 1 || frames < 1 || halo < 0 || C % V) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = static_cast<long long>((H + tile_h - 1) / tile_h) *
                          ((W + tile_w - 1) / tile_w);
  const int groups = (B + frames - 1) / frames;
  if (tiles > 0x7fffffffLL || groups > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  const size_t smem = window_bytes(tile_h, tile_w, halo, H, W, 1, 16) +
                      3 * static_cast<size_t>(C) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  cudaError_t err = warp::allow_smem<warp_rgb_kernel<T>>();
  if (err != cudaSuccess) return err;
  const dim3 blocks(static_cast<unsigned int>(tiles), 1, groups);
  warp_rgb_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const float2*>(grid),
      static_cast<const float*>(wk), static_cast<T*>(out), B, H, W, C,
      tile_h, tile_w, frames, halo);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = f32.  The caller checks shapes, contiguity, 16-byte
// alignment of feat and C % (16 / sizeof(T)) == 0; the plan (tile_h,
// tile_w, frames, halo) is warp_plan.plan_rgb's, all of C per block.
// Returns a cudaError_t: cudaErrorInvalidValue for a plan it does not take.
extern "C" int warp_rgb_launch(const void* feat, const void* grid,
                               const void* wk, void* out, int B, int H,
                               int W, int C, int tile_h, int tile_w,
                               int frames, int halo, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<__nv_bfloat16>(feat, grid, wk, out, B, H, W, C, tile_h,
                                tile_w, frames, halo, s);
  } else if (dtype == 1) {
    err = launch<float>(feat, grid, wk, out, B, H, W, C, tile_h, tile_w,
                        frames, halo, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* warp_rgb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
