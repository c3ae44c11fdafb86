// Pieces shared by the bilinear warp kernels (warp_shared.cu, warp_rgb.cu,
// warp_window.cu): 16-byte channel-vector loads and stores (and one-channel
// ones, Scalar), the source coordinate of grid_sample with
// align_corners=False and its taps, rounded op by op like the plain
// PyTorch version (float_torch/ops/warp.py::_warp_f32), and the staging of
// the shared-map kernels (K1, K2): a block stages a window of the map once
// for every frame to gather from.  K1 first copies its tile's grid entries
// into shared memory and reduces their tap rows and columns (the
// footprint) to fit its window.  The plan arithmetic is mirrored in
// float_torch/kernels/warp_plan.py.
#pragma once

#include <algorithm>
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace warp {

constexpr int kThreads = 256;  // threads per block of every warp kernel
constexpr int kWarps = kThreads / 32;
// Dynamic shared memory a block may use: Hopper's 227 KB per block less
// 1 KB for the kernels' static shared memory (the footprint reduction).
constexpr int kSmemLimit = 232448 - 1024;

// 16 bytes of shared memory in one ld.shared.v4 (a plain dereference may be
// split into four 32-bit loads, which conflict across a warp).
__device__ __forceinline__ uint4 ld_shared16(const void* p) {
  uint4 q;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(q.x), "=r"(q.y), "=r"(q.z), "=r"(q.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return q;
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* v) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  __device__ __forceinline__ static void load_shared(const float* p,
                                                     float* v) {
    unpack(ld_shared16(p), v);
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ static float from_float(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the high half of the f32 it widens to: one shift or mask
  __device__ __forceinline__ static void unpack(const uint4& q, float* v) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  __device__ __forceinline__ static void load_shared(const __nv_bfloat16* p,
                                                     float* v) {
    unpack(ld_shared16(p), v);
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
  __device__ __forceinline__ static __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
};

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

// float_tpu's tap rule, as the kernels apply it.  float_tpu converts
// floor(f) of a source coordinate to an integer tap with astype(int32)
// (float_torch/ops/warp.py::tap_floor): NaN becomes 0, far and infinite
// values saturate.  So a NaN coordinate has in-image taps with NaN
// weights, and every tap weight of its pixel is a product with a NaN
// (even where the other axis weighs 0): the pixel is NaN in every
// channel.  Any other coordinate's taps lie in the image exactly where the
// float tests of floor(f) + d say so.  So the kernels test taps in float
// and write NaN for a pixel with a NaN coordinate, reading no tap for it.
__device__ __forceinline__ bool nan_pixel(float fx, float fy) {
  return fx != fx || fy != fy;
}

__device__ __forceinline__ float nan_value() {
  return __int_as_float(0x7fc00000);
}

// ((g + 1) * size - 1) * 0.5, rounded op by op like the plain version.
__device__ __forceinline__ float source_coord(float g, int size) {
  return __fmul_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), static_cast<float>(size)), 1.0f),
      0.5f);
}

// One output tile of a staged kernel: rows [y0, y0 + h), columns
// [x0, x0 + w), frames [b0, b0 + nf); the block index is (tile, channel
// slice, frame group), tiles row-major (warp_plan.blocks).
struct Tile {
  int y0, x0, h, w, b0, nf;
};

__device__ __forceinline__ Tile block_tile(int B, int H, int W, int tile_h,
                                           int tile_w, int frames) {
  const int tiles_x = (W + tile_w - 1) / tile_w;
  Tile t;
  t.y0 = static_cast<int>(blockIdx.x / tiles_x) * tile_h;
  t.x0 = static_cast<int>(blockIdx.x % tiles_x) * tile_w;
  t.h = min(tile_h, H - t.y0);
  t.w = min(tile_w, W - t.x0);
  t.b0 = static_cast<int>(blockIdx.z) * frames;
  t.nf = min(frames, B - t.b0);
  return t;
}

// Bank swizzle of a staged window.  A pixel's nv 16-byte vectors are read
// by its G threads, thread g taking vectors g, g + G, ...; vector v of
// window pixel q sits at slot v ^ (((q >> shift) & mask) << lg), lg =
// log2 G, so that a quarter-warp's loads (8 threads: 8 / G neighbouring
// taps x G vectors) fall in 8 different 16-byte bank groups.  Only powers
// of two are swizzled (mask 0 otherwise).
struct Swizzle {
  int shift, mask, lg;
  __device__ __forceinline__ Swizzle(int nv, int g) {
    const bool pow2 = (nv & (nv - 1)) == 0 && (g & (g - 1)) == 0 && g <= nv;
    const int groups = min(nv, 8);  // 16-byte bank groups a pixel spans
    lg = pow2 ? __ffs(g) - 1 : 0;
    mask = pow2 && g < groups ? groups / g - 1 : 0;
    shift = nv >= 8 ? 0 : __ffs(8 / nv) - 1;
  }
  __device__ __forceinline__ int slot(int q, int v) const {
    return v ^ (((q >> shift) & mask) << lg);
  }
};

// The staged part of the map: rows [y0, y0 + h) x columns [x0, x0 + w),
// stored (h, w, cslice) in shared memory, vectors swizzled.  h or w may
// be 0.
struct Window {
  int y0, x0, h, w;
  Swizzle sw;
  // pixel index of tap (iy, ix) in the window, or -1 if it is not staged
  __device__ __forceinline__ int offset(int iy, int ix) const {
    const unsigned ry = static_cast<unsigned>(iy - y0);
    const unsigned rx = static_cast<unsigned>(ix - x0);
    return (ry < static_cast<unsigned>(h) && rx < static_cast<unsigned>(w))
               ? static_cast<int>(ry) * w + static_cast<int>(rx)
               : -1;
  }
};

// The union [lo, hi] of one axis' taps, fitted to the cap: kept whole if
// it fits, else cut to the tile's own span +- halo (+1 on the far side).
__device__ __forceinline__ void fit_span(int lo, int hi, int t0, int tile,
                                         int halo, int size, int* w0,
                                         int* n) {
  const int cap = min(tile + 2 * halo + 1, size);
  if (lo > hi) {  // no tap in the image
    *w0 = 0;
    *n = 0;
    return;
  }
  if (hi - lo + 1 > cap) {
    lo = max(lo, t0 - halo);
    hi = min(hi, t0 + tile + halo);
  }
  *w0 = lo;
  *n = max(0, hi - lo + 1);
}

// Lets kernel use all kSmemLimit bytes of dynamic shared memory, once per
// device (above 48 KB a launch needs the attribute set first).
template <auto kernel>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_sync() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Shared memory of a staged block, in this order: the window (16-byte
// aligned), the tile's grid entries (frames x tile pixels float2), then
// whatever the kernel adds.  Mirrored by warp_plan.smem_bytes.
__host__ __device__ __forceinline__ size_t window_bytes(int tile_h,
                                                        int tile_w, int halo,
                                                        int H, int W,
                                                        int cslice,
                                                        int esize) {
  const int cap_h = tile_h + 2 * halo + 1 < H ? tile_h + 2 * halo + 1 : H;
  const int cap_w = tile_w + 2 * halo + 1 < W ? tile_w + 2 * halo + 1 : W;
  return static_cast<size_t>(cap_h) * cap_w * cslice * esize;
}

__host__ __device__ __forceinline__ size_t grid_bytes(int tile_h, int tile_w,
                                                      int frames) {
  return (static_cast<size_t>(frames) * tile_h * tile_w * 8 + 15) / 16 * 16;
}

// Block-wide.  Copies the tile's grid entries of its frames into s_grid
// ((frame, pixel) order, asynchronous copies), reduces their in-image tap
// rows and columns (the footprint), and fits them to the cap (tile_h /
// tile_w + 2 halo + 1): the window to stage.  A coordinate that is NaN,
// infinite or far off fails the float tests and never becomes an index
// (a NaN one's pixel is NaN and reads no tap: nan_pixel).
// Ends with the grid tile in shared memory, visible to the whole block.
__device__ __forceinline__ Window stage_grid(const float2* __restrict__ grid,
                                             float2* s_grid, const Tile& t,
                                             int H, int W, int tile_h,
                                             int tile_w, int halo,
                                             Swizzle sw) {
  const int npx = t.h * t.w;
  const int n = t.nf * npx;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int f = e / npx;
    const int p = e - f * npx;
    const int py = p / t.w;
    cp_async8(s_grid + e,
              grid + (static_cast<long long>(t.b0 + f) * H + t.y0 + py) * W +
                  t.x0 + (p - py * t.w));
  }
  cp_async_wait_sync();

  __shared__ int red[4][kWarps];
  int ymin = INT_MAX, ymax = INT_MIN, xmin = INT_MAX, xmax = INT_MIN;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float2 g = s_grid[e];
    const float x0 = floorf(source_coord(g.x, W));
    const float y0 = floorf(source_coord(g.y, H));
    // some tap of the 2x2 square lies in the image
    if (x0 >= -1.0f && x0 <= static_cast<float>(W - 1) && y0 >= -1.0f &&
        y0 <= static_cast<float>(H - 1)) {
      const int ix = static_cast<int>(x0);
      const int iy = static_cast<int>(y0);
      xmin = min(xmin, max(ix, 0));
      xmax = max(xmax, min(ix + 1, W - 1));
      ymin = min(ymin, max(iy, 0));
      ymax = max(ymax, min(iy + 1, H - 1));
    }
  }
  ymin = __reduce_min_sync(0xffffffffu, ymin);
  ymax = __reduce_max_sync(0xffffffffu, ymax);
  xmin = __reduce_min_sync(0xffffffffu, xmin);
  xmax = __reduce_max_sync(0xffffffffu, xmax);
  const int warp_id = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[0][warp_id] = ymin;
    red[1][warp_id] = ymax;
    red[2][warp_id] = xmin;
    red[3][warp_id] = xmax;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    ymin = min(ymin, red[0][k]);
    ymax = max(ymax, red[1][k]);
    xmin = min(xmin, red[2][k]);
    xmax = max(xmax, red[3][k]);
  }
  Window box{0, 0, 0, 0, sw};
  fit_span(ymin, ymax, t.y0, tile_h, halo, H, &box.y0, &box.h);
  fit_span(xmin, xmax, t.x0, tile_w, halo, W, &box.x0, &box.w);
  return box;
}

// Block-wide.  Copies channels [c0, c0 + cslice) of the window ``box`` of
// feat (1, H, W, C) into win (asynchronous 16-byte copies, vectors
// swizzled); ends with it visible to the whole block.
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ feat,
                                             T* win, const Window& box,
                                             int W, int C, int c0,
                                             int cslice) {
  constexpr int V = Vec<T>::N;
  const int nvec = cslice / V;
  const int n16 = box.h * box.w * nvec;
  for (int i = threadIdx.x; i < n16; i += kThreads) {
    const int pix = i / nvec;
    const int v = i - pix * nvec;
    const int ry = pix / box.w;
    const int rx = pix - ry * box.w;
    cp_async16(win + static_cast<long long>(pix) * cslice +
                   box.sw.slot(pix, v) * V,
               feat + (static_cast<long long>(box.y0 + ry) * W + box.x0 +
                       rx) * C +
                   c0 + v * V);
  }
  cp_async_wait_sync();
}

// Bilinear taps of one output pixel: the float-tested validity of each of
// the 4 taps (dy, dx) in (0,0), (0,1), (1,0), (1,1) order, its weight
// wy * wx rounded like the plain version, and its integer row/column;
// ``nan``: a coordinate is NaN, so the pixel is NaN (nan_pixel).
struct Taps {
  bool valid[4];
  float w[4];
  int iy[4], ix[4];
  bool nan;
};

__device__ __forceinline__ Taps pixel_taps(float2 g, int H, int W) {
  const float fx = source_coord(g.x, W);
  const float fy = source_coord(g.y, H);
  // floorf, not an int cast: negative coordinates must round down.
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float tx = __fsub_rn(fx, x0);
  const float ty = __fsub_rn(fy, y0);
  const float wx[2] = {__fsub_rn(1.0f, tx), tx};
  const float wy[2] = {__fsub_rn(1.0f, ty), ty};
  Taps t;
  t.nan = nan_pixel(fx, fy);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const float yy = y0 + static_cast<float>(dy);
    const bool vy = yy >= 0.0f && yy < static_cast<float>(H);
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float xx = x0 + static_cast<float>(dx);
      const int k = 2 * dy + dx;
      t.valid[k] = vy && xx >= 0.0f && xx < static_cast<float>(W);
      t.w[k] = __fmul_rn(wy[dy], wx[dx]);
      t.iy[k] = t.valid[k] ? static_cast<int>(yy) : 0;
      t.ix[k] = t.valid[k] ? static_cast<int>(xx) : 0;
    }
  }
  return t;
}

}  // namespace warp
