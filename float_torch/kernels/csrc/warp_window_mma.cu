// K5: the windowed bilinear warp as selection products on the tensor cores.
//
//   feat (B, H, W, C) bf16, grid (B, H, W, 2) f32 (x, y in [-1, 1]),
//   out (B, H, W, C) bf16; H % 8 == 0, W % 128 == 0, C % 8 == 0.
//   An output pixel (b, y, x) lies in tile (i, j) = (y / 8, x / 128), whose
//   window is rows [rs, rs + wr) x columns [cs, cs + wc):
//     wr = min(H, 8 + 2 my), rs = clip(8 i - my, 0, H - wr),
//     wc = min(W, 128 + 2 mx), cs = clip(128 j - mx, 0, W - wc).
//   A pixel none of whose in-image taps leaves the window ("in window"):
//     out = bf16( (s00 f00 + s01 f01) + (s10 f10 + s11 f11) ), s = bf16(wx wy)
//   in f32 (grid_sample's bilinear taps, zeros padding, align_corners=False;
//   a tap outside the image weighs 0).  Any other pixel ("overflow"): the
//   exact warp, bit for bit float_torch.ops.warp.grid_sample_bilinear_ref.
//
// Replaces the TPU kernel experiments/pallas_warp_selection_matmul.py::
// _kernel (launched by _warp_pallas_nhwc, wrapped by warp_bilinear_pallas).
// The TPU kernel copies the whole window into VMEM and, per output row,
// contracts each window row against a dense (wc x 128) one-hot selection
// built on the VPU; overflow pixels are replaced by a second, exact warp
// under a lax.cond.
//
// What bounds it on an H100: the bytes (feat and grid read once, out
// written once: 0.17 ms at 512^2 x 32, B=16, at 3.35 TB/s).  Dense, the
// selection products would be 1.65 TFLOP there, 1.7 ms of tensor-core peak,
// so the design issues only the products that can hold a nonzero weight:
//   - a block takes half a tile (8 rows x 64 columns) and CB = 8 NB
//     channels (NB = 4, 2 or 1 as C allows); warp w takes row w as 4
//     groups of 16 pixels, the M = 16 rows of an mma.sync.m16n8k16 (bf16
//     in, f32 accumulators), N = 8 channels an MMA;
//   - each group's least and greatest tap row and column (in-window pixels
//     only) give the window rows and 16-column k-blocks it touches; every
//     other (row, k-block) has only zero weights and is skipped (the maps
//     are finite, so a skipped block adds exact zeros);
//   - one accumulator per tap: an MMA's A fragment holds one tap's
//     selection weight per pixel, bf16(wx wy) rounded once per pixel, so
//     each accumulator receives a single nonzero product, which the tensor
//     core computes exactly; the epilogue adds the four in the plain
//     version's order with f32 round-to-nearest adds.  Summing a pixel's
//     taps inside one MMA instead lets the tensor core's own accumulation
//     order and rounding through: on an H100 that put elements up to 8
//     bf16 ulps off where the taps cancel;
//   - the B fragments, a window row's 16 columns x 8 channels, come from
//     shared memory by ldmatrix.trans, one load for the four taps;
//   - shared memory holds 227 KB, not the TPU's 1.5 MiB window, so the rows
//     the block touches stream through a ring of two 48 KB chunks
//     (cp.async) that overlap by a group's row span less one: each group
//     is issued whole within one chunk, its accumulators live in
//     registers only while it runs;
//   - a group whose rows do not fit one chunk, and every overflow pixel,
//     is computed on the CUDA cores in the epilogue of the same launch
//     from device memory: in-window pixels with the selection weights in
//     the plain version's order, overflow pixels with the exact warp's
//     f32 weights (warp_common.cuh's pixel_taps, the rounding of K3); no
//     host sync and no second warp.
// So every element equals the plain version bit for bit.
// An optional counter receives the number of MMAs issued.

#include <climits>
#include <cstdint>

#include "warp_common.cuh"

namespace {

using warp::pixel_taps;
using warp::source_coord;
using warp::Taps;

constexpr int kTR = 8;
constexpr int kTC = 128;        // the TPU tile's columns: the window's unit
constexpr int kBC = 64;         // a block's columns: half a tile
constexpr int kThreads = 256;   // 8 warps: warp w takes row w
constexpr int kGroups = kBC / 16;
constexpr int kPix = kTR * kBC;
constexpr int kChunkBytes = 48 * 1024;
// Shared memory layout.
constexpr int kOffPx = 0;                       // int4 [kPix]: x0-cs, y0, s0, s1
constexpr int kOffRange = kOffPx + kPix * 16;   // int4 [kTR * kGroups]
constexpr int kOffSpan = kOffRange + kTR * kGroups * 16;  // int4, the same
constexpr int kOffOvf = kOffSpan + kTR * kGroups * 16;    // unsigned [2 kTR]
constexpr int kOffRed = kOffOvf + 2 * kTR * 4;  // int4 [kTR]: warp ranges
constexpr int kOffRing = (kOffRed + kTR * 16 + 127) / 128 * 128;
constexpr int kSmemBytes = kOffRing + 2 * kChunkBytes;
// A coordinate's floor is clamped to +-2^30 before it becomes an int: any
// tap that far is outside the image either way.
constexpr float kCoordClamp = 1073741824.0f;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major); bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment register of window columns (q, q + 1) for one tap of a
// pixel: its bf16 weight w (16 bits) at column c, d = q - c, lands in the
// low half (d == 0), the high half (d == -1), or neither.
__device__ __forceinline__ unsigned put(int d, unsigned w) {
  return d == 0 ? w : (d == -1 ? w << 16 : 0u);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ int min16(int v) {  // min over a half-warp
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) v = min(v, __shfl_xor_sync(~0u, v, m));
  return v;
}

__device__ __forceinline__ int max16(int v) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) v = max(v, __shfl_xor_sync(~0u, v, m));
  return v;
}

// Byte offset of 16-byte block nb of window column `col` in a ring row,
// NB blocks a column: the blocks are swizzled so that 8 neighbouring
// columns of one block (an ldmatrix) fall in 8 different 16-byte bank
// groups.
template <int NB>
__device__ __forceinline__ int slot_offset(int col, int nb) {
  constexpr int kShift = NB == 4 ? 1 : NB == 2 ? 2 : 3;
  return (col * NB + (nb ^ ((col >> kShift) & (NB - 1)))) * 16;
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 2)
    window_mma_kernel(const __nv_bfloat16* __restrict__ feat,
                      const float2* __restrict__ grid,
                      __nv_bfloat16* __restrict__ out, int H, int W, int C,
                      int my, int mx,
                      unsigned long long* __restrict__ mma_count) {
  constexpr int CB = 8 * NB;
  extern __shared__ __align__(128) unsigned char smem[];
  int4* s_px = reinterpret_cast<int4*>(smem + kOffPx);
  int4* s_range = reinterpret_cast<int4*>(smem + kOffRange);
  int4* s_span = reinterpret_cast<int4*>(smem + kOffSpan);
  unsigned* s_ovf = reinterpret_cast<unsigned*>(smem + kOffOvf);
  int4* s_red = reinterpret_cast<int4*>(smem + kOffRed);
  unsigned char* ring = smem + kOffRing;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bx = blockIdx.x * kBC;  // the block's first column
  const int j = bx / kTC;           // its TPU tile
  const int i = blockIdx.y;
  const int slices = C / CB;
  const int b = blockIdx.z / slices;
  const int c0 = (blockIdx.z - b * slices) * CB;
  const int wr = min(H, kTR + 2 * my);
  const int wc = min(W, kTC + 2 * mx);
  const int rs = min(max(i * kTR - my, 0), H - wr);
  const int cs = min(max(j * kTC - mx, 0), W - wc);
  const int y = i * kTR + warp;
  const long long row_pix = (static_cast<long long>(b) * H + y) * W + bx;

  // 1. Each pixel of the warp's row: taps, overflow, selection weights;
  // each group's tap rows and k-blocks (in-window pixels' taps in the
  // image), the span of its pixels' top-left taps, and the warp's union.
  int4 wrange = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
#pragma unroll
  for (int k = 0; k < kBC / 32; ++k) {
    const int px = lane + 32 * k;
    const float2 g = __ldg(grid + row_pix + px);
    const float fx = source_coord(g.x, W);
    const float fy = source_coord(g.y, H);
    const float x0f = floorf(fx);
    const float y0f = floorf(fy);
    const float tx = __fsub_rn(fx, x0f);
    const float ty = __fsub_rn(fy, y0f);
    const int x0 = static_cast<int>(fminf(fmaxf(x0f, -kCoordClamp),
                                          kCoordClamp));
    const int y0 = static_cast<int>(fminf(fmaxf(y0f, -kCoordClamp),
                                          kCoordClamp));
    const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
    const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
    const bool ovf = (vy0 && (y0 < rs || y0 >= rs + wr)) ||
                     (vy1 && (y0 + 1 < rs || y0 + 1 >= rs + wr)) ||
                     (vx0 && (x0 < cs || x0 >= cs + wc)) ||
                     (vx1 && (x0 + 1 < cs || x0 + 1 >= cs + wc));
    const bool used = !ovf && (vy0 || vy1) && (vx0 || vx1);
    // the TPU's selection weights, bf16(f32(wx * wy)), for rows y0 and
    // y0 + 1, each a packed pair (column x0 | column x0 + 1 << 16)
    const float wx0 = vx0 ? __fsub_rn(1.0f, tx) : 0.0f;
    const float wx1 = vx1 ? tx : 0.0f;
    const float wy0 = used && vy0 ? __fsub_rn(1.0f, ty) : 0.0f;
    const float wy1 = used && vy1 ? ty : 0.0f;
    s_px[warp * kBC + px] = make_int4(
        x0 - cs, y0,
        static_cast<int>(pack_bf16(__fmul_rn(wx0, wy0), __fmul_rn(wx1, wy0))),
        static_cast<int>(pack_bf16(__fmul_rn(wx0, wy1), __fmul_rn(wx1, wy1))));
    const unsigned bits = __ballot_sync(~0u, ovf);
    if (lane == 0) s_ovf[warp * 2 + k] = bits;
    const int rlo = min16(used ? (vy0 ? y0 : y0 + 1) : INT_MAX);
    const int rhi = max16(used ? (vy1 ? y0 + 1 : y0) : INT_MIN);
    const int clo = min16(used ? (vx0 ? x0 : x0 + 1) - cs : INT_MAX);
    const int chi = max16(used ? (vx1 ? x0 + 1 : x0) - cs : INT_MIN);
    const int4 span = make_int4(min16(used ? y0 : INT_MAX),
                                max16(used ? y0 : INT_MIN),
                                min16(used ? x0 - cs : INT_MAX),
                                max16(used ? x0 - cs : INT_MIN));
    const int4 gr = rlo <= rhi ? make_int4(rlo, rhi, clo >> 4, chi >> 4)
                               : make_int4(INT_MAX, INT_MIN, 0, -1);
    if ((lane & 15) == 0) {
      s_range[warp * kGroups + 2 * k + (lane >> 4)] = gr;
      s_span[warp * kGroups + 2 * k + (lane >> 4)] = span;
    }
    if (rlo <= rhi) {
      wrange.x = min(wrange.x, gr.x);
      wrange.y = max(wrange.y, gr.y);
      wrange.z = min(wrange.z, gr.z);
      wrange.w = max(wrange.w, gr.w);
    }
  }
  // the two half-warps' groups
  wrange.x = min(wrange.x, __shfl_xor_sync(~0u, wrange.x, 16));
  wrange.y = max(wrange.y, __shfl_xor_sync(~0u, wrange.y, 16));
  wrange.z = min(wrange.z, __shfl_xor_sync(~0u, wrange.z, 16));
  wrange.w = max(wrange.w, __shfl_xor_sync(~0u, wrange.w, 16));
  if (lane == 0) s_red[warp] = wrange;
  __syncthreads();
  int r_lo = INT_MAX, r_hi = INT_MIN, k_lo = INT_MAX, k_hi = INT_MIN;
#pragma unroll
  for (int w = 0; w < kTR; ++w) {
    const int4 v = s_red[w];
    r_lo = min(r_lo, v.x);
    r_hi = max(r_hi, v.y);
    k_lo = min(k_lo, v.z);
    k_hi = max(k_hi, v.w);
  }

  // 2. The chunk plan: rpc rows of the touched k-blocks a chunk; a group
  // spanning at most rpc rows is issued whole in chunk (rlo - r_lo) /
  // step, chunks starting step = rpc - S + 1 rows apart (S the longest
  // such span), so each one holds every group assigned to it; longer
  // groups fall to the CUDA cores (3.).
  const int n_rows = r_lo <= r_hi ? r_hi - r_lo + 1 : 0;
  const int ncols = n_rows ? (k_hi - k_lo + 1) * 16 : 0;
  const int row_bytes = ncols * CB * 2;
  const int rpc = n_rows ? min(kChunkBytes / row_bytes, n_rows) : 0;
  int span_max = 0;
#pragma unroll 4
  for (int e = 0; e < kTR * kGroups; ++e) {
    const int4 gr = s_range[e];
    const int n = gr.x <= gr.y ? gr.y - gr.x + 1 : 0;
    if (n <= rpc) span_max = max(span_max, n);
  }
  const int step = rpc - span_max + 1;
  const int n_chunks =
      span_max == 0 ? 0
                    : 1 + (n_rows > rpc ? (n_rows - rpc + step - 1) / step : 0);
  const __nv_bfloat16* map = feat + static_cast<long long>(b) * H * W * C;

  auto stage = [&](int ch) {
    unsigned char* dst = ring + (ch & 1) * kChunkBytes;
    const int r0 = r_lo + ch * step;
    const int per_row = ncols * NB;
    const int n16 = (min(r0 + rpc - 1, r_hi) - r0 + 1) * per_row;
    for (int e = threadIdx.x; e < n16; e += kThreads) {
      const int rr = e / per_row;
      const int rem = e - rr * per_row;
      const int col = rem / NB;
      const int nb = rem % NB;
      const int x = cs + k_lo * 16 + col;
      unsigned char* d = dst + rr * row_bytes + slot_offset<NB>(col, nb);
      if (x < W) {
        warp::cp_async16(
            d, map + (static_cast<long long>(r0 + rr) * W + x) * C + c0 +
                   nb * 8);
      } else {  // a k-block past the image's edge: zeros, finite
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  const int t4 = lane & 3;
  const int pa_off = warp * kBC + (lane >> 2);  // pixel of A/D rows 0..7
  unsigned ovf[kBC / 32];
#pragma unroll
  for (int k = 0; k < kBC / 32; ++k) ovf[k] = s_ovf[warp * 2 + k];
  auto is_ovf = [&](int px) {
    return ((px < 32 ? ovf[0] : ovf[1]) >> (px & 31)) & 1u;
  };
  unsigned long long issued = 0;
  if (n_chunks) stage(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      stage(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* buf = ring + (ch & 1) * kChunkBytes;
    const int r0 = r_lo + ch * step;
    for (int g = 0; g < kGroups; ++g) {
      const int4 gr = s_range[warp * kGroups + g];
      if (gr.x > gr.y || gr.y - gr.x + 1 > rpc ||
          min((gr.x - r_lo) / step, n_chunks - 1) != ch) {
        continue;
      }
      const int4 sp = s_span[warp * kGroups + g];
      const int4 pa = s_px[pa_off + 16 * g];
      const int4 pb = s_px[pa_off + 16 * g + 8];
      float acc[2][2][NB][4];  // [dy][dx]: one tap each
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t >> 1][t & 1][nb][e] = 0.0f;
        }
      }
      for (int r = gr.x; r <= gr.y; ++r) {
        // tap row dy of some pixel lies on r (warp-uniform)
        const bool live[2] = {r >= sp.x && r <= sp.y,
                              r > sp.x && r <= sp.y + 1};
        const unsigned wa[2] = {r == pa.y ? static_cast<unsigned>(pa.z) : 0u,
                                r == pa.y + 1 ? static_cast<unsigned>(pa.w)
                                              : 0u};
        const unsigned wb[2] = {r == pb.y ? static_cast<unsigned>(pb.z) : 0u,
                                r == pb.y + 1 ? static_cast<unsigned>(pb.w)
                                              : 0u};
        const unsigned char* row = buf + (r - r0) * row_bytes;
        for (int kb = gr.z; kb <= gr.w; ++kb) {
          unsigned bf[NB][2];
          const int col0 = (kb - k_lo) * 16;
          if constexpr (NB == 1) {
            const int col = col0 + ((lane >> 3) & 1) * 8 + (lane & 7);
            ldmatrix_x2_trans(bf[0], row + slot_offset<1>(col, 0));
          } else {
            // per pair of channel blocks, matrices (k 0-7, nb), (k 8-15,
            // nb), (k 0-7, nb + 1), (k 8-15, nb + 1); lane l gives row
            // l & 7 of matrix l >> 3
            const int mi = lane >> 3;
            const int col = col0 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
            for (int nb = 0; nb < NB; nb += 2) {
              unsigned q4[4];
              ldmatrix_x4_trans(q4,
                                row + slot_offset<NB>(col, nb + (mi >> 1)));
              bf[nb][0] = q4[0];
              bf[nb][1] = q4[1];
              bf[nb + 1][0] = q4[2];
              bf[nb + 1][1] = q4[3];
            }
          }
          const int q = kb * 16 + 2 * t4;
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            if (!live[dy]) continue;
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
              // tap column dx of some pixel lies in this k-block
              if (sp.z + dx > kb * 16 + 15 || sp.w + dx < kb * 16) continue;
              const unsigned ha = dx ? wa[dy] >> 16 : wa[dy] & 0xFFFFu;
              const unsigned hb = dx ? wb[dy] >> 16 : wb[dy] & 0xFFFFu;
              const int da = q - pa.x - dx;
              const int db = q - pb.x - dx;
              const unsigned a[4] = {put(da, ha), put(db, hb),
                                     put(da + 8, ha), put(db + 8, hb)};
#pragma unroll
              for (int nb = 0; nb < NB; ++nb) {
                mma_bf16(acc[dy][dx][nb], a, bf[nb][0], bf[nb][1]);
              }
              issued += NB;
            }
          }
        }
      }
      // the plain version's order: (t00 + t01) + (t10 + t11), round to
      // nearest each
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = 16 * g + (lane >> 2) + 8 * half;
        if (is_ovf(px)) continue;
        __nv_bfloat16* dst = out + (row_pix + px) * C + c0 + 2 * t4;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 2 * half + e;
            v[e] = __fadd_rn(__fadd_rn(acc[0][0][nb][k], acc[0][1][nb][k]),
                             __fadd_rn(acc[1][0][nb][k], acc[1][1][nb][k]));
          }
          *reinterpret_cast<unsigned*>(dst + nb * 8) = pack_bf16(v[0], v[1]);
        }
      }
    }
    __syncthreads();
  }

  // 3. On the CUDA cores, from device memory: the pixels of groups the
  // tensor cores did not take (rows longer than a chunk, or no tap in the
  // image) with their selection weights in the plain version's order, and
  // the overflow pixels by the exact warp.
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int4 gr = s_range[warp * kGroups + g];
    const bool tensor = gr.x <= gr.y && gr.y - gr.x + 1 <= rpc;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = 16 * g + (lane >> 2) + 8 * half;
      const bool o = is_ovf(px);
      if (tensor && !o) continue;
      __nv_bfloat16* dst = out + (row_pix + px) * C + c0 + 2 * t4;
      const int4 p = s_px[warp * kBC + px];
      const Taps tp = pixel_taps(__ldg(grid + row_pix + px), H, W);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const __nv_bfloat16* base = map + c0 + nb * 8 + 2 * t4;
        float v[2];
        if (o) {
          float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!tp.valid[k]) continue;
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    base + (static_cast<long long>(tp.iy[k]) * W + tp.ix[k]) *
                               C));
            s0 = __fadd_rn(s0, __fmul_rn(tp.w[k], f.x));
            s1 = __fadd_rn(s1, __fmul_rn(tp.w[k], f.y));
          }
          v[0] = s0;
          v[1] = s1;
        } else {
          float rows[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            const unsigned pair = static_cast<unsigned>(dy ? p.w : p.z);
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
              const unsigned h = dx ? pair >> 16 : pair & 0xFFFFu;
              if (!h) continue;  // a zero weight: a tap off the image
              const float w = __uint_as_float(h << 16);
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      base + (static_cast<long long>(p.y + dy) * W + cs +
                              p.x + dx) *
                                 C));
              rows[dy][0] = __fadd_rn(rows[dy][0], __fmul_rn(w, f.x));
              rows[dy][1] = __fadd_rn(rows[dy][1], __fmul_rn(w, f.y));
            }
          }
          v[0] = __fadd_rn(rows[0][0], rows[1][0]);
          v[1] = __fadd_rn(rows[0][1], rows[1][1]);
        }
        *reinterpret_cast<unsigned*>(dst + nb * 8) = pack_bf16(v[0], v[1]);
      }
    }
  }
  if (mma_count != nullptr && lane == 0 && issued) {
    atomicAdd(mma_count, issued);
  }
}

// Ring chunk bytes one window row of k-blocks needs at NB.
inline long long row_need(int wc, int nb) {
  return static_cast<long long>((wc + 15) / 16) * 16 * nb * 16;
}

template <int NB>
cudaError_t launch(const void* feat, const void* grid, void* out, int B,
                   int H, int W, int C, int my, int mx, void* mma_count,
                   cudaStream_t stream) {
  const long long z = static_cast<long long>(B) * (C / (8 * NB));
  if (H / kTR > 65535 || z > 65535) return cudaErrorInvalidConfiguration;
  static bool attr_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || !attr_set[device]) {
    err = cudaFuncSetAttribute(window_mma_kernel<NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    if (device < 64) attr_set[device] = true;
  }
  const dim3 blocks(W / kBC, H / kTR, static_cast<unsigned>(z));
  window_mma_kernel<NB><<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(feat),
      static_cast<const float2*>(grid), static_cast<__nv_bfloat16*>(out), H,
      W, C, my, mx, static_cast<unsigned long long*>(mma_count));
  return cudaGetLastError();
}

}  // namespace

// feat (B, H, W, C) bf16, grid (B, H, W, 2) f32, out (B, H, W, C) bf16, all
// contiguous; H % 8 == 0, W % 128 == 0, C % 8 == 0 (the caller checks shapes,
// contiguity and 16-byte alignment).  A block takes 8 * NB channels, NB the
// largest of 4, 2, 1 that divides C / 8 and lets one window row fit a ring
// chunk.  mma_count: a device unsigned long long that receives the MMAs
// issued, or null.  Returns a cudaError_t.
extern "C" int warp_window_launch(const void* feat, const void* grid,
                                  void* out, int B, int H, int W, int C,
                                  int my, int mx, void* mma_count, int device,
                                  void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H % kTR || W % kTC || C % 8 ||
      my < 0 || mx < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wc = min(W, kTC + 2 * mx);
  if (C % 32 == 0 && row_need(wc, 4) <= kChunkBytes) {
    err = launch<4>(feat, grid, out, B, H, W, C, my, mx, mma_count, s);
  } else if (C % 16 == 0 && row_need(wc, 2) <= kChunkBytes) {
    err = launch<2>(feat, grid, out, B, H, W, C, my, mx, mma_count, s);
  } else if (row_need(wc, 1) <= kChunkBytes) {
    err = launch<1>(feat, grid, out, B, H, W, C, my, mx, mma_count, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* warp_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
