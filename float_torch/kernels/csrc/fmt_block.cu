// K9: the non-GEMM passes of an FMT block (DiT-style adaLN-zero), in f32
// arithmetic on f32, bf16 or f16 tensors (the sampler's dtype).  The
// block's five linears (adaLN, qkv, proj, fc1, fc2) stay cuBLAS products
// without their biases; each bias is added here, by the pass that reads
// that product's output.  Four modes, one launch each:
//
//   ln_mod           xm = LN(x) * (1 + (scale + bc)) + (shift + bh)
//   gate_res_ln_mod  x' = x + (gate + bg) * (y + by)          (written)
//                    xm = LN(x') * (1 + (scale + bc)) + (shift + bh)
//   attn             per (b, head): q, k, v = qkv + bqkv;
//                    softmax(q k^T / sqrt(hd) + bias) v, written in proj's
//                    (B, N, heads * hd) layout
//   bias_gelu        gelu_tanh(y + b)
//
// Every tensor but the attention's bias table (f32) is of one dtype T;
// values are widened to f32 as they are read and each output is rounded
// to T once.  LN is non-affine over a row of D values with f32 sums;
// gate, shift and scale are (B, N, D) slices of an adaLN product read
// through their row stride, each with its D-wide slice of that product's
// bias.  The residual and the modulation are rounded op by op in f32 in
// the plain version's order (no contraction into FMAs), so in f32 x'
// equals the plain ops bit for bit, and in bf16 or f16 the plain f32 ops
// on the same values rounded once; LN's mean and variance, the
// attention's dot products and sums and tanh round in other orders than
// PyTorch's kernels.  The attention reads the additive bias table (N, N)
// as given: a key at -1e9 gets exactly 0 weight, as in the plain softmax;
// nothing assumes the band.
//
// Plain version: float_torch/ops/fmt_block.py (ln_mod_ref,
// gate_res_ln_mod_ref, attn_ref, bias_gelu_ref), float_tpu's op sequence
// of models/fmt.py.  The kernel replaces no TPU kernel: float_tpu leaves
// these passes to XLA, which fuses them.  On the card they were some 25
// small PyTorch launches a block (bias adds, modulations, gates,
// residuals, LayerNorms, the attention's scaling, bias, softmax and the
// copies of transposed q, k, v around two batched products).
//
// What bounds it on an H100: neither bytes nor operations, but the fixed
// cost of a launch.  At config 1 (B = 3 CFG rows of N = 60 frames, D =
// 1024, 8 heads of 128, MLP 4096) every pass moves 0.7 to 6 MB, which
// sits in L2, in 1 to 2 us of bandwidth.  So the design is as few
// launches as the GEMMs between them allow (4 a block), each wide enough
// to reach many SMs: a row a block for the LN modes, 8 queries a block for
// the attention (B * heads alone gives 24 blocks, these 192), a thread an
// element for the GELU.  The ln modes and the GELU take 2 to 3 us a launch
// in a graph; the attention ~10 us, 8 % of its bound: each query reads its
// head's K and V from shared memory whole, ~9 wavefronts an SM cycle for a
// q.k step of a warp, so an SM with two blocks spends ~5 us of shared
// memory bandwidth (holding K for two queries a warp in registers would
// halve it).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRowThreads = 256;   // ln modes: one row a block
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kMaxWidth = 4 * kRowThreads;   // 4 values a thread
constexpr int kAttnWarps = 8;      // attn: a query a warp
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kStage = 8;          // attn: K and V 4-value loads in flight
constexpr int kEwThreads = 256;    // bias_gelu

// The dtype codes of the launchers (float_torch/kernels/fmt_block.py
// DTYPES).
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the T of ``dtype``.
template <typename F>
cudaError_t by_dtype(int dtype, F&& f) {
  switch (dtype) {
    case kF32: return f(Tag<float>{});
    case kBF16: return f(Tag<__nv_bfloat16>{});
    case kF16: return f(Tag<__half>{});
    default: return cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The sum of v over the block, in every thread; red holds kRowWarps floats
// and is free again when it returns.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// 4 values at p (4 * sizeof(T)-byte aligned), widened to f32.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 4 values to p, each rounded to T once.
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<unsigned*>(&a), *reinterpret_cast<unsigned*>(&b));
}

__device__ __forceinline__ void st4(__half* p, float4 v) {
  __half2 a = __floats2half2_rn(v.x, v.y);
  __half2 b = __floats2half2_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<unsigned*>(&a), *reinterpret_cast<unsigned*>(&b));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// x + g * y, each product and sum rounded (the plain ops' order)
__device__ __forceinline__ float4 gate_res(float4 x, float4 g, float4 y) {
  return make_float4(__fadd_rn(x.x, __fmul_rn(g.x, y.x)),
                     __fadd_rn(x.y, __fmul_rn(g.y, y.y)),
                     __fadd_rn(x.z, __fmul_rn(g.z, y.z)),
                     __fadd_rn(x.w, __fmul_rn(g.w, y.w)));
}

// n * (1 + c) + s, rounded op by op as the plain _modulate
__device__ __forceinline__ float modulate(float n, float c, float s) {
  return __fadd_rn(__fmul_rn(n, __fadd_rn(1.0f, c)), s);
}

// Block r takes row r, 4 values a thread.  kResid: x' = x + (gate + bg) *
// (y [+ by]) is written to xo and normalised; else x itself.  by may be
// null (the product already holds its bias).
template <typename T, bool kResid>
__global__ void __launch_bounds__(kRowThreads)
    ln_mod_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const T* __restrict__ by, const T* __restrict__ gate,
                  long long ldg, const T* __restrict__ bg,
                  const T* __restrict__ shift, long long ldh,
                  const T* __restrict__ bh, const T* __restrict__ scale,
                  long long ldc, const T* __restrict__ bc,
                  T* __restrict__ xo, T* __restrict__ mo, int D, float eps) {
  __shared__ float red[kRowWarps];
  const long long r = blockIdx.x;
  const int i = 4 * threadIdx.x;
  const bool in = i < D;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (in) {
    v = ld4(x + r * D + i);
    if (kResid) {
      float4 yy = ld4(y + r * D + i);
      if (by != nullptr) yy = add4(yy, ld4(by + i));
      const float4 g = add4(ld4(gate + r * ldg + i), ld4(bg + i));
      v = gate_res(v, g, yy);
      st4(xo + r * D + i, v);
    }
  }
  const float mean = block_sum((v.x + v.y) + (v.z + v.w), red) / D;
  const float a = v.x - mean, b = v.y - mean, c = v.z - mean,
              e = v.w - mean;
  const float q = in ? (a * a + b * b) + (c * c + e * e) : 0.0f;
  const float rstd = rsqrtf(block_sum(q, red) / D + eps);
  if (in) {
    const float4 sc = add4(ld4(scale + r * ldc + i), ld4(bc + i));
    const float4 sh = add4(ld4(shift + r * ldh + i), ld4(bh + i));
    st4(mo + r * D + i, make_float4(modulate(a * rstd, sc.x, sh.x),
                                    modulate(b * rstd, sc.y, sh.y),
                                    modulate(c * rstd, sc.z, sh.z),
                                    modulate(e * rstd, sc.w, sh.w)));
  }
}

// Dynamic shared memory of an attn block: K (rows padded to hd + 4) and V
// of the head, and a query and N probabilities for each warp, in f32.
long long attn_smem_bytes(int N, int hd) {
  return 4LL * (static_cast<long long>(N) * (2 * hd + 4) +
                kAttnWarps * (hd + N));
}

// Block (tile, head, b) takes queries [tile * kAttnWarps, (tile + 1) *
// kAttnWarps) of head h of row b, a query a warp.  K (rows padded to hd + 4
// floats: a quarter warp's 16-byte reads of 8 keys fall in distinct banks)
// and V of the head, bias added, are staged in shared memory in f32 once,
// each thread's loads issued kStage pairs at a time (one at a time, the L2
// latency of each was the kernel's time); then each warp's lanes split the
// keys for the logits, two keys a lane at once, the warp reduces the
// softmax's max and sum, and its lanes split hd for p v.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    attn_kernel(const T* __restrict__ qkv, const T* __restrict__ bq,
                const float* __restrict__ bias, T* __restrict__ out, int N,
                int H, int hd, float inv_sqrt) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int kp = hd + 4;
  float* ks = sm;                       // N x kp
  float* vs = ks + N * kp;              // N x hd
  float* qs = vs + N * hd;              // kAttnWarps x hd
  float* ps = qs + kAttnWarps * hd;     // kAttnWarps x N
  const int h = blockIdx.y, b = blockIdx.z;
  const int hd4 = hd / 4, n4 = N * hd4;
  const long long row = 3LL * H * hd;   // a frame's q, k, v of every head
  const T* base = qkv + static_cast<long long>(b) * N * row + h * hd;
  const T* kb = bq + H * hd + h * hd;
  const T* vb = bq + 2 * H * hd + h * hd;
  for (int e0 = threadIdx.x; e0 < n4; e0 += kStage * kAttnThreads) {
    float4 k[kStage], v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = e0 + u * kAttnThreads;
      if (e < n4) {
        const int j = e / hd4, d = 4 * (e - j * hd4);
        k[u] = ld4(base + j * row + H * hd + d);
        v[u] = ld4(base + j * row + 2 * H * hd + d);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = e0 + u * kAttnThreads;
      if (e < n4) {
        const int j = e / hd4, d = 4 * (e - j * hd4);
        *reinterpret_cast<float4*>(ks + j * kp + d) = add4(k[u], ld4(kb + d));
        *reinterpret_cast<float4*>(vs + j * hd + d) = add4(v[u], ld4(vb + d));
      }
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = static_cast<int>(blockIdx.x) * kAttnWarps + warp;
  if (i >= N) return;
  float* q = qs + warp * hd;
  float* p = ps + warp * N;
  for (int d = 4 * lane; d < hd; d += 128) {
    *reinterpret_cast<float4*>(q + d) =
        add4(ld4(base + i * row + d), ld4(bq + h * hd + d));
  }
  __syncwarp();
  float m = -INFINITY;
  for (int j0 = lane; j0 < N; j0 += 64) {
    const int j1 = j0 + 32;
    const float* k0 = ks + j0 * kp;
    const float* k1 = ks + min(j1, N - 1) * kp;
    float d0 = 0.0f, d1 = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(q + d);
      const float4 c = *reinterpret_cast<const float4*>(k0 + d);
      const float4 e = *reinterpret_cast<const float4*>(k1 + d);
      d0 += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
      d1 += a.x * e.x + a.y * e.y + a.z * e.z + a.w * e.w;
    }
    const float s0 = __fadd_rn(__fmul_rn(d0, inv_sqrt), bias[i * N + j0]);
    p[j0] = s0;
    m = fmaxf(m, s0);
    if (j1 < N) {
      const float s1 = __fadd_rn(__fmul_rn(d1, inv_sqrt), bias[i * N + j1]);
      p[j1] = s1;
      m = fmaxf(m, s1);
    }
  }
  m = warp_max(m);
  float sum = 0.0f;
  for (int j = lane; j < N; j += 32) {
    const float e = expf(p[j] - m);
    p[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < N; j += 32) p[j] = p[j] / sum;
  __syncwarp();
  for (int d = 4 * lane; d < hd; d += 128) {
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int j = 0; j < N; ++j) {
      const float w = p[j];
      const float4 c = *reinterpret_cast<const float4*>(vs + j * hd + d);
      o.x += w * c.x;
      o.y += w * c.y;
      o.z += w * c.z;
      o.w += w * c.w;
    }
    st4(out + (static_cast<long long>(b) * N + i) * H * hd + h * hd + d, o);
  }
}

// PyTorch's tanh GELU (GeluCUDAKernelImpl), in f32: 0.5 x (1 + tanh(
// sqrt(2 / pi) (x + 0.044715 x^3))).
template <typename T>
__global__ void __launch_bounds__(kEwThreads)
    bias_gelu_kernel(const T* __restrict__ y, const T* __restrict__ b,
                     T* __restrict__ out, long long n, int F) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kEwThreads + threadIdx.x;
  if (t >= n) return;
  constexpr float kBeta = 0.7978845608028654f;   // sqrt(2 / pi)
  constexpr float kKappa = 0.044715f;
  const float x = __fadd_rn(to_f32(y[t]), to_f32(b[t % F]));
  const float inner = kBeta * (x + kKappa * (x * x * x));
  out[t] = from_f32<T>(0.5f * x * (1.0f + tanhf(inner)));
}

// p holds 4 values of an element of ``bytes`` bytes at an aligned address
bool aligned4(const void* p, int bytes) {
  return (reinterpret_cast<unsigned long long>(p) % (4ull * bytes)) == 0;
}

}  // namespace

// The ln modes.  dtype: 0 f32, 1 bf16, 2 f16, of every tensor.  x, xo, mo
// (rows, D) contiguous; y (rows, D) contiguous or null (ln_mod: no
// residual, gate and xo unread); by (D,) or null; gate, shift, scale: row
// r at ptr + r * ld, D contiguous values; bg, bh, bc (D,).  D % 4 == 0,
// D <= 1024, every pointer aligned to 4 values and every ld a multiple of
// 4.  Returns a cudaError_t: cudaErrorInvalidValue for a size, dtype or
// pointer out of these bounds.
extern "C" int fmt_ln_mod_launch(const void* x, const void* y,
                                 const void* by, const void* gate,
                                 long long ldg, const void* bg,
                                 const void* shift, long long ldh,
                                 const void* bh, const void* scale,
                                 long long ldc, const void* bc, void* xo,
                                 void* mo, int rows, int D, float eps,
                                 int dtype, int device, void* stream) {
  const bool resid = y != nullptr;
  return static_cast<int>(by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const int s = sizeof(T);
    if (rows < 0 || D <= 0 || D % 4 || D > kMaxWidth || ldh % 4 ||
        ldc % 4 || !aligned4(x, s) || !aligned4(mo, s) ||
        !aligned4(shift, s) || !aligned4(scale, s) || !aligned4(bh, s) ||
        !aligned4(bc, s) ||
        (resid && (gate == nullptr || bg == nullptr || xo == nullptr ||
                   ldg % 4 || !aligned4(y, s) || !aligned4(gate, s) ||
                   !aligned4(bg, s) || !aligned4(xo, s) ||
                   (by != nullptr && !aligned4(by, s))))) {
      return cudaErrorInvalidValue;
    }
    if (rows == 0) return cudaSuccess;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const auto c = [](const void* p) { return static_cast<const T*>(p); };
    const auto w = [](void* p) { return static_cast<T*>(p); };
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (resid) {
      ln_mod_kernel<T, true><<<rows, kRowThreads, 0, st>>>(
          c(x), c(y), c(by), c(gate), ldg, c(bg), c(shift), ldh, c(bh),
          c(scale), ldc, c(bc), w(xo), w(mo), D, eps);
    } else {
      ln_mod_kernel<T, false><<<rows, kRowThreads, 0, st>>>(
          c(x), nullptr, nullptr, nullptr, 0, nullptr, c(shift), ldh, c(bh),
          c(scale), ldc, c(bc), nullptr, w(mo), D, eps);
    }
    return cudaGetLastError();
  }));
}

// attn.  dtype as above, of qkv, bq and out; bias (N, N) f32.  qkv (B, N,
// 3, H, hd) contiguous, bq (3 * H * hd,), out (B, N, H * hd).  hd % 4 ==
// 0, pointers aligned to 4 values.  A head's K and V and the warps'
// queries and probabilities (attn_smem_bytes) over the device's opt-in
// shared memory a block: cudaErrorInvalidConfiguration.
extern "C" int fmt_attn_launch(const void* qkv, const void* bq,
                               const float* bias, void* out, int B, int N,
                               int H, int hd, float inv_sqrt, int dtype,
                               int device, void* stream) {
  return static_cast<int>(by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const int s = sizeof(T);
    if (B < 0 || N <= 0 || H <= 0 || hd <= 0 || hd % 4 ||
        !aligned4(qkv, s) || !aligned4(bq, s) || !aligned4(out, s)) {
      return cudaErrorInvalidValue;
    }
    if (B == 0) return cudaSuccess;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const long long smem = attn_smem_bytes(N, hd);
    int limit = 0;
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    if (smem > limit) return cudaErrorInvalidConfiguration;
    // each dtype's kernel's limit raised to the device's once, at the
    // device's first launch above 48 KB (a graph's eager run precedes its
    // capture)
    static bool raised[64] = {};
    if (smem > 48 * 1024 && (device >= 64 || !raised[device])) {
      err = cudaFuncSetAttribute(attn_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limit);
      if (err != cudaSuccess) return err;
      if (device < 64) raised[device] = true;
    }
    const dim3 grid((N + kAttnWarps - 1) / kAttnWarps, H, B);
    attn_kernel<T><<<grid, kAttnThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(qkv), static_cast<const T*>(bq), bias,
        static_cast<T*>(out), N, H, hd, inv_sqrt);
    return cudaGetLastError();
  }));
}

// bias_gelu.  dtype as above.  y, out (n / F, F) contiguous, b (F,).
extern "C" int fmt_bias_gelu_launch(const void* y, const void* b, void* out,
                                    long long n, int F, int dtype,
                                    int device, void* stream) {
  return static_cast<int>(by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (n < 0 || F <= 0 || n % F) return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    const long long blocks = (n + kEwThreads - 1) / kEwThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    bias_gelu_kernel<T><<<static_cast<unsigned int>(blocks), kEwThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(y), static_cast<const T*>(b),
        static_cast<T*>(out), n, F);
    return cudaGetLastError();
  }));
}

extern "C" const char* fmt_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
