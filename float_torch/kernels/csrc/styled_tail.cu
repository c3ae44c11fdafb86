// K7: the decode's StyledConv tails and skip upsamplings, each one pass
// over channels_last (NHWC) maps, bf16 or f32, summed in f32 and rounded
// once.  Three modes:
//
//   up tail     x (B, Ho + 1, Wo + 1, C), the stride-2 transposed 3x3
//               conv's output, demod (B, C) f32, bias (C):
//                 out = lrelu(demod * fir(x) + bias) * sqrt(2)
//               fir: zero pad (1, 1), then the 4x4 blur of (1, 3, 3, 1)
//               with the up-2 gain, i.e. the outer product of (1, 3, 3, 1)
//               / 4 per axis; out (B, Ho, Wo, C);
//   plain tail  x (B, Ho, Wo, C): out = lrelu(demod * x + bias) * sqrt(2);
//   either tail may end in the next convolution's modulation: out times
//               scale (B, C), or (the plain tail) out2 = out times scale2
//               (B, C) beside out, both in x's dtype: the input of the
//               convolution that reads it, already modulated;
//   skip        x (B, Ho, Wo, C) (a level's RGB or flow output), skip
//               (B, Ho / 2, Wo / 2, C):
//                 out = act(x) + bias + up2(skip)
//               act(x) = lrelu(x + act_bias) * sqrt(2) with act_bias, else
//               x; up2 the polyphase form of upfirdn2d(up=2, pad=(2, 1))
//               with the same taps: each output pixel reads 2x2 skip
//               pixels, weights (1/4, 3/4) per axis.
//   lrelu(v) = v >= 0 ? v : 0.2 v (NaN stays NaN).
//
// Plain versions: float_torch/ops/tails.py styled_tail_ref (demod
// multiply, upfirdn2d, fused_leaky_relu; then the modulation x * s that
// float_torch/ops/modulated.py modulate runs) and skip_tail_ref
// (fused_leaky_relu, bias add, upsample2x, add).  The kernel replaces no
// TPU kernel: float_tpu leaves these ops to XLA, which fuses them.  On the
// card they were cuDNN's grouped depthwise blur, the layout transforms
// cuDNN wraps around it at C = 32 and 64, a pad copy and five to seven
// elementwise passes, each over the whole map.
//
// What bounds it on an H100: bytes.  Each mode reads x once and writes
// out once (skip and the (B, C) vectors are small): at 512^2 x 32, B = 24,
// bf16, 0.806 GB for the up tail, 0.241 ms at 3.35 TB/s.  About 1.2 f32
// operations a byte.  So the design moves each byte once and keeps the
// intermediates in registers:
//   - a pixel's C channels go to G = C / N neighbouring threads, one
//     16-byte vector each (N = 8 bf16, 4 f32), where C % N == 0 and the
//     maps are 16-byte aligned, else one channel a thread (Scalar): a
//     warp's loads and stores cover whole sectors;
//   - a thread walks kRows output rows down one column: the up tail sums
//     each input row's four columns (the horizontal taps) once into a
//     ring of four row sums and takes the vertical taps from the ring; the
//     horizontal neighbours a thread loads are its warp's own vectors,
//     served by L1;
//   - the up tail asks L2 for its column kPrefetch rows ahead
//     (prefetch.global.L2), so its own loads wait on L2 and not on device
//     memory: four 16-byte loads a row a thread, three of them L1 hits,
//     kept the bytes in flight too few to cover device memory's latency.
//     On an NVIDIA H100 80GB HBM3 (700 W), B = 24 bf16, the up tail at
//     512^2 x 32 took 0.411 ms without it (58.6 % of its bound), 0.364 ms
//     (66.3 %) 3 rows ahead, 0.395 ms 6 rows ahead; 16 or 32 rows a
//     thread, or the input rows staged in shared memory by cp.async
//     behind a barrier a row (106 registers, two blocks an SM), were
//     slower;
//   - demod, bias and the scales are read once a thread; a scaled output
//     costs no more bytes than an unscaled one, and out2 one map written.
//     The output's scale is folded into demod and bias (lrelu_signed),
//     and each epilogue is a form of its own (Epilogue);
//   - the skip mode, 3 channels, one element a thread.

#include "warp_common.cuh"

namespace {

using warp::kThreads;
using warp::Scalar;
using warp::Vec;
using warp::widen;

using bf16 = __nv_bfloat16;

constexpr int kRows = 8;      // output rows a thread walks
constexpr int kPrefetch = 3;  // rows ahead the up tail prefetches into L2

// sqrt(2) and 0.2 as the plain version's f32 opmath takes them
constexpr float kGain = 1.41421356237309515f;
constexpr float kSlope = 0.2f;

// Tap i of (1, 3, 3, 1) normalised per axis with the up-2 gain: the 2-D
// blur is tap(i) * tap(j), exact in f32.
__device__ __forceinline__ float tap(int i) {
  return i == 0 || i == 3 ? 0.25f : 0.75f;
}

__device__ __forceinline__ float lrelu(float v) {
  return (v >= 0.0f ? v : v * kSlope) * kGain;
}

// lrelu(u) * s = sign(s) * max(w, 0.2 w), w = u * |s| * sqrt(2): leaky
// ReLU is positively homogeneous.  So a scale folds into the demodulation
// and bias (w), its sign is one bit a channel (sign: channel i's at bit
// 31 - i), and the product costs two operations, no more than lrelu's.
__device__ __forceinline__ float lrelu_signed(float w, unsigned sign,
                                              int i) {
  return __uint_as_float(__float_as_uint(fmaxf(w, w * kSlope)) ^
                         ((sign << i) & 0x80000000u));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// A tail's epilogue: none; its output times scale (folded into the
// demodulation and bias, lrelu_signed); or out2 = its output times scale2
// beside it.  A template argument, so each form holds only its own
// registers: the up tail without an epilogue holds 64 a thread (four
// blocks an SM) and slows by a quarter at a fifth of its registers more.
enum Epilogue { kNone, kScale, kOut2 };

// Block (x, y, b): threads x * kThreads + threadIdx.x of frame b, output
// rows [y * kRows, y * kRows + kRows); thread t takes vector g = t % G of
// column t / G, G = C / L::N.  The up tail keeps to four blocks an SM.
template <typename T, typename L, bool UP, Epilogue EPI>
__global__ void __launch_bounds__(kThreads, UP ? 4 : 1)
    tail_kernel(const T* __restrict__ x, const float* __restrict__ demod,
                const T* __restrict__ bias, const T* __restrict__ scale,
                const T* __restrict__ scale2, T* __restrict__ out2,
                T* __restrict__ out, int Ho, int Wo, int C) {
  constexpr int V = L::N;
  const int G = C / V;
  const int t = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= Wo * G) return;
  const int xo = t / G;
  const int c0 = (t - xo * G) * V;
  const int b = blockIdx.z;
  const int y0 = static_cast<int>(blockIdx.y) * kRows;
  const int Hi = UP ? Ho + 1 : Ho;
  const int Wi = UP ? Wo + 1 : Wo;
  const long long row_in = static_cast<long long>(Wi) * C;
  const long long row_out = static_cast<long long>(Wo) * C;
  const T* src = x + static_cast<long long>(b) * Hi * row_in + c0;
  T* dst = out + static_cast<long long>(b) * Ho * row_out +
           static_cast<long long>(xo) * C + c0;

  // kScale: |scale| * sqrt(2) folded into dm and bs, its signs in sign
  float dm[V], bs[V];
  unsigned sign = 0;
  const long long bc = static_cast<long long>(b) * C + c0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    dm[i] = demod[bc + i];
    bs[i] = widen(bias[c0 + i]);
    if constexpr (EPI == kScale) {
      const float sc = widen(scale[bc + i]);
      const float a = fabsf(sc) * kGain;
      dm[i] *= a;
      bs[i] *= a;
      sign |= (__float_as_uint(sc) & 0x80000000u) >> i;
    }
  }
  auto act = [&](float v, int i) {
    return EPI == kScale ? lrelu_signed(v, sign, i) : lrelu(v);
  };

  if constexpr (!UP) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int y = y0 + r;
      if (y < Ho) {
        float v[V];
        L::load(src + y * row_in + static_cast<long long>(xo) * C, v);
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = act(v[i] * dm[i] + bs[i], i);
        L::store(dst + y * row_out, v);
        if constexpr (EPI == kOut2) {
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] *= widen(scale2[bc + i]);
          L::store(out2 + (dst - out) + y * row_out, v);
        }
      }
    }
  } else {
    // h[r % 4]: input row y0 - 1 + r summed over its four columns
    float h[4][V];
#pragma unroll
    for (int r = 0; r < kRows + 3; ++r) {
      const int yi = y0 - 1 + r;
      float* hr = h[r % 4];
#pragma unroll
      for (int i = 0; i < V; ++i) hr[i] = 0.0f;
      if (yi + kPrefetch >= 0 && yi + kPrefetch < Hi) {
        prefetch_l2(src + (yi + kPrefetch) * row_in +
                    static_cast<long long>(xo) * C);
      }
      if (yi >= 0 && yi < Hi) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int xi = xo - 1 + j;
          if (xi >= 0 && xi < Wi) {
            float v[V];
            L::load(src + yi * row_in + static_cast<long long>(xi) * C, v);
#pragma unroll
            for (int i = 0; i < V; ++i) hr[i] += tap(j) * v[i];
          }
        }
      }
      const int yo = y0 + r - 3;
      if (r >= 3 && yo < Ho) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float s = tap(0) * h[(r + 1) % 4][i] +
                          tap(1) * h[(r + 2) % 4][i] +
                          tap(2) * h[(r + 3) % 4][i] + tap(3) * hr[i];
          o[i] = act(s * dm[i] + bs[i], i);
        }
        L::store(dst + yo * row_out, o);
      }
    }
  }
}

// One output element a thread: t = ((b * Ho + y) * Wo + x) * C + c.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    skip_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                const T* __restrict__ act_bias, const T* __restrict__ bias,
                T* __restrict__ out, int Ho, int Wo, int C, long long n) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;
  const int c = static_cast<int>(t % C);
  long long p = t / C;
  const int xo = static_cast<int>(p % Wo);
  p /= Wo;
  const int yo = static_cast<int>(p % Ho);
  const long long b = p / Ho;

  float v = widen(x[t]);
  if (act_bias != nullptr) v = lrelu(v + widen(act_bias[c]));
  v += widen(bias[c]);

  // output row 2a takes skip rows a - 1, a (1/4, 3/4); row 2a + 1 rows
  // a, a + 1 (3/4, 1/4); the same across
  const int Hs = Ho / 2, Ws = Wo / 2;
  const int ys = (yo >> 1) - 1 + (yo & 1);
  const int xs = (xo >> 1) - 1 + (xo & 1);
  const T* s = skip + b * Hs * Ws * C + c;
  float up = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int iy = ys + dy;
    if (iy < 0 || iy >= Hs) continue;
    const float wy = tap(2 * dy + (yo & 1));
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int ix = xs + dx;
      if (ix < 0 || ix >= Ws) continue;
      up += (wy * tap(2 * dx + (xo & 1))) *
            widen(s[(static_cast<long long>(iy) * Ws + ix) * C]);
    }
  }
  out[t] = Vec<T>::from_float(v + up);
}

template <typename T, typename L>
cudaError_t launch_tail(const void* x, const void* demod, const void* bias,
                        const void* scale, const void* scale2, void* out2,
                        void* out, int B, int Ho, int Wo, int C, bool up,
                        cudaStream_t stream) {
  const long long n = static_cast<long long>(Wo) * (C / L::N);
  const int row_blocks = (Ho + kRows - 1) / kRows;
  if (n > 0x7fffffffLL || B > 65535 || row_blocks > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  const dim3 blocks(static_cast<unsigned int>((n + kThreads - 1) / kThreads),
                    row_blocks, B);
  const T* xp = static_cast<const T*>(x);
  const float* dp = static_cast<const float*>(demod);
  const T* bp = static_cast<const T*>(bias);
  const T* sp = static_cast<const T*>(scale);
  const T* s2p = static_cast<const T*>(scale2);
  T* o2p = static_cast<T*>(out2);
  T* op = static_cast<T*>(out);
  const Epilogue epi = out2 != nullptr ? kOut2 : scale != nullptr ? kScale
                                                                   : kNone;
#define K7_TAIL(UP_, EPI_)                                                 \
  tail_kernel<T, L, UP_, EPI_><<<blocks, kThreads, 0, stream>>>(           \
      xp, dp, bp, sp, s2p, o2p, op, Ho, Wo, C)
  if (up) {
    if (epi == kScale) {
      K7_TAIL(true, kScale);
    } else {
      K7_TAIL(true, kNone);
    }
  } else if (epi == kScale) {
    K7_TAIL(false, kScale);
  } else if (epi == kOut2) {
    K7_TAIL(false, kOut2);
  } else {
    K7_TAIL(false, kNone);
  }
#undef K7_TAIL
  return cudaGetLastError();
}

template <typename T>
cudaError_t tail(const void* x, const void* demod, const void* bias,
                 const void* scale, const void* scale2, void* out2, void* out,
                 int B, int Ho, int Wo, int C, bool up, cudaStream_t stream) {
  if (C % Vec<T>::N == 0 && aligned16(x) && aligned16(out) &&
      (out2 == nullptr || aligned16(out2))) {
    return launch_tail<T, Vec<T>>(x, demod, bias, scale, scale2, out2, out,
                                  B, Ho, Wo, C, up, stream);
  }
  return launch_tail<T, Scalar<T>>(x, demod, bias, scale, scale2, out2, out,
                                   B, Ho, Wo, C, up, stream);
}

template <typename T>
cudaError_t skip_up(const void* x, const void* skip, const void* act_bias,
                    const void* bias, void* out, int B, int Ho, int Wo,
                    int C, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * Ho * Wo * C;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  skip_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(skip),
      static_cast<const T*>(act_bias), static_cast<const T*>(bias),
      static_cast<T*>(out), Ho, Wo, C, n);
  return cudaGetLastError();
}

}  // namespace

// The up or plain tail (up 1 or 0): x (B, Ho + up, Wo + up, C), demod
// (B, C) f32, bias (C), scale (B, C) or null, out (B, Ho, Wo, C); on the
// plain tail without scale, out2 (B, Ho, Wo, C) with its scale2 (B, C), or
// both null; x, bias, the scales and outputs of dtype 0 bf16, 1 f32.  The
// caller checks shapes, dtypes, devices and contiguity.  Returns a
// cudaError_t:
// cudaErrorInvalidValue for a negative size, an unknown dtype or an out2
// without its scale2, beside a scale or on the up tail,
// cudaErrorInvalidConfiguration for a grid too large.
extern "C" int styled_tail_launch(const void* x, const void* demod,
                                  const void* bias, const void* scale,
                                  const void* scale2, void* out2, void* out,
                                  int B, int Ho, int Wo, int C, int up,
                                  int dtype, int device, void* stream) {
  if (B < 0 || Ho < 0 || Wo < 0 || C < 0 || (dtype != 0 && dtype != 1) ||
      (out2 != nullptr &&
       (scale2 == nullptr || scale != nullptr || up != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Ho == 0 || Wo == 0 || C == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? tail<bf16>(x, demod, bias, scale, scale2, out2, out, B, Ho, Wo,
                         C, up != 0, s)
            : tail<float>(x, demod, bias, scale, scale2, out2, out, B, Ho, Wo,
                          C, up != 0, s);
  return static_cast<int>(err);
}

// The skip mode: x and out (B, Ho, Wo, C), skip (B, Ho / 2, Wo / 2, C),
// bias (C), act_bias (C) or null; Ho and Wo even.
extern "C" int skip_tail_launch(const void* x, const void* skip,
                                const void* act_bias, const void* bias,
                                void* out, int B, int Ho, int Wo, int C,
                                int dtype, int device, void* stream) {
  if (B < 0 || Ho < 0 || Wo < 0 || C < 0 || Ho % 2 || Wo % 2 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Ho == 0 || Wo == 0 || C == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? skip_up<bf16>(x, skip, act_bias, bias, out, B, Ho, Wo, C, s)
            : skip_up<float>(x, skip, act_bias, bias, out, B, Ho, Wo, C, s);
  return static_cast<int>(err);
}

extern "C" const char* styled_tail_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
