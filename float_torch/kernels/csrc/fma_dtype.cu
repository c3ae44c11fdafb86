// K6: a dependent chain of multiply-adds per element, the ALU-rate probe.
//
//   x (N,) in dtype T (f32 or bf16), k (n_ops,) f32 holding constants
//   already rounded to the accumulator's type A:
//     acc = A(x); for i < n_ops: acc = acc + x * k[i]  (x taken as A);
//     out = T(acc)
//   kind 0: T = f32,  A = f32;  kind 1: T = bf16, A = f32;
//   kind 2: T = bf16, A = bf16.
//
// Replaces the TPU kernel experiments/vpu_dtype_bench.py::make.<locals>.kern
// (launched by make's run), which asked whether the v5e's VPU runs packed
// bf16 arithmetic faster than f32; this kernel asks the same of Hopper's
// CUDA cores.  Every multiply and every add is rounded on its own, as on the
// TPU: f32 through __fmul_rn / __fadd_rn (nvcc's default -fmad=true would
// otherwise contract acc + x * k into one FMA, which rounds once); bf16
// through the packed __nv_bfloat162 intrinsics __hmul2_rn / __hadd2_rn
// (never contracted), two elements an instruction.
//
// What bounds it on an H100 at the probe's 2^25 elements: at 64 steps the
// f32 chain sits near the ridge (0.080 ms of HBM bytes vs 0.064 ms of f32
// operations at 67 TFLOP/s, an FMA counted as 2 while this chain issues a
// multiply and an add), the bf16 chains read and write half the bytes; at
// 1024 steps every variant is bound by its operations.  Design: each thread
// takes 8 elements (one or two 16-byte vectors), 8 independent f32 chains
// or 4 packed bf16 chains, so the ALUs see 4-8 independent instructions per
// step; the constants sit in shared memory, read as broadcasts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOps = 4096;
constexpr int kPerThread = 8;

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

// f32 accumulator: T = float (kind 0) or __nv_bfloat16 (kind 1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    chain_f32_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const float* __restrict__ k, int n_ops, long long n8) {
  __shared__ float s_k[kMaxOps];
  for (int i = threadIdx.x; i < n_ops; i += kThreads) s_k[i] = k[i];
  __syncthreads();
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= n8) return;
  float v[kPerThread], acc[kPerThread];
  load8(x + t * kPerThread, v);
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc[e] = v[e];
#pragma unroll 4
  for (int i = 0; i < n_ops; ++i) {
    const float kk = s_k[i];
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      acc[e] = __fadd_rn(acc[e], __fmul_rn(v[e], kk));
    }
  }
  store8(out + t * kPerThread, acc);
}

// bf16 accumulator (kind 2): 4 packed chains of 2 elements each.
__global__ void __launch_bounds__(kThreads)
    chain_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      __nv_bfloat16* __restrict__ out,
                      const float* __restrict__ k, int n_ops, long long n8) {
  __shared__ __nv_bfloat162 s_k[kMaxOps];
  for (int i = threadIdx.x; i < n_ops; i += kThreads) {
    s_k[i] = __bfloat162bfloat162(__float2bfloat16_rn(k[i]));
  }
  __syncthreads();
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= n8) return;
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(x + t * kPerThread));
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&q);
  __nv_bfloat162 acc[4] = {v[0], v[1], v[2], v[3]};
  const __nv_bfloat162 xv[4] = {v[0], v[1], v[2], v[3]};
#pragma unroll 4
  for (int i = 0; i < n_ops; ++i) {
    const __nv_bfloat162 kk = s_k[i];
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = __hadd2_rn(acc[e], __hmul2_rn(xv[e], kk));
  }
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = acc[e];
  *reinterpret_cast<uint4*>(out + t * kPerThread) = r;
}

}  // namespace

// x, out: n elements (n % 8 == 0, 16-byte aligned) of the kind's T; k:
// n_ops f32 constants (0 <= n_ops <= 4096) on the device.  Returns a
// cudaError_t.
extern "C" int fma_dtype_launch(const void* x, void* out, const void* k,
                                long long n, int n_ops, int kind, int device,
                                void* stream) {
  if (n < 0 || n % kPerThread || n_ops < 0 || n_ops > kMaxOps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n8 = n / kPerThread;
  if (n8 == 0) return cudaSuccess;
  const long long blocks = (n8 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kk = static_cast<const float*>(k);
  const unsigned g = static_cast<unsigned>(blocks);
  if (kind == 0) {
    chain_f32_kernel<float><<<g, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), kk, n_ops,
        n8);
  } else if (kind == 1) {
    chain_f32_kernel<__nv_bfloat16><<<g, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), kk, n_ops, n8);
  } else if (kind == 2) {
    chain_bf16_kernel<<<g, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), kk, n_ops, n8);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fma_dtype_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
