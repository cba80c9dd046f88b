// Device helpers shared by the fused head kernels (K1 forward,
// fused_head_integral_fwd.cu; K2 backward, fused_head_integral_bwd.cu), the
// integral kernels K3/K4 and the bf16 K7/K8 epilogue (conv3_hopper.cuh):
// element traits, base-2 exp, and the weight transpose of K1/K2 (bf16) and
// their fp32 instances (fused_head_integral_fwd_f32.cu, _bwd_f32.cu). K1/K2's
// wgmma/TMA machinery is in hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fhi {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// The fused head kernels' mode argument (ops/fused_head_integral.py): bit 0
// IHPR_EXP2 (W and b come scaled by log2 e: the logits are base 2 as they
// are), bit 1 IHPR_BEXP (the backward's exp argument and result rounded to
// bf16).
// How each kernel takes it: K1-fp32, K2 and K2-fp32 are templated on the
// base (the K2s on BEXP too), so their natural instance keeps log2 e as a
// constant; with the base as a runtime scale they timed 1.5-2% slower on
// the H100 (PERF.md section 6). K1 takes the scale and m's unscale as
// runtime arguments: there the runtime scale timed within the spread of
// the constant's, so it keeps one instance.
constexpr int kModeExp2 = 1;
constexpr int kModeBexp = 2;

// x rounded to bf16 (nearest even) and back: IHPR_BEXP's roundings.
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 zero() { return __float2bfloat16(0.f); }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) { return __float2bfloat16(v); }
  // Two adjacent elements (p 4-byte aligned), rounded to nearest even.
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Elem<float> {
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The backward's p = exp(a) of a logit's offset a = v - (m + log s), from
// a in natural units times scale (log2 e; 1 for IHPR_EXP2's base-2
// logits). BEXP (IHPR_BEXP): a and p rounded to bf16.
template <bool BEXP>
__device__ __forceinline__ float dv_exp(float a, float scale) {
  if (BEXP) return round_bf16(ex2(round_bf16(a) * scale));
  return ex2(a * scale);
}

// W (C, JD) -> Wt (JD, C), bf16 or fp32: a joint's D columns of the final
// conv become D rows whose pitch (C elements) TMA or cp.async can copy,
// whatever J*D is. Blocks of 32x8 threads over 32x32 tiles.
template <typename T>
__global__ void transpose_kernel(const T* __restrict__ w, T* __restrict__ wt, int C, int JD) {
  __shared__ __align__(4) unsigned char raw[32 * 33 * sizeof(T)];
  T* tile = reinterpret_cast<T*>(raw);  // [32][33]
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    if (k < C && n < JD) tile[i * 33 + threadIdx.x] = w[(size_t)k * JD + n];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (n < JD && k < C) wt[(size_t)n * C + k] = tile[threadIdx.x * 33 + i];
  }
}

template <typename T>
inline cudaError_t transpose(const T* w, T* wt, int C, int JD, cudaStream_t stream) {
  transpose_kernel<T><<<dim3((JD + 31) / 32, (C + 31) / 32), dim3(32, 8), 0, stream>>>(w, wt, C, JD);
  return cudaGetLastError();
}

}  // namespace fhi
