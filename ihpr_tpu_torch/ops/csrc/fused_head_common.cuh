// Device helpers shared by the fused head kernels (K1 forward,
// fused_head_integral_fwd.cu; K2 backward, fused_head_integral_bwd.cu) and
// the conv + BN-statistics kernels (K5-K8, conv_bn_common.cuh): element
// traits, base-2 exp, cp.async, ldmatrix/mma.sync fragments and the warp
// matmul warp_mma of K5-K8, and the weight transpose of K1/K2 (bf16) and
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

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPad = 8;  // 16 bytes: conflict-free ldmatrix rows
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
  static constexpr int kPad = 4;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same four 8x8 matrices, each transposed on the way: thread t gets
// elements (2*(t%4), t/4) and (2*(t%4)+1, t/4) of matrix i, counting rows as
// the addresses given.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt][e] += A(16 x K) * B(K x 8*NT) in the mma.sync accumulator layout
// (row g + 8*(e >> 1), column nt*8 + 2*tig + (e & 1)), bf16 operands from
// shared memory. A(m, k) is a[m*lda + k], or a[k*lda + m] when A_T; B(k, n)
// is b[n*ldb + k], or b[k*ldb + n] when B_T. K is a multiple of 16; n-tile
// pairs at or past n_lim are skipped.
template <int NT, bool A_T, bool B_T>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb, int K, int n_lim,
                                         int lane) {
  // ldmatrix x4: lane groups of 8 address the rows of matrices 0-3.
  // A fragment: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15).
  // B fragment pair: (k 0-7 | 8-15) of n-tile 2np, then of n-tile 2np+1.
  const int mi = lane >> 3, rr = lane & 7;
  const __nv_bfloat16* a_ptr = A_T ? a + (rr + (mi >> 1) * 8) * lda + (mi & 1) * 8
                                   : a + (rr + (mi & 1) * 8) * lda + (mi >> 1) * 8;
  const __nv_bfloat16* b_ptr = B_T ? b + (rr + (mi & 1) * 8) * ldb + (mi >> 1) * 8
                                   : b + ((mi >> 1) * 8 + rr) * ldb + (mi & 1) * 8;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    if (A_T)
      ldmatrix_x4_trans(af, a_ptr + k0 * lda);
    else
      ldmatrix_x4(af, a_ptr + k0);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (np * 16 < n_lim) {
        uint32_t bf[4];
        if (B_T)
          ldmatrix_x4_trans(bf, b_ptr + k0 * ldb + np * 16);
        else
          ldmatrix_x4(bf, b_ptr + np * 16 * ldb + k0);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// fp32: the same contract with plain FMAs.
template <int NT, bool A_T, bool B_T>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a, int lda,
                                         const float* b, int ldb, int K, int n_lim, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a_lo = A_T ? a[k * lda + g] : a[g * lda + k];
    const float a_hi = A_T ? a[k * lda + g + 8] : a[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt * 8 < n_lim) {
        const int n = nt * 8 + 2 * tig;
        const float b0 = B_T ? b[k * ldb + n] : b[n * ldb + k];
        const float b1 = B_T ? b[k * ldb + n + 1] : b[(n + 1) * ldb + k];
        acc[nt][0] = fmaf(a_lo, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a_lo, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a_hi, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a_hi, b1, acc[nt][3]);
      }
    }
  }
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
