// Self-test of tf32x3.cuh, the 3xTF32 split and product of the fused
// head's fp32 kernels, and the rates of the tensor cores' TF32 paths
// (mma.sync beside wgmma). Replaces no TPU kernel: it exists so that a wrong
// fragment layout or split shows as a failed test of one tile, not as
// slightly-off coordinates. tests/test_torch_kernels.py (-k tf32x3) holds
// its results against float64 on the host; chip_smoke.py prints the rates.

#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

// hi, the exact fp32 remainder x - hi, and lo of each x; rna = x rounded
// by cvt.rna.tf32.f32, which to_tf32 must equal bitwise.
__global__ void split_kernel(const float* __restrict__ x, float* __restrict__ hi, float* __restrict__ rem,
                             float* __restrict__ lo, float* __restrict__ rna, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    uint32_t h, l, r;
    split(x[i], h, l);
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x[i]));
    hi[i] = __uint_as_float(h);
    rem[i] = x[i] - __uint_as_float(h);
    lo[i] = __uint_as_float(l);
    rna[i] = __uint_as_float(r);
  }
}

// One warp: D (16 x 8) = A (16 x K, row-major) B (K x 8, row-major) by
// 3xTF32 over K / 8 k-steps; then E (16 x 8) = D B2 (B2: 8 x 8) with D
// turned into the A fragment in registers (as_a), the path K2-fp32's
// contractions over dv take.
__global__ void product_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               const float* __restrict__ b2, float* __restrict__ d_out,
                               float* __restrict__ e_out, int K) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  float d[1][1][4] = {{{0.f, 0.f, 0.f, 0.f}}};
  uint32_t ah[1][4], al[1][4], bh[1][2], bl[1][2];
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float af[4] = {a[g * K + k0 + t], a[(g + 8) * K + k0 + t], a[g * K + k0 + t + 4],
                         a[(g + 8) * K + k0 + t + 4]};
    split(af, ah[0], al[0]);
    split_b(b[(k0 + t) * 8 + g], b[(k0 + t + 4) * 8 + g], bh[0], bl[0]);
    mma3(d, ah, al, bh, bl, 1);
  }
  const float* dd = d[0][0];
  d_out[g * 8 + 2 * t] = dd[0];
  d_out[g * 8 + 2 * t + 1] = dd[1];
  d_out[(g + 8) * 8 + 2 * t] = dd[2];
  d_out[(g + 8) * 8 + 2 * t + 1] = dd[3];
  float af[4], e[1][1][4] = {{{0.f, 0.f, 0.f, 0.f}}};
  as_a(d[0][0], af);
  split(af, ah[0], al[0]);
  split_b(b2[(2 * t) * 8 + g], b2[(2 * t + 1) * 8 + g], bh[0], bl[0]);
  mma3(e, ah, al, bh, bl, 1);
  e_out[g * 8 + 2 * t] = e[0][0][0];
  e_out[g * 8 + 2 * t + 1] = e[0][0][1];
  e_out[(g + 8) * 8 + 2 * t] = e[0][0][2];
  e_out[(g + 8) * 8 + 2 * t + 1] = e[0][0][3];
}

// The tensor cores' rate for mma.sync m16n8k8 TF32 (BF16 = false) or
// m16n8k16 bf16 (BF16 = true) alone: each warp issues kAcc independent
// products per iteration on register operands, no loads; out keeps the
// sums live. What K1/K2-fp32's products can reach at most on mma.sync.
constexpr int kAcc = 8;

template <bool BF16>
__global__ void __launch_bounds__(256) rate_kernel(float* __restrict__ out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  float d[kAcc][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      if (BF16)
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
            "{%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[k & 3]), "r"(a[(k + 1) & 3]));
      else
        mma_tf32(d[k], a, a[k & 3], a[(k + 1) & 3]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// The tensor cores' rate for wgmma m64nNk8 TF32 with A from registers and
// B a zeroed 64 x 32 tile (N = 64: K1-fp32's and K2-fp32's products; 32:
// dw_kernel's logits), alone: each of 2 warpgroups a CTA issues iters x 8
// products, 8 a commit group, one group in flight behind the next. What
// K1/K2-fp32's products can reach at most on wgmma.
template <int N>
__global__ void __launch_bounds__(256) wgmma_rate_kernel(float* __restrict__ out, int iters) {
  __shared__ __align__(1024) unsigned char b[hopper::kBox * 128];
  for (int i = threadIdx.x; i < hopper::kBox * 32; i += blockDim.x) reinterpret_cast<float*>(b)[i] = 0.f;
  hopper::fence_proxy_async();
  __syncthreads();
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint64_t db = hopper::desc_sw128(b, 16, 1024);
  float d[N / 2] = {};
  hopper::fence_acc(d);
  hopper::wgmma_fence();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (N == 64)
        hopper::mma_tf32_rs_n64(d, a, db);
      else
        hopper::mma_tf32_rs_n32(d, a, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_acc(d);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N / 2; ++k) s += d[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// blocks x 2 warpgroups, each iters x 8 wgmma m64nNk8 TF32 products of
// 2 * 64 * N * 8 operations (n = 32 or 64), into out (blocks * 256,).
// Returns the launch's cudaError_t.
int ihpr_tf32x3_wgmma_rate(float* out, int blocks, int iters, int n, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (n == 64)
    wgmma_rate_kernel<64><<<blocks, 256, 0, st>>>(out, iters);
  else if (n == 32)
    wgmma_rate_kernel<32><<<blocks, 256, 0, st>>>(out, iters);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// blocks x 256 threads, each warp iters x kAcc products of 2048 (TF32) or
// 4096 (bf16) operations into out (blocks * 256,). Returns the launch's
// cudaError_t.
int ihpr_tf32x3_mma_rate(float* out, int blocks, int iters, int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    rate_kernel<true><<<blocks, 256, 0, st>>>(out, iters);
  else
    rate_kernel<false><<<blocks, 256, 0, st>>>(out, iters);
  return (int)cudaGetLastError();
}


// x (n,) fp32 -> hi, rem = x - hi, lo, rna = cvt.rna.tf32.f32(x) (n,) fp32.
// Returns the launch's cudaError_t.
int ihpr_tf32x3_split(const float* x, float* hi, float* rem, float* lo, float* rna, int n, void* stream) {
  split_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, hi, rem, lo, rna, n);
  return (int)cudaGetLastError();
}

// a (16, K), b (K, 8), b2 (8, 8) fp32, K a multiple of 8 -> d = a b (16, 8),
// e = d b2 (16, 8). Returns the launch's cudaError_t.
int ihpr_tf32x3_product(const float* a, const float* b, const float* b2, float* d, float* e, int K,
                        void* stream) {
  if (K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
  product_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, b, b2, d, e, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
