// A one-tile GEMM per operand mode of hopper.cuh, for the card tests: it
// holds each descriptor layout K1/K2 use against torch.matmul before the
// kernels build on it (tests/test_torch_kernels.py). Not on any model path.
//
//   D (64 x N, fp32) = A (64 x K) * B (K x N), K = 64, 128, 192 or 256, bf16.
//   mode 0: A K-major (a = A, 64 x K), B K-major (b = B^T, N x K); N = 64 or
//           192 (K1's logits; K2's with N = 64)
//   mode 1: A K-major, B MN-major (b = B, K x 64)
//   mode 2: A M-major (a = A^T, K x 64), B MN-major (K2's dW = feat^T dv)
//   mode 3: A from registers (a = A), B MN-major (K2's dfeat = dv W_j^T)
// Operands come in by TMA into 128-byte-swizzled tiles, as in K1/K2.

#include "hopper.cuh"

namespace {

using namespace hopper;

template <int N>
struct Acc;
template <>
struct Acc<64> {
  template <int TA, int TB>
  static __device__ void ss(float (&d)[32], uint64_t a, uint64_t b) { mma_ss_n64<TA, TB>(d, a, b); }
};
template <>
struct Acc<192> {
  template <int TA, int TB>
  static __device__ void ss(float (&d)[96], uint64_t a, uint64_t b) { mma_ss_n192<TA, TB>(d, a, b); }
};

template <int N>
__global__ void __launch_bounds__(128)
    selftest_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                    const __nv_bfloat16* __restrict__ a, float* __restrict__ out, int mode, int K) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  const int nkb = K / kBox;
  unsigned char* a_s = base;
  unsigned char* b_s = a_s + nkb * kBoxBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(b_s + nkb * (N / kBox) * kBoxBytes);
  const bool a_mn = mode == 2, b_mn = mode >= 1, a_reg = mode == 3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, (a_reg ? 0 : nkb) * kBoxBytes + nkb * (N / kBox) * kBoxBytes);
    for (int kb = 0; kb < nkb; ++kb) {
      if (!a_reg) tma_load_2d(a_s + kb * kBoxBytes, &amap, bar, a_mn ? 0 : kb * kBox, a_mn ? kb * kBox : 0);
      if (b_mn) {
        tma_load_2d(b_s + kb * kBoxBytes, &bmap, bar, 0, kb * kBox);
      } else {
        for (int nb = 0; nb < N / kBox; ++nb)
          tma_load_2d(b_s + kb * N * 128 + nb * kBoxBytes, &bmap, bar, kb * kBox, nb * kBox);
      }
    }
  }
  mbar_wait(bar, 0);

  // A's fragments, when A comes from registers: rows 16 warp + g (+8), k
  // 16 s + 2 tig (+1) (+8), the m16n8k16 A layout; loaded before the fence.
  uint32_t f[4 * kBox / 16][4];
  if (a_reg) {
#pragma unroll
    for (int s = 0; s < 4 * kBox / 16; ++s) {
      if (s < K / 16) {
        const __nv_bfloat16* r0 = a + (size_t)(warp * 16 + g) * K + s * 16 + 2 * tig;
        const __nv_bfloat16* r1 = r0 + 8 * K;
        f[s][0] = *reinterpret_cast<const uint32_t*>(r0);
        f[s][1] = *reinterpret_cast<const uint32_t*>(r1);
        f[s][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        f[s][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
      }
    }
  }
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4 * kBox / 16; ++s) {
    if (s >= K / 16) break;
    const int kb = s >> 2, q = s & 3;
    const uint64_t db = b_mn ? desc_sw128(b_s + kb * kBoxBytes + q * 2048, kBoxBytes, 1024)
                             : desc_sw128(b_s + kb * N * 128 + q * 32, 16, 1024);
    if (a_reg) {
      if constexpr (N == 64) mma_rs_n64(d, f[s], db);
    } else if (a_mn) {
      Acc<N>::template ss<1, 1>(d, desc_sw128(a_s + kb * kBoxBytes + q * 2048, kBoxBytes, 1024), db);
    } else {
      const uint64_t da = desc_sw128(a_s + kb * kBoxBytes + q * 32, 16, 1024);
      if (b_mn)
        Acc<N>::template ss<0, 1>(d, da, db);
      else
        Acc<N>::template ss<0, 0>(d, da, db);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(d);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(size_t)(warp * 16 + g + 8 * (e >> 1)) * N + 8 * i + 2 * tig + (e & 1)] = d[4 * i + e];
  }
}

template <int N>
int launch(const CUtensorMap& am, const CUtensorMap& bm, const void* a, float* out, int mode, int K,
           cudaStream_t stream) {
  const int smem = 1024 + (K / kBox) * (1 + N / kBox) * kBoxBytes + 8;
  cudaError_t err = cudaFuncSetAttribute(selftest_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  selftest_kernel<N><<<1, 128, smem, stream>>>(am, bm, static_cast<const __nv_bfloat16*>(a), out, mode, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a and b as the mode above says (contiguous bf16, 16-byte aligned), out
// (64, N) fp32. Returns 0, a CUresult of the tensor-map encoding, or the
// cudaError_t of the launch; -1 for a mode, K or N it does not take.
int ihpr_hopper_selftest(const void* a, const void* b, float* out, int mode, int K, int N,
                         void* stream) {
  if (mode < 0 || mode > 3 || K % kBox || K < kBox || K > 4 * kBox) return -1;
  if ((N != 64 && mode != 0) || (N != 64 && N != 192)) return -1;
  const bool a_mn = mode == 2, b_mn = mode >= 1;
  CUtensorMap am, bm;
  int err = tmap_matrix(&am, a, a_mn ? K : 64, a_mn ? 64 : K);
  if (!err) err = tmap_matrix(&bm, b, b_mn ? K : N, b_mn ? N : K);
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  return N == 64 ? launch<64>(am, bm, a, out, mode, K, st) : launch<192>(am, bm, a, out, mode, K, st);
}

}  // extern "C"
