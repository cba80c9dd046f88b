// One-tile checks of hopper.cuh's building blocks, for the card tests: each
// descriptor layout K1/K2, K6, K7/K8 and P2 issue, held against torch.matmul,
// the in-place rewrite of a swizzled tile that K6 reads with wgmma, the s8
// wgmma of P2's int8 mode, and the 4-D NHWC box K7/K8 read their taps with,
// held against a slice of the zero-padded tensor, before the kernels build
// on them (tests/test_torch_kernels.py). Not on any model path.
//
//   D (64 x N, fp32) = A (64 x K) * B (K x N), K = 64, 128, 192 or 256, bf16.
//   mode 0: A K-major (a = A, 64 x K), B K-major (b = B^T, N x K); N = 64,
//           128 (K6's da), 192 (K1's logits; K2's with N = 64) or 256 (K8's
//           and K6's da)
//   mode 1: A K-major, B MN-major (b = B, K x N); N = 64, 128 or 256 (K7's
//           y, P2's bf16 tiles)
//   mode 2: A M-major (a = A^T, K x 64), B MN-major; N = 64 (K2's dW =
//           feat^T dv), 128 or 256 (K8's and K6's dw)
//   mode 3: A from registers (a = A), B MN-major, N = 64 (K2's dfeat = dv W_j^T)
// With sa and sb (modes 0-2), every element of a and b is first multiplied
// in shared memory by sa / sb at its column of a / b as given, the way K6
// forms gc and relu(x*mul + add) in the tiles TMA brought in: the column of
// a swizzled byte is undone from its row, the writes are fenced to the async
// proxy, and wgmma reads the rewritten tiles.
//   s8: D (64 x N, s32) = A (64 x K) * B (K x N), int8, K = 128 or 256, N =
//       128 or 256, both K-major (a = A, b = B^T): the uint8 TMA map and the
//       m64nNk32 s8 wgmma of P2.
// Operands come in by TMA into 128-byte-swizzled tiles, as in the kernels;
// an MN-major B of N = 128 or 256 is two or four 64-column boxes 8192 bytes
// apart.

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
struct Acc<128> {
  template <int TA, int TB>
  static __device__ void ss(float (&d)[64], uint64_t a, uint64_t b) { mma_ss_n128<TA, TB>(d, a, b); }
};
template <>
struct Acc<192> {
  template <int TA, int TB>
  static __device__ void ss(float (&d)[96], uint64_t a, uint64_t b) { mma_ss_n192<TA, TB>(d, a, b); }
};
template <>
struct Acc<256> {
  template <int TA, int TB>
  static __device__ void ss(float (&d)[128], uint64_t a, uint64_t b) { mma_ss_n256<TA, TB>(d, a, b); }
};

// Multiplies every bf16 of a swizzled 64 x 64 tile by s[col0 + its column].
__device__ void scale_tile(unsigned char* tile, const float* __restrict__ s, int col0) {
  for (int i = threadIdx.x; i < kBox * 8; i += blockDim.x) {
    const int r = i >> 3, pc = i & 7, c = col0 + 8 * (pc ^ (r & 7));
    uint4* p = reinterpret_cast<uint4*>(tile + r * 128 + pc * 16);
    uint4 raw = *p;
    __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(__bfloat162float(v[e]) * s[c + e]);
    *p = raw;
  }
}

template <int N>
__global__ void __launch_bounds__(128)
    selftest_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                    const __nv_bfloat16* __restrict__ a, const float* __restrict__ sa,
                    const float* __restrict__ sb, float* __restrict__ out, int mode, int K) {
  unsigned char* base = smem_base();
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
        for (int nb = 0; nb < N / kBox; ++nb)
          tma_load_2d(b_s + (kb * (N / kBox) + nb) * kBoxBytes, &bmap, bar, nb * kBox, kb * kBox);
      } else {
        for (int nb = 0; nb < N / kBox; ++nb)
          tma_load_2d(b_s + kb * N * 128 + nb * kBoxBytes, &bmap, bar, kb * kBox, nb * kBox);
      }
    }
  }
  mbar_wait(bar, 0);
  if (sa) {  // the rewrite in place, then the fence to the async proxy
    for (int kb = 0; kb < nkb; ++kb) {
      scale_tile(a_s + kb * kBoxBytes, sa, a_mn ? 0 : kb * kBox);
      for (int nb = 0; nb < N / kBox; ++nb)
        scale_tile(b_s + (kb * (N / kBox) + nb) * kBoxBytes, sb, b_mn ? nb * kBox : kb * kBox);
    }
    fence_proxy_async();
    __syncthreads();
  }

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
    const uint64_t db = b_mn ? desc_sw128(b_s + kb * N * 128 + q * 2048, kBoxBytes, 1024)
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
int launch(const CUtensorMap& am, const CUtensorMap& bm, const void* a, const float* sa,
           const float* sb, float* out, int mode, int K, cudaStream_t stream) {
  const int smem = 1024 + (K / kBox) * (1 + N / kBox) * kBoxBytes + 8;
  cudaError_t err = cudaFuncSetAttribute(selftest_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  selftest_kernel<N><<<1, 128, smem, stream>>>(am, bm, static_cast<const __nv_bfloat16*>(a), sa, sb, out,
                                              mode, K);
  return (int)cudaGetLastError();
}

// D = A B^T in s8 -> s32: a (64, K) and bt (N, K) int8 through uint8 maps
// (boxes of 128 bytes x 64 rows), both K-major.
template <int N>
__global__ void __launch_bounds__(128)
    selftest_s8_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                       int* __restrict__ out, int K) {
  unsigned char* base = smem_base();
  const int nkb = K / 128;
  unsigned char* a_s = base;
  unsigned char* b_s = a_s + nkb * kBoxBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(b_s + nkb * (N / kBox) * kBoxBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, nkb * (1 + N / kBox) * kBoxBytes);
    for (int kb = 0; kb < nkb; ++kb) {
      tma_load_2d(a_s + kb * kBoxBytes, &amap, bar, kb * 128, 0);
      for (int nb = 0; nb < N / kBox; ++nb)
        tma_load_2d(b_s + (kb * (N / kBox) + nb) * kBoxBytes, &bmap, bar, kb * 128, nb * kBox);
    }
  }
  mbar_wait(bar, 0);
  int d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0;
  fence_acc(d);
  wgmma_fence();
  for (int kb = 0; kb < nkb; ++kb) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint64_t da = desc_sw128(a_s + kb * kBoxBytes + q * 32, 16, 1024);
      const uint64_t db = desc_sw128(b_s + kb * N * 128 + q * 32, 16, 1024);
      if constexpr (N == 128)
        mma_s8_n128(d, da, db);
      else
        mma_s8_n256(d, da, db);
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
int launch_s8(const CUtensorMap& am, const CUtensorMap& bm, int* out, int K, cudaStream_t stream) {
  const int smem = 1024 + (K / 128) * (1 + N / kBox) * kBoxBytes + 8;
  cudaError_t err = cudaFuncSetAttribute(selftest_s8_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  selftest_s8_kernel<N><<<1, 128, smem, stream>>>(am, bm, out, K);
  return (int)cudaGetLastError();
}

// The box of `map` at (c0, c1, c2, c3), unswizzled: out[r * 64 + c] is
// channel c of the box's row r.
__global__ void __launch_bounds__(128)
    tma4d_kernel(const __grid_constant__ CUtensorMap map, __nv_bfloat16* __restrict__ out, int c0,
                 int c1, int c2, int c3) {
  __shared__ __align__(1024) unsigned char tile[kBoxBytes];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, kBoxBytes);
    tma_load_4d(tile, &map, &bar, c0, c1, c2, c3);
  }
  mbar_wait(&bar, 0);
  for (int e = threadIdx.x; e < kBox * kBox; e += blockDim.x) {
    const int r = e / kBox, c = e % kBox;
    out[e] = *reinterpret_cast<const __nv_bfloat16*>(tile + r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2);
  }
}

}  // namespace

extern "C" {

// a and b as the mode above says (contiguous bf16, 16-byte aligned), sa
// and sb fp32 scales of their columns (both null: none), out (64, N) fp32.
// Returns 0, a CUresult of the tensor-map encoding, or the cudaError_t of
// the launch; -1 for a mode, K or N it does not take.
int ihpr_hopper_selftest(const void* a, const void* b, const float* sa, const float* sb, float* out,
                         int mode, int K, int N, void* stream) {
  if (mode < 0 || mode > 3 || K % kBox || K < kBox || K > 4 * kBox) return -1;
  if (!(N == 64 || (N == 192 && mode == 0) || ((N == 128 || N == 256) && mode < 3))) return -1;
  if (!sa != !sb || (sa && mode == 3)) return -1;
  const bool a_mn = mode == 2, b_mn = mode >= 1;
  CUtensorMap am, bm;
  int err = tmap_matrix(&am, a, a_mn ? K : 64, a_mn ? 64 : K);
  if (!err) err = tmap_matrix(&bm, b, b_mn ? K : N, b_mn ? N : K);
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 64: return launch<64>(am, bm, a, sa, sb, out, mode, K, st);
    case 128: return launch<128>(am, bm, a, sa, sb, out, mode, K, st);
    case 192: return launch<192>(am, bm, a, sa, sb, out, mode, K, st);
    default: return launch<256>(am, bm, a, sa, sb, out, mode, K, st);
  }
}

// a (64, K) and bt (N, K) int8, contiguous, 16-byte aligned; out (64, N)
// int32 = a @ bt^T. Returns 0, a CUresult or the cudaError_t of the launch;
// -1 for K not 128 or 256 or N not 128 or 256.
int ihpr_hopper_selftest_s8(const void* a, const void* bt, int* out, int K, int N, void* stream) {
  if ((K != 128 && K != 256) || (N != 128 && N != 256)) return -1;
  CUtensorMap am, bm;
  int err = tmap_matrix_s8(&am, a, 64, K);
  if (!err) err = tmap_matrix_s8(&bm, bt, N, K);
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  return N == 128 ? launch_s8<128>(am, bm, out, K, st) : launch_s8<256>(am, bm, out, K, st);
}

// a (batch, height, width, channels) bf16, contiguous, 16-byte aligned;
// out (64, 64) bf16: the box of tmap_nhwc(a, ..., bw, bh) at channel c0,
// column j0, row i0 of image b (any of them may lie outside a). Returns 0,
// a CUresult of the encoding or the cudaError_t of the launch; -1 for bw *
// bh != 64 or channels % 8 != 0.
int ihpr_hopper_selftest_tma4d(const void* a, void* out, int batch, int height, int width,
                               int channels, int bw, int bh, int c0, int j0, int i0, int b,
                               void* stream) {
  if (bw * bh != kBox || bw < 1 || channels % 8) return -1;
  CUtensorMap map;
  const int err = tmap_nhwc(&map, a, batch, height, width, channels, bw, bh);
  if (err) return err;
  tma4d_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<__nv_bfloat16*>(out), c0, j0, i0, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
