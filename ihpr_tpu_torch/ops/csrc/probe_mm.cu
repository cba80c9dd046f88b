// The tiled matmul probe (P2) for Hopper (sm_90a): C = A @ B with A (M, K) and
// B (K, N) row-major, bf16 -> fp32 or int8 -> int32, on the tensor cores.
//
// Replaces the TPU kernel tools/mxu_int8_probe.py:_mm_kernel (launched by
// pallas_mm): a tiled product with the K loop innermost and an fp32 or int32
// accumulator.
//
// What bounds it on an H100. At M = N = K = 4096 the product is 137.4 GFLOP
// (or TOP): 0.139 ms at 989 TFLOP/s bf16 and 0.069 ms at 1,979 TOP/s int8,
// against 96 MB of operands and C (0.029 ms at 3.35 TB/s): the tensor cores
// bound it. v1 (mma.sync fed by ldmatrix from a cp.async ring, 8 warps)
// was issue-bound at 253 TFLOP/s bf16 and 418 TOP/s int8.
//
// Design (v2), the usual Hopper GEMM:
//   - a CTA of one producer warpgroup and two consumer warpgroups computes
//     one (BM, BN) tile of C; the tiles are walked in groups of 8 row tiles
//     per column sweep, so the CTAs in flight share A's and B's panels in L2;
//   - the producer (one thread) keeps a ring of TMA loads in flight, 192 KB
//     deep (4 stages of 48 KB or 6 of 32 KB), each stage one 128-byte-deep
//     k-block: 64 bf16 or 128 int8 values of every row, in 64-row boxes with
//     the 128-byte swizzle (hopper.cuh). One box geometry serves both types;
//   - each consumer warpgroup owns BM / 2 rows of the tile: wgmma m64nBNk16
//     (bf16, fp32 accumulation) or m64nBNk32 (s8, s32 accumulation, exact) on
//     each stage, the products of one stage in flight while the next is
//     waited for; setmaxnreg gives the consumers the registers of the
//     accumulator (BN / 2 or, for BM = 256, 2 x 64 a thread);
//   - bf16: B (K, N) is read in place as wgmma's MN-major B. 8-bit wgmma
//     takes K-major operands only, so int8 B is first transposed to (N, K)
//     by transpose_kernel in the same call (N*K bytes read and written, 32
//     MB at 4096^2) and read K-major;
//   - the epilogue stores C straight from the accumulator (64 MB at 4096^2,
//     ~0.02 ms at 3.35 TB/s), not overlapped with the next tile's loads (no
//     persistent CTAs).
// M, N and K must be multiples of the tile (the TPU kernel asserts the
// same); nothing is masked.
//
// The tiles: (BM, BN, bk) = (128, 256), (256, 128) and (128, 128) with bk =
// 64 bf16 / 128 int8 (one 128-byte k-block per stage). A tile that is not in
// the list is refused (cudaErrorInvalidValue).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 384;           // producer warpgroup + two consumer warpgroups
constexpr int kRingBytes = 192 * 1024;  // the TMA ring
constexpr int kGroup = 8;               // row tiles per column sweep

// The two element types: how B lies in shared memory and which wgmma runs.
// a is one 64-row box of A; b the stage's BN / 64 boxes of B; ks the k-step
// (32 bytes of the 128-byte k-block).
struct Bf16 {
  using Acc = float;
  static constexpr int kElems = 64;  // elements in a 128-byte k-block
  template <int BN>
  static __device__ __forceinline__ void mma(float (&d)[BN / 2], const unsigned char* a,
                                             const unsigned char* b, int ks) {
    mma_ss<BN, 0, 1>(d, desc_sw128(a + ks * 32, 16, 1024), desc_sw128(b + ks * 2048, kBoxBytes, 1024));
  }
};
struct Int8 {
  using Acc = int;
  static constexpr int kElems = 128;
  template <int BN>
  static __device__ __forceinline__ void mma(int (&d)[BN / 2], const unsigned char* a,
                                             const unsigned char* b, int ks) {
    const uint64_t da = desc_sw128(a + ks * 32, 16, 1024), db = desc_sw128(b + ks * 32, 16, 1024);
    if constexpr (BN == 128)
      mma_s8_n128(d, da, db);
    else
      mma_s8_n256(d, da, db);
  }
};

template <int BM, int BN>
struct Ring {
  static constexpr int kStageBytes = (BM + BN) / kBox * kBoxBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

// amap: A (M, K); bmap: bf16 B (K, N) or int8 B^T (N, K); all in 64-row x
// 128-byte boxes. One CTA per (BM, BN) tile of c (M, N).
template <class T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    mm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
              typename T::Acc* __restrict__ c, int M, int N, int K) {
  using R = Ring<BM, BN>;
  constexpr int kMt = BM / 128;  // m64 blocks of each consumer warpgroup
  unsigned char* ring = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::kStages * R::kStageBytes);
  uint64_t* empty = full + R::kStages;

  const int tiles_m = M / BM, tiles_n = N / BN;
  const int in_group = kGroup * tiles_n, first_m = blockIdx.x / in_group * kGroup;
  const int rows = min(tiles_m - first_m, kGroup), q = blockIdx.x % in_group;
  const int m0 = (first_m + q % rows) * BM, n0 = q / rows * BN;
  const int steps = K / T::kElems;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % R::kStages, k0 = s * T::kElems;
        unsigned char* stage = ring + st * R::kStageBytes;
        mbar_wait(&empty[st], ((s / R::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], R::kStageBytes);
        for (int i = 0; i < BM / kBox; ++i)
          tma_load_2d(stage + i * kBoxBytes, &amap, &full[st], k0, m0 + i * kBox);
        unsigned char* b = stage + BM / kBox * kBoxBytes;
        for (int i = 0; i < BN / kBox; ++i) {
          if (T::kElems == 64)  // bf16 B: 64 k rows x 64 columns n, MN-major
            tma_load_2d(b + i * kBoxBytes, &bmap, &full[st], n0 + i * kBox, k0);
          else  // int8 B^T: 64 rows n x 128 bytes k, K-major
            tma_load_2d(b + i * kBoxBytes, &bmap, &full[st], k0, n0 + i * kBox);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, wq = (ctid >> 5) & 3;
  const int lane = tid & 31, gq = lane >> 2, tig = lane & 3;
  typename T::Acc acc[kMt][BN / 2];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0;
  for (int s = 0; s < steps; ++s) {
    const int st = s % R::kStages;
    const unsigned char* stage = ring + st * R::kStageBytes;
    mbar_wait(&full[st], (s / R::kStages) & 1);
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) fence_acc(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
        T::template mma<BN>(acc[mt], stage + (wg * kMt + mt) * kBoxBytes, stage + BM / kBox * kBoxBytes, ks);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done ...
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) fence_acc(acc[mt]);
    if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % R::kStages]);  // ... so its slot is free
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) fence_acc(acc[mt]);

  // Accumulator element 4 i + e: row 16 wq + gq + 8 (e >> 1), column 8 i + 2 tig + (e & 1).
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = m0 + (wg * kMt + mt) * kBox + wq * 16 + gq + 8 * h;
      typename T::Acc* out = c + row * N + n0 + 2 * tig;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        if constexpr (T::kElems == 64)
          *reinterpret_cast<float2*>(out + 8 * i) = make_float2(acc[mt][4 * i + 2 * h], acc[mt][4 * i + 2 * h + 1]);
        else
          *reinterpret_cast<int2*>(out + 8 * i) = make_int2(acc[mt][4 * i + 2 * h], acc[mt][4 * i + 2 * h + 1]);
      }
    }
}

// bt (N, K) = b (K, N)^T, int8, by 64 x 64 tiles through shared memory; K and N
// are multiples of 64. Each thread moves 4-byte words: 4 reads of b's rows,
// then 4 bytes of one column packed into one word of bt's row.
__global__ void __launch_bounds__(256)
    transpose_kernel(const uint8_t* __restrict__ b, uint8_t* __restrict__ bt, int K, int N) {
  __shared__ uint32_t tile[64][64 / 4 + 1];  // [k][n / 4]
  const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  for (int i = threadIdx.x; i < 64 * 16; i += blockDim.x) {
    const int r = i / 16, w = i % 16;
    tile[r][w] = *reinterpret_cast<const uint32_t*>(b + (size_t)(k0 + r) * N + n0 + 4 * w);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 16; i += blockDim.x) {
    const int n = i / 16, w = i % 16;  // bt row n0 + n, bytes k0 + 4w ... + 3
    uint32_t v = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) v |= ((tile[4 * w + q][n / 4] >> (8 * (n % 4))) & 0xffu) << (8 * q);
    *reinterpret_cast<uint32_t*>(bt + (size_t)(n0 + n) * K + k0 + 4 * w) = v;
  }
}

template <class T, int BM, int BN>
int launch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap amap, bmap;
  int err = T::kElems == 64 ? tmap_matrix(&amap, a, M, K) : tmap_matrix_s8(&amap, a, M, K);
  if (!err) err = T::kElems == 64 ? tmap_matrix(&bmap, b, K, N) : tmap_matrix_s8(&bmap, b, N, K);
  if (err) return err;
  auto kern = mm_kernel<T, BM, BN>;
  constexpr int smem = Ring<BM, BN>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(M / BM) * (N / BN), kThreads, smem, stream>>>(amap, bmap, static_cast<typename T::Acc*>(c), M, N, K);
  return (int)cudaGetLastError();
}

// The tile list, (bm, bn) with bk = one 128-byte k-block. Returns
// cudaErrorInvalidValue, and launches nothing, for a tile not in the list.
template <class T>
int dispatch(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn, int bk,
             cudaStream_t st, bool launch_it = true) {
  int (*fn)(const void*, const void*, void*, int, int, int, cudaStream_t) = nullptr;
  if (bk == T::kElems) {
    if (bm == 128 && bn == 256) fn = launch<T, 128, 256>;
    if (bm == 256 && bn == 128) fn = launch<T, 256, 128>;
    if (bm == 128 && bn == 128) fn = launch<T, 128, 128>;
  }
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return launch_it ? fn(a, b, c, M, N, K, st) : 0;
}

}  // namespace

extern "C" {

// c (M, N) = a (M, K) @ b (K, N), row-major and contiguous, 16-byte aligned:
// bf16 -> fp32 (is_int8 = 0), or int8 -> int32 with bt (N, K) int8 scratch
// for B's transpose. M, N, K multiples of the tile (bm, bn, bk), which must
// be in the list above. Returns the first error of the launches (0 on
// success; cudaErrorInvalidValue for a tile not in the list; a CUresult of
// a tensor-map encoding).
int ihpr_probe_mm(const void* a, const void* b, void* bt, void* c, int M, int N, int K, int is_int8,
                  int bm, int bn, int bk, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (!is_int8) return dispatch<Bf16>(a, b, c, M, N, K, bm, bn, bk, st);
  const int known = dispatch<Int8>(a, bt, c, M, N, K, bm, bn, bk, st, false);
  if (known != 0) return known;
  transpose_kernel<<<dim3(N / 64, K / 64), 256, 0, st>>>(static_cast<const uint8_t*>(b),
                                                        static_cast<uint8_t*>(bt), K, N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return dispatch<Int8>(a, bt, c, M, N, K, bm, bn, bk, st);
}

}  // extern "C"
