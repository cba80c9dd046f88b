// The tiled matmul probe (P2) for Hopper (sm_90a): C = A @ B with A (M, K) and
// B (K, N) row-major, bf16 -> fp32 or int8 -> int32, on the tensor cores.
//
// Replaces the TPU kernel tools/mxu_int8_probe.py:_mm_kernel (launched by
// pallas_mm): a tiled product with the K loop innermost and an fp32 or int32
// accumulator.
//
// Design. A CTA of 8 warps computes one (BM, BN) tile of C; each warp owns a
// (BM / WARPS_M, BN / WARPS_N) sub-tile as m16n8 accumulator fragments in
// registers (the TPU kernel's scratch accumulator). The K loop stages
// BK-deep slices of A and B in shared memory through a ring of kStages
// cp.async buffers (16-byte copies; the copies of the next kStages - 1 slices
// stay in flight; one barrier per slice). Rows are padded by 16 bytes, so the
// 8 rows one ldmatrix reads fall in distinct banks. Fragments come from
// ldmatrix and feed mma.sync:
//   bf16: m16n8k16 (fp32 accumulation); B's fragments by ldmatrix.trans from
//         the (K, N) slice as it lies in memory;
//   int8: m16n8k32 (s32 accumulation, exact). ldmatrix moves 16-bit units and
//         cannot transpose bytes, so B is first transposed to (N, K) by
//         transpose_kernel (N*K bytes read and written, 32 MB at 4096^2, in
//         the same call) and its fragments are read like A's.
// Either way a k-step covers 32 bytes of each row, so A's fragment addressing
// is the same in both types. M, N and K must be multiples of the tile (the
// TPU kernel asserts the same); nothing is masked.
//
// The tiles. The TPU tiles (512 x 512 x 1024 and larger) are sized for 16 MB
// of VMEM; a CTA here has 227 KB of shared memory and 255 registers a
// thread. The list below keeps the accumulator at 64-128 registers a thread
// and 4 stages within ~123 KB: 128x128 (two CTAs fit an SM), 128x256 and
// 256x128 (64x64 warp tiles, the most reuse of each fragment mma.sync
// allows), and 64x128 with a 128-byte slice (short M tiles, more CTAs).
// bk is 32 bf16 or 64 int8 values, so a stage moves the same bytes in both
// types (128 bf16 / 128 int8 for the 64x128 tile). A tile that is not in the
// list is refused (cudaErrorInvalidValue).
//
// What bounds it on an H100. At M = N = K = 4096 the product is 137.4 GFLOP
// (or TOP): 0.139 ms at 989 TFLOP/s bf16 and 0.069 ms at 1,979 TOP/s int8.
// mma.sync issues from registers fed by ldmatrix and reaches well under the
// wgmma peak; this simple version is the floor a wgmma + TMA kernel starts
// from.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kPad = 16;  // bytes added to every shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The two element types: the mma, and where B's slice comes from.
struct Bf16 {
  using Acc = float;
  static constexpr int kSize = 2;
  static __device__ __forceinline__ void mma(Acc (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
struct Int8 {
  using Acc = int;
  static constexpr int kSize = 1;
  static __device__ __forceinline__ void mma(Acc (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Shared-memory bytes of one stage. A: BM rows of BK elements. B: bf16 keeps
// (BK, BN) as in memory; int8 (BN, BK) from the transposed copy.
template <class T, int BM, int BN, int BK>
struct Smem {
  static constexpr int kRowA = BK * T::kSize + kPad;
  static constexpr int kRowB = (T::kSize == 2 ? BN * 2 : BK) + kPad;
  static constexpr int kRowsB = T::kSize == 2 ? BK : BN;
  static constexpr int kA = BM * kRowA, kB = kRowsB * kRowB;
  static constexpr int kStage = kA + kB;
  static constexpr int kTotal = kStages * kStage;
};

// Copy a ROWS x BYTES block (row pitch ld bytes in memory, pitch in shared
// memory) as 16-byte chunks, chunk i = tid, tid + kThreads, ...
template <int ROWS, int BYTES>
__device__ __forceinline__ void load_block(char* dst, int pitch, const char* src, size_t ld) {
  constexpr int kPer = BYTES / 16;
  static_assert((ROWS * kPer) % kThreads == 0, "a tile is a whole number of chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * kPer / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / kPer, c = (i - r * kPer) * 16;
    cp_async16(dst + r * pitch + c, src + r * ld + c);
  }
}

template <class T, int BM, int BN, int BK, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(kThreads, 1)
    mm_kernel(const char* __restrict__ a, const char* __restrict__ b, typename T::Acc* __restrict__ c,
              int N, int K) {
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps");
  using S = Smem<T, BM, BN, BK>;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N, MT = WM / 16, NT = WN / 8;
  constexpr int kStepBytes = 32, kSteps = BK * T::kSize / kStepBytes;
  static_assert(NT % 2 == 0 && kSteps >= 1, "ldmatrix x4 covers two n-tiles");
  extern __shared__ __align__(16) char smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_tiles = K / BK;
  const size_t lda = (size_t)K * T::kSize;                      // bytes per row of A
  const size_t ldb = T::kSize == 2 ? (size_t)N * 2 : (size_t)K;  // of B (bf16) or B^T (int8)
  const char* a_blk = a + (size_t)m0 * lda;
  const char* b_blk = T::kSize == 2 ? b + (size_t)n0 * 2 : b + (size_t)n0 * ldb;

  auto issue = [&](int kt, int buf) {
    char* st = smem + buf * S::kStage;
    load_block<BM, BK * T::kSize>(st, S::kRowA, a_blk + (size_t)kt * BK * T::kSize, lda);
    if constexpr (T::kSize == 2)
      load_block<BK, BN * 2>(st + S::kA, S::kRowB, b_blk + (size_t)kt * BK * ldb, ldb);
    else
      load_block<BN, BK>(st + S::kA, S::kRowB, b_blk + (size_t)kt * BK, ldb);
  };

  typename T::Acc acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) issue(s, s);
    cp_async_commit();
  }

  // ldmatrix x4: lane l addresses row (l & 7) of matrix (l >> 3).
  const int mi = lane >> 3, rr = lane & 7;
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed
    __syncthreads();               // ... for every thread; slice kt - 1's buffer is free
    if (kt + kStages - 1 < k_tiles) issue(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();

    const char* As = smem + (kt % kStages) * S::kStage;
    const char* Bs = As + S::kA;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      // A: matrices (m 0-7 | 8-15) x (bytes 0-15 | 16-31) of the k-step.
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], As + (wm + mt * 16 + (mi & 1) * 8 + rr) * S::kRowA + ks * kStepBytes +
                                (mi >> 1) * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];  // b0, b1 of n-tile 2np, then of 2np + 1
        if constexpr (T::kSize == 2)  // (k 0-7 | 8-15) x (n 0-7 | 8-15), transposed on the way
          ldmatrix_x4_trans(bf, Bs + (ks * 16 + (mi & 1) * 8 + rr) * S::kRowB +
                                    (wn + np * 16 + (mi >> 1) * 8) * 2);
        else  // B^T rows (n 0-7 | 8-15) x (bytes 0-15 | 16-31)
          ldmatrix_x4(bf, Bs + (wn + np * 16 + (mi >> 1) * 8 + rr) * S::kRowB + ks * kStepBytes +
                              (mi & 1) * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          T::mma(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          T::mma(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Fragment element e of (mt, nt): row g + 8 * (e >> 1), column 2 * tig + (e & 1).
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = m0 + wm + mt * 16 + g + 8 * h;
        const int col = n0 + wn + nt * 8 + 2 * tig;
        typename T::Acc* out = c + row * N + col;
        out[0] = acc[mt][nt][2 * h];
        out[1] = acc[mt][nt][2 * h + 1];
      }
}

// bt (N, K) = b (K, N)^T, int8, by 64 x 64 tiles through shared memory; K and N
// are multiples of 64. Each thread moves 4-byte words: 4 reads of b's rows,
// then 4 bytes of one column packed into one word of bt's row.
__global__ void __launch_bounds__(kThreads)
    transpose_kernel(const uint8_t* __restrict__ b, uint8_t* __restrict__ bt, int K, int N) {
  __shared__ uint32_t tile[64][64 / 4 + 1];  // [k][n / 4]
  const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  for (int i = threadIdx.x; i < 64 * 16; i += kThreads) {
    const int r = i / 16, w = i % 16;
    tile[r][w] = *reinterpret_cast<const uint32_t*>(b + (size_t)(k0 + r) * N + n0 + 4 * w);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 16; i += kThreads) {
    const int n = i / 16, w = i % 16;  // bt row n0 + n, bytes k0 + 4w ... + 3
    uint32_t v = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) v |= ((tile[4 * w + q][n / 4] >> (8 * (n % 4))) & 0xffu) << (8 * q);
    *reinterpret_cast<uint32_t*>(bt + (size_t)(n0 + n) * K + k0 + 4 * w) = v;
  }
}

template <class T, int BM, int BN, int BK, int WARPS_M, int WARPS_N>
int launch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t stream) {
  auto kern = mm_kernel<T, BM, BN, BK, WARPS_M, WARPS_N>;
  constexpr int smem = Smem<T, BM, BN, BK>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(N / BN, M / BM), kThreads, smem, stream>>>(
      static_cast<const char*>(a), static_cast<const char*>(b), static_cast<typename T::Acc*>(c), N, K);
  return (int)cudaGetLastError();
}

// The tile list: (bm, bn) with bk = 32 bf16 / 64 int8, and 64 x 128 with bk =
// 64 bf16 / 128 int8; warps 2 x 4 except 256 x 128 (4 x 2). Returns
// cudaErrorInvalidValue, and launches nothing, for a tile not in the list.
template <class T>
int dispatch(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn, int bk,
             cudaStream_t st, bool launch_it = true) {
  constexpr int k1 = 64 / T::kSize, k2 = 128 / T::kSize;
  int (*fn)(const void*, const void*, void*, int, int, int, cudaStream_t) = nullptr;
  if (bm == 128 && bn == 128 && bk == k1) fn = launch<T, 128, 128, k1, 2, 4>;
  if (bm == 128 && bn == 256 && bk == k1) fn = launch<T, 128, 256, k1, 2, 4>;
  if (bm == 256 && bn == 128 && bk == k1) fn = launch<T, 256, 128, k1, 4, 2>;
  if (bm == 64 && bn == 128 && bk == k2) fn = launch<T, 64, 128, k2, 2, 4>;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return launch_it ? fn(a, b, c, M, N, K, st) : 0;
}

}  // namespace

extern "C" {

// c (M, N) = a (M, K) @ b (K, N), row-major and contiguous, 16-byte aligned:
// bf16 -> fp32 (is_int8 = 0), or int8 -> int32 with bt (N, K) int8 scratch
// for B's transpose. M, N, K multiples of the tile (bm, bn, bk), which must
// be in the list above. Returns the first cudaError_t of the launches (0 on
// success; cudaErrorInvalidValue for a tile not in the list).
int ihpr_probe_mm(const void* a, const void* b, void* bt, void* c, int M, int N, int K, int is_int8,
                  int bm, int bn, int bk, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (!is_int8) return dispatch<Bf16>(a, b, c, M, N, K, bm, bn, bk, st);
  const int known = dispatch<Int8>(a, bt, c, M, N, K, bm, bn, bk, st, false);
  if (known != 0) return known;
  transpose_kernel<<<dim3(N / 64, K / 64), kThreads, 0, st>>>(static_cast<const uint8_t*>(b),
                                                             static_cast<uint8_t*>(bt), K, N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return dispatch<Int8>(a, bt, c, M, N, K, bm, bn, bk, st);
}

}  // extern "C"
