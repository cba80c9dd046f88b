// Hopper (sm_90a) building blocks of the fused head kernels K1/K2
// (fused_head_integral_fwd.cu, fused_head_integral_bwd.cu) and their fp32
// instances (fused_head_f32.cuh), the conv + BN-statistics kernels K5/K6
// (matmul_bn_hopper.cuh; fp32 matmul_bn_f32.cuh) and K7/K8
// (conv3_hopper.cuh; fp32 conv3_f32.cuh), and the matmul probe P2
// (probe_mm.cu): TMA tensor maps (bf16, fp32 or 8-bit; 2-D, 3-D, and the
// 4-D NHWC map whose shifted boxes make a 3x3 conv's taps) and
// loads, mbarriers, wgmma shared-memory descriptors and the wgmma shapes
// those kernels issue (bf16 -> fp32, TF32 -> fp32 with A from shared memory
// or registers, s8 -> s32), warpgroup register reallocation and named
// barriers, and the fixed-order column sums of an accumulator (K5's and
// K7's s1/s2). Everything here is plain PTX; no library kernel is called.
//
// Shared-memory tiles are 64 rows of 128 bytes (64 bf16 or 128 int8) with
// the 128-byte swizzle that TMA writes (16-byte chunk i of row r lands at
// chunk i ^ (r % 8)), and start 1024-byte aligned. One bf16 tile serves
// wgmma both ways:
//   K-major  (rows are M or N, the 64 columns are K): desc_sw128(tile, 16, 1024),
//            k-step s (16 columns) at tile + 32 s bytes;
//   MN-major (rows are K, the 64 columns are M or N): desc_sw128(tile, lbo, 1024),
//            k-step s (16 rows) at tile + 2048 s bytes; lbo is the distance to
//            the next 64-wide block along M or N (unused for a 64-wide operand;
//            a 128- or 256-wide B is two or four 64-row boxes, lbo = 8192).
// A wider K-major B is its 64-row boxes stacked (256 rows for n256), same
// descriptor. An int8 tile is K-major only (8-bit wgmma takes no transposed
// operand); its k-step (32 int8) is the same 32 bytes. So is an fp32 tile
// (64 rows of 32 values) read as TF32: K-major only, a k-step of 8 values.
// A kernel may rewrite a tile in place between the TMA load and the wgmma
// that reads it: byte (r, 16 i + b) of the tile holds column 8 (i ^ (r % 8))
// + b / 2 of row r (bf16), and the writes are ordered before the wgmma by
// fence_proxy_async and a barrier.
// tests/test_torch_kernels.py holds each mode against torch.matmul through
// hopper_selftest.cu.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// --- host: TMA tensor maps -----------------------------------------------------

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// SMs of the current device (132 on an H100 SXM where the query fails): the
// kernels' persistent grids and partial counts follow it.
inline int sm_count() {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda function) through the runtime's
// entry-point query, so the libraries need not link libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor of `rank` (2-4) dimensions of bf16 or (type UINT8) 8-bit elements
// (dims innermost first, byte strides of dimensions 1.. in strides) read in
// boxes of 128 bytes x box[1] (x box[2]) with the 128-byte swizzle. Elements
// outside dims read as 0. Returns 0, or the CUresult of the encoding
// (cudaErrorSymbolNotFound without the entry point).
inline int make_tmap(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                     const uint64_t* strides, const uint32_t* box,
                     CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank,
                        const_cast<void*>(base), reinterpret_cast<const cuuint64_t*>(dims),
                        reinterpret_cast<const cuuint64_t*>(strides),
                        reinterpret_cast<const cuuint32_t*>(box), elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return (int)r;
}

constexpr int kBox = 64;                    // rows and bf16 columns of one TMA box
constexpr int kBoxBytes = kBox * kBox * 2;  // 8192: one 64 x 64 swizzled tile

// A row-major (rows, cols) bf16 matrix in 64 x 64 boxes; cols % 8 == 0.
inline int tmap_matrix(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {cols * 2};
  const uint32_t box[2] = {kBox, kBox};
  return make_tmap(map, base, 2, dims, strides, box);
}

// A row-major (rows, cols) int8 matrix in boxes of 128 columns x 64 rows
// (the same 8192-byte swizzled tile); cols % 16 == 0.
inline int tmap_matrix_s8(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {cols};
  const uint32_t box[2] = {2 * kBox, kBox};
  return make_tmap(map, base, 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
}

// A (batch, rows, cols) bf16 tensor in 64 x 64 x 1 boxes: a box that runs
// past `rows` reads zeros, not the next batch entry's rows.
inline int tmap_batched(CUtensorMap* map, const void* base, uint64_t batch, uint64_t rows,
                        uint64_t cols) {
  const uint64_t dims[3] = {cols, rows, batch}, strides[2] = {cols * 2, cols * rows * 2};
  const uint32_t box[3] = {kBox, kBox, 1};
  return make_tmap(map, base, 3, dims, strides, box);
}

// A row-major (rows, cols) fp32 matrix in boxes of 32 columns x 64 rows:
// one box is the same 8192-byte swizzled tile (128-byte rows of 32 fp32);
// cols % 4 == 0.
inline int tmap_matrix_f32(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {cols * 4};
  const uint32_t box[2] = {kBox / 2, kBox};
  return make_tmap(map, base, 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// A (batch, rows, cols) fp32 tensor in 32 x 64 x 1 boxes: a box that runs
// past `rows` reads zeros, not the next batch entry's rows.
inline int tmap_batched_f32(CUtensorMap* map, const void* base, uint64_t batch, uint64_t rows,
                            uint64_t cols) {
  const uint64_t dims[3] = {cols, rows, batch}, strides[2] = {cols * 4, cols * rows * 4};
  const uint32_t box[3] = {kBox / 2, kBox, 1};
  return make_tmap(map, base, 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// An NHWC (batch, height, width, channels) bf16 tensor in boxes of 64
// channels x bw columns x bh rows x 1 image: one box lands as a 64-row tile
// (bw * bh = 64, row r = pixel (r / bw, r % bw) of the box) with the 128-byte
// swizzle. A box may start at negative or past-the-end coordinates: every
// pixel or channel outside the tensor reads 0, which is a 3x3 conv's SAME
// padding. channels % 8 == 0 (TMA's 16-byte pitch).
inline int tmap_nhwc(CUtensorMap* map, const void* base, uint64_t batch, uint64_t height,
                     uint64_t width, uint64_t channels, uint32_t bw, uint32_t bh) {
  const uint64_t dims[4] = {channels, width, height, batch};
  const uint64_t strides[3] = {channels * 2, width * channels * 2, height * width * channels * 2};
  const uint32_t box[4] = {kBox, bw, bh, 1};
  return make_tmap(map, base, 4, dims, strides, box);
}

// The same NHWC map over fp32 (K7-fp32 / K8-fp32): boxes of 32 channels x
// bw columns x bh rows x 1 image land as one 64-row x 128-byte tile with
// the 128-byte swizzle (the tile tmap_matrix_f32's boxes make); pixels or
// channels outside the tensor read 0. channels % 4 == 0 (TMA's 16-byte
// pitch).
inline int tmap_nhwc_f32(CUtensorMap* map, const void* base, uint64_t batch, uint64_t height, uint64_t width,
                         uint64_t channels, uint32_t bw, uint32_t bh) {
  const uint64_t dims[4] = {channels, width, height, batch};
  const uint64_t strides[3] = {channels * 4, width * channels * 4, height * width * channels * 4};
  const uint32_t box[4] = {kBox / 2, bw, bh, 1};
  return make_tmap(map, base, 4, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// --- device: barriers, TMA -------------------------------------------------------

// The dynamic shared memory rounded up to 1024 bytes, the 128-byte
// swizzle's alignment (launches ask for 1024 bytes more than they use).
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                          ~uintptr_t(1023));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// Makes the barrier inits visible to the async proxy (TMA) and to the CTA.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA transfers on the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A fresh barrier
// counts as having completed parity 1, so a producer's first wait on an
// empty slot (parity 1) passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Box at (c0, c1, c2, c3), innermost first; coordinates may be negative.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Stores the 2-D box at smem to (c0, c1) of `map`; elements outside the
// tensor are not written. Tracked by this thread's bulk groups.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* smem, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(smem)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Waits until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Eight fp32 values from p (16-byte aligned), through the read-only cache.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p)), hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma operands written with st.shared, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- device: wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (call after wgmma_wait, before wgmma_fence).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The accumulator of an m64nN wgmma, per thread (warp w of the warpgroup,
// lane l, g = l / 4, tig = l % 4): d[4 i + e] is row 16 w + g + 8 (e >> 1),
// column 8 i + 2 tig + (e & 1), the mma.sync m16n8 layout of each warp.

// d (m64 x n64) += A (smem, descriptor da) * B (smem, descriptor db);
// TA / TB: 1 when that operand is MN-major (transposed), 0 when K-major.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (m64 x n128) += A (smem, descriptor da) * B (smem, descriptor db);
// TA / TB: 1 when that operand is MN-major (transposed), 0 when K-major.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (m64 x n192) += A (smem, descriptor da) * B (smem, descriptor db);
// TA / TB: 1 when that operand is MN-major (transposed), 0 when K-major.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (m64 x n256) += A (smem, descriptor da) * B (smem, descriptor db);
// TA / TB: 1 when that operand is MN-major (transposed), 0 when K-major.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (m64 x nN) += A * B for N = 64, 128 or 256.
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma width");
  if constexpr (N == 64)
    mma_ss_n64<TA, TB>(d, da, db);
  else if constexpr (N == 128)
    mma_ss_n128<TA, TB>(d, da, db);
  else
    mma_ss_n256<TA, TB>(d, da, db);
}

// d (m64 x n128, s32) += A (smem, descriptor da) * B (smem, descriptor db), s8
// operands, both K-major (8-bit wgmma has no transposed mode).
__device__ __forceinline__ void mma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x n256, s32) += A (smem, descriptor da) * B (smem, descriptor db), s8
// operands, both K-major (8-bit wgmma has no transposed mode).
__device__ __forceinline__ void mma_s8_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x n64) += A (registers, the m16n8k16 A fragment of each warp's
// 16 rows) * B (smem, descriptor db, MN-major).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --- device: TF32 wgmma (K1-fp32 / K2-fp32) ------------------------------------------

// d (m64 x n32) += A (smem, descriptor da) * B (smem, descriptor db), TF32
// operands (the low 13 bits of each 32-bit value are ignored), both K-major.
__device__ __forceinline__ void mma_tf32_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x n32) += A (registers: each warp's 16 rows in the m16n8k8 TF32 A
// layout, a[0] = A(g, t), a[1] = A(g + 8, t), a[2] = A(g, t + 4), a[3] =
// A(g + 8, t + 4)) * B (smem, descriptor db, K-major), TF32 operands.
__device__ __forceinline__ void mma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n64) += A (smem, descriptor da) * B (smem, descriptor db), TF32
// operands (the low 13 bits of each 32-bit value are ignored), both K-major.
__device__ __forceinline__ void mma_tf32_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x n64) += A (registers: each warp's 16 rows in the m16n8k8 TF32 A
// layout, a[0] = A(g, t), a[1] = A(g + 8, t), a[2] = A(g, t + 4), a[3] =
// A(g + 8, t + 4)) * B (smem, descriptor db, K-major), TF32 operands.
__device__ __forceinline__ void mma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// --- device: column sums of wgmma accumulators (K5's and K7's s1/s2) ----------------

// Column sums of chunks i and i + 1 (8 columns each) of an m64 accumulator:
// a[4 h + e] holds this thread's sum over its two rows, for chunk i + h at
// columns 8 (i + h) + 2 tig (+1), of the first quantity (e = 0, 1) and the
// second (e = 2, 3). A reduce-scatter over the warp's 8 row groups (7
// shuffles, in a fixed order) leaves lane 4 g + tig with value g of the 8,
// which it writes (ADD: adds) to the warp's slot red[(2 warp + q) cols + c]
// of its quantity q and column c.
template <bool ADD = false>
__device__ __forceinline__ void stage_colsums(float* red, int cols, int warp, int i, int lane,
                                              const float (&a)[8]) {
  const int g = lane >> 2, tig = lane & 3;
  const bool hi2 = g & 4, hi1 = g & 2, hi0 = g & 1;
  float b[4], c[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)  // keep values 4 hi2 ..., send the others to lane ^ 16
    b[k] = (hi2 ? a[k + 4] : a[k]) + __shfl_xor_sync(0xffffffffu, hi2 ? a[k] : a[k + 4], 16);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    c[k] = (hi1 ? b[k + 2] : b[k]) + __shfl_xor_sync(0xffffffffu, hi1 ? b[k] : b[k + 2], 8);
  const float v = (hi0 ? c[1] : c[0]) + __shfl_xor_sync(0xffffffffu, hi0 ? c[0] : c[1], 4);
  float* slot = red + (2 * warp + ((g >> 1) & 1)) * cols + 8 * (i + (g >> 2)) + 2 * tig + (g & 1);
  *slot = ADD ? *slot + v : v;
}

// The staged sums of the 8 consumer warps (256 threads, ctid 0 ... 255),
// added in warp order, into the partial row part[row] = [first (ncols);
// second (ncols)], columns col0 + ctid for ctid < cols.
__device__ __forceinline__ void write_colsums(const float* red, int cols, int ctid, float* __restrict__ part,
                                              int row, int col0, int ncols) {
  named_barrier(1, 256);
  const int c = col0 + ctid;
  if (ctid < cols && c < ncols) {
    float u = red[ctid], v = red[cols + ctid];
    for (int w = 1; w < 8; ++w) u += red[(w * 2) * cols + ctid], v += red[(w * 2 + 1) * cols + ctid];
    float* out = part + (size_t)row * 2 * ncols + c;
    out[0] = u;
    out[ncols] = v;
  }
}

}  // namespace hopper
