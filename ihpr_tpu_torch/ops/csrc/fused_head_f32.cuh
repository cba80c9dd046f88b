// What the fp32 fused head kernels share (K1-fp32,
// fused_head_integral_fwd_f32.cu; K2-fp32, fused_head_integral_bwd_f32.cu):
// the split pre-pass of the weights, the channel and bin orders of its
// planes, the A fragments a warpgroup splits in registers, and 3xTF32 on
// wgmma.
//
// 3xTF32 on wgmma. wgmma takes TF32 operands from shared memory only
// K-major, and A may come from registers. Every product of K1/K2-fp32 is
//     d += A_lo B_hi + A_hi B_lo + A_hi B_hi     (tf32x3.cuh's split)
// with A's hi and lo parts split in registers and B's read from two
// shared-memory planes that hold TF32 bit patterns (the tensor cores ignore
// an fp32 value's low 13 bits; the planes have them zero, so nothing is
// truncated).
//
// The pre-pass (split_planes_kernel) splits W (C, J*D) once per call into
// two layouts, each a hi plane followed by a lo plane, every joint padded to
// kBins bins (zeros past D):
//   Wt planes (2, J*64, C): K-major over channels, B of the logits
//     S = F Wt_j^T. Within each 32-channel block position p holds channel
//     perm32(p): k-step s (8 positions) slot q is channel 8 (q % 4) + 2 s +
//     q / 4, so that thread t of a warp finds its A values of all four
//     k-steps of the block in channels 8t ... 8t + 7 of a feature row, two
//     16-byte loads (load_a below).
//   W planes (2, C, J*64): K-major over bins, B of dfeat += dv W_j. Within
//     each 8-bin group position q holds bin perm8(q) = 2 (q % 4) + q / 4:
//     tf32x3::as_a turns an accumulator tile into an A fragment by
//     relabelling k so that slot t is bin 2t and slot t + 4 is bin 2t + 1.
// tests/test_torch_kernels.py holds the pre-pass bitwise against
// ops/fused_head_integral.py:split_planes, and hopper_selftest.cu each
// operand mode against float64.
//
// Stripped builds, for timing only (ihpr_tpu_torch/tools/f32_breakdown.py;
// their results are wrong): -DIHPR_F32_NO_SPLIT passes A's raw bits as hi
// and zero as lo (the three passes still run), -DIHPR_F32_ONE_PASS runs the
// hi*hi pass alone, -DIHPR_F32_NO_EXP takes the softmax's and dv's ex2 out
// (f32_ex2); -DIHPR_F32_ONE_PART gives K1-fp32 whole samples a CTA (its
// results stay right).

#pragma once

#include "fused_head_common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace f32h {

using namespace hopper;

constexpr int kBins = 64;               // depth bins of a joint's slab
constexpr int kKb = 32;                 // fp32 values of a 128-byte row: one k-block
constexpr int kTile = kBox * 128;       // one 64-row x 128-byte swizzled tile

__host__ __device__ constexpr int perm32(int p) { return 8 * (p & 3) + 2 * (p >> 3) + ((p >> 2) & 1); }
__host__ __device__ constexpr int inv32(int c) { return 8 * ((c & 7) >> 1) + (c >> 3) + 4 * (c & 1); }
__host__ __device__ constexpr int inv8(int z) { return (z >> 1) + 4 * (z & 1); }

// W (C, J*D) -> wt (2, J*64, C) and, with w_out, w (2, C, J*64): hi and lo
// TF32 planes in the orders above. Blocks of 32 x 8 threads over tiles of
// 32 channels x 32 padded bins, read and written 32 values a row.
__global__ void split_planes_kernel(const float* __restrict__ w, float* __restrict__ wt,
                                    float* __restrict__ w_out, int C, int J, int D) {
  __shared__ uint32_t tile[2][32][33];  // [plane][channel][bin]
  const int n0 = blockIdx.x * 32, c0 = blockIdx.y * 32, jd = J * kBins;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, n = n0 + threadIdx.x, z = n % kBins;
    uint32_t hi = 0, lo = 0;
    if (c < C && n < jd && z < D) tf32x3::split(w[(size_t)c * J * D + (n / kBins) * D + z], hi, lo);
    tile[0][i][threadIdx.x] = hi;
    tile[1][i][threadIdx.x] = lo;
    if (w_out && c < C && n < jd) {
      const int q = (n & ~7) + inv8(n & 7);
      reinterpret_cast<uint32_t*>(w_out)[(size_t)c * jd + q] = hi;
      reinterpret_cast<uint32_t*>(w_out)[((size_t)C + c) * jd + q] = lo;
    }
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, c = c0 + threadIdx.x;
    if (n < jd && c < C) {
      const int p = (c & ~31) + inv32(c & 31);
      reinterpret_cast<uint32_t*>(wt)[(size_t)n * C + p] = tile[0][threadIdx.x][i];
      reinterpret_cast<uint32_t*>(wt)[((size_t)jd + n) * C + p] = tile[1][threadIdx.x][i];
    }
  }
}

inline cudaError_t split_planes(const float* w, float* wt, float* w_out, int C, int J, int D, cudaStream_t st) {
  split_planes_kernel<<<dim3(J * kBins / 32, (C + 31) / 32), dim3(32, 8), 0, st>>>(w, wt, w_out, C, J, D);
  return cudaGetLastError();
}

// An A fragment split in registers (the kernels' split_a: stripped by
// IHPR_F32_NO_SPLIT).
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#ifdef IHPR_F32_NO_SPLIT
#pragma unroll
  for (int i = 0; i < 4; ++i) hi[i] = __float_as_uint(a[i]), lo[i] = 0u;
#else
  tf32x3::split(a, hi, lo);
#endif
}

// One value split (dw_kernel's dv^T planes; stripped likewise).
__device__ __forceinline__ void split_v(float x, uint32_t& hi, uint32_t& lo) {
#ifdef IHPR_F32_NO_SPLIT
  hi = __float_as_uint(x), lo = 0u;
#else
  tf32x3::split(x, hi, lo);
#endif
}

// 2^x for the softmax and dv (stripped by IHPR_F32_NO_EXP).
__device__ __forceinline__ float f32_ex2(float x) {
#ifdef IHPR_F32_NO_EXP
  return x;
#else
  return fhi::ex2(x);
#endif
}

// The A fragments (16 rows of warp wq, 32 channels) of a swizzled 64-row x
// 32-fp32 tile, split: k-step s takes channels 8t + 2s and 8t + 2s + 1 of
// rows 16 wq + g and + 8 (perm32's order, which the Wt planes follow), two
// 16-byte loads a row.
__device__ __forceinline__ void load_a(const unsigned char* tile, int wq, int g, int t, uint32_t (&ah)[4][4],
                                       uint32_t (&al)[4][4]) {
  float v[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wq * 16 + g + 8 * h;
    const unsigned char* row = tile + r * 128;
    const float4 x = *reinterpret_cast<const float4*>(row + (((2 * t) ^ (r & 7)) << 4));
    const float4 y = *reinterpret_cast<const float4*>(row + (((2 * t + 1) ^ (r & 7)) << 4));
    v[h][0] = x.x, v[h][1] = x.y, v[h][2] = x.z, v[h][3] = x.w;
    v[h][4] = y.x, v[h][5] = y.y, v[h][6] = y.z, v[h][7] = y.w;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float a[4] = {v[0][2 * s], v[1][2 * s], v[0][2 * s + 1], v[1][2 * s + 1]};
    split_a(a, ah[s], al[s]);
  }
}

// K-major descriptor of k-step s (8 fp32) of a swizzled tile.
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile, int s) {
  return desc_sw128(tile + s * 32, 16, 1024);
}

// d (m64 x nN) += A B in 3xTF32: A given split (registers), B's hi and lo
// planes by descriptor; the small products first.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint64_t bh, uint64_t bl) {
  static_assert(N == 32 || N == 64, "TF32 wgmma width");
#ifdef IHPR_F32_ONE_PASS
  if constexpr (N == 64)
    mma_tf32_rs_n64(d, ah, bh);
  else
    mma_tf32_rs_n32(d, ah, bh);
  return;
#endif
  if constexpr (N == 64) {
    mma_tf32_rs_n64(d, al, bh);
    mma_tf32_rs_n64(d, ah, bl);
    mma_tf32_rs_n64(d, ah, bh);
  } else {
    mma_tf32_rs_n32(d, al, bh);
    mma_tf32_rs_n32(d, ah, bl);
    mma_tf32_rs_n32(d, ah, bh);
  }
}

// The k-blocks kb = 0 ... nkb - 1 of a product whose A fetch(kb, ah, al)
// brings into registers, split, and issue(kb, ah, al) multiplies (wgmma
// fence, the block's wgmmas, one commit group), in two register buffers:
// each block's fetch runs while the block before it is multiplied, one
// group in flight behind the next; every group is complete on return.
// (K1-fp32's rows: 0.84 -> 0.70 ms at B = 32. In K2-fp32's kernels, whose
// accumulators hold more registers, the same pipelining timed slower.)
template <class Fetch, class Issue>
__device__ __forceinline__ void pipelined(int nkb, Fetch fetch, Issue issue) {
  uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];
  fetch(0, h0, l0);
  issue(0, h0, l0);
  for (int kb = 1; kb < nkb; kb += 2) {
    fetch(kb, h1, l1);
    issue(kb, h1, l1);
    wgmma_wait<1>();
    if (kb + 1 < nkb) {
      fetch(kb + 1, h0, l0);
      issue(kb + 1, h0, l0);
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Byte offset of fp32 element (r, k) of a swizzled tile of 128-byte rows.
__device__ __forceinline__ int swz(int r, int k) { return r * 128 + ((((k >> 2) ^ (r & 7))) << 4) + (k & 3) * 4; }

}  // namespace f32h
