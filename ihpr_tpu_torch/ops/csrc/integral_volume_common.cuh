// Shared by the standalone integral kernels (K3 forward,
// integral_volume_fwd.cu; K4 backward, integral_volume_bwd.cu): how a CTA
// walks one sample's (HW, J*D) logits plane, and element loads and stores.
//
// Work split. Each row of the plane is J*D contiguous lanes, cut into
// vectors of VEC lanes (16 bytes where the row pitch and the base pointer
// allow it; the host picks VEC). A CTA takes one sample and one chunk of
// rows; its threads form a (ty, tx) grid: thread tx owns the vectors
// tx, tx + TX, ... (vpt of them) and, within the chunk, the rows
// ty, ty + TY, ... Neighbouring threads read neighbouring vectors of one
// row, so loads are coalesced whatever J and D are, and a thread keeps the
// same lanes (so the same joints and depth bins) for all of its rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ivol {

constexpr int kThreads = 256;       // most threads in a CTA
constexpr int kRowBatch = 8;        // rows loaded before any is used
constexpr int kMinChunkRows = 256;  // rows per CTA, at least (bounds K3's partials)
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct Layout {
  int vec;      // lanes per vector
  int nv;       // vectors per row (J*D / vec)
  int vpt;      // vectors per thread
  int tx, ty;   // thread grid; the CTA has tx * ty threads
  int chunk;    // rows per CTA (a multiple of ty * kRowBatch)
  int nchunks;  // CTAs per sample
};

inline Layout make_layout(int hw, int jd, int vec) {
  Layout L;
  L.vec = vec;
  L.nv = jd / vec;
  L.vpt = ceil_div(L.nv, kThreads);
  L.tx = ceil_div(L.nv, L.vpt);
  L.ty = kThreads / L.tx > 1 ? kThreads / L.tx : 1;
  const int rpt = ceil_div(ceil_div(kMinChunkRows, L.ty), kRowBatch) * kRowBatch;
  L.chunk = L.ty * rpt;
  L.nchunks = ceil_div(hw, L.chunk);
  return L;
}

// Storage: bf16 as its 16 raw bits (exact to fp32 by a shift), or fp32.
template <bool kBf16>
struct Elem;
template <>
struct Elem<true> {
  using S = uint16_t;
  static __device__ __forceinline__ float to_float(S v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  static __device__ __forceinline__ S from_float(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <>
struct Elem<false> {
  using S = float;
  static __device__ __forceinline__ float to_float(S v) { return v; }
  static __device__ __forceinline__ S from_float(float v) { return v; }
};

// VEC lanes moved as one aligned load or store.
template <typename S, int VEC>
struct alignas(sizeof(S) * VEC) Pack {
  S v[VEC];
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace ivol
