// K6: Fused 1x1 conv (matmul) + BatchNorm statistics, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/matmul_bn.py:_bwd_kernel (launched by _bwd_call).
// What it computes, its design and what bounds it: conv_bn_common.cuh
// (TAPS = 1). This file holds the C entry points that
// ihpr_tpu_torch/ops/matmul_bn.py loads with ctypes.

#include "conv_bn_common.cuh"

extern "C" {

// Row groups of the dx kernel (rows of the (groups, 2, K) dmul/dadd
// partials) and of the dw kernel (rows of the (groups, 1, K, N) dw partials).
int ihpr_matmul_bn_bwd_dx_groups(int M, int K) { return cbn::tile_groups(M, K); }
int ihpr_matmul_bn_bwd_dw_groups(int M, int K, int N) { return cbn::dw_groups(M, K, N, 1); }

// x (M, K); w (1, K, N); y, dy (M, N): contiguous, all bf16 (is_bf16) or
// all fp32. mul, add (K,) fp32, or both null for no prologue. ds (2, N) fp32
// = [ds1; ds2]. Scratch: gc (M, N) in x's dtype, part_x and part_w fp32 as
// counted above. Out: dx (M, K) in x's dtype, dw (1, K, N) fp32, dmd
// (2, K) fp32 = [dmul; dadd] (written with the prologue only). K and N are
// multiples of 8. Returns the first cudaError_t of the launches.
int ihpr_matmul_bn_bwd(const void* x, const void* w, const float* mul, const float* add,
                       const void* y, const void* dy, const float* ds, void* gc, void* dx,
                       float* dw, float* dmd, float* part_x, float* part_w, int M, int H, int W,
                       int K, int N, int is_bf16, void* stream) {
  return cbn::launch_bwd<1>(x, w, mul, add, y, dy, ds, gc, dx, dw, dmd, part_x, part_w,
                            cbn::Geom{M, H, W}, K, N, is_bf16,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
