// K7: Fused stride-1 SAME 3x3 conv + BatchNorm statistics, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/conv_bn.py:_fwd_kernel (launched by _fwd_call).
// What it computes, its design and what bounds it: conv_bn_common.cuh
// (TAPS = 9). This file holds the C entry points that
// ihpr_tpu_torch/ops/conv_bn.py loads with ctypes.

#include "conv_bn_common.cuh"

extern "C" {

// Row groups of the forward: rows of the (groups, 2, N) fp32 partials.
int ihpr_conv_bn_fwd_groups(int M, int N) { return cbn::tile_groups(M, N); }

// x (B, H, W, K) NHWC, M = B*H*W; w (9, K, N); y (M, N): contiguous, all bf16 (is_bf16) or
// all fp32. mul, add (K,) fp32, or both null for no prologue. part
// (groups, 2, N) fp32 scratch; s (2, N) fp32 out = [s1; s2]. K and N are
// multiples of 8. Returns the first cudaError_t of the launches (0 on
// success).
int ihpr_conv_bn_fwd(const void* x, const void* w, const float* mul, const float* add, void* y,
                     float* part, float* s, int M, int H, int W, int K, int N, int is_bf16,
                     void* stream) {
  return cbn::launch_fwd<9>(x, w, mul, add, y, part, s, cbn::Geom{M, H, W}, K, N, is_bf16,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
