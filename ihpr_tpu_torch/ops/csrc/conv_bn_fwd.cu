// K7: Fused stride-1 SAME 3x3 conv + BatchNorm statistics, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/conv_bn.py:_fwd_kernel (launched by _fwd_call).
// bf16 runs the TMA + wgmma kernels of conv3_hopper.cuh (what they compute,
// their design and what bounds them are described there); fp32 runs the FMA
// kernels of conv_bn_common.cuh (TAPS = 9), chosen by the operands' type.
// This file holds the C entry points that ihpr_tpu_torch/ops/conv_bn.py
// loads with ctypes.

#include "conv3_hopper.cuh"

extern "C" {

// Rows of the (rows, 2, N) fp32 statistics partials of one forward call on
// B images of H x W.
int ihpr_conv_bn_fwd_partials(int B, int H, int W, int N, int is_bf16) {
  if (!is_bf16) return cbn::tile_groups(B * H * W, N);
  const c3::Geo g(B, H, W);
  return g.tiles(2 * g.bh);
}

// x (B, H, W, K) NHWC; w (9, K, N); y (B, H, W, N): contiguous, all bf16
// (is_bf16) or all fp32. mul, add (K,) fp32, or both null for no prologue.
// Scratch: a (B*H*W, K) bf16 (bf16 with mul only, else null), part (parts,
// 2, N) fp32 with parts from ihpr_conv_bn_fwd_partials. Out: s (2, N) fp32 =
// [s1; s2]. K and N are multiples of 8. Returns 0, the CUresult of a
// tensor-map encoding, or the first cudaError_t of the launches
// (cudaErrorInvalidValue for a wrong parts or a missing a).
int ihpr_conv_bn_fwd(const void* x, const void* w, const float* mul, const float* add, void* a,
                     void* y, float* part, int parts, float* s, int B, int H, int W, int K, int N,
                     int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return c3::launch_fwd(x, w, mul, add, a, y, part, parts, s, B, H, W, K, N, st);
  const int M = B * H * W;
  if (parts != cbn::tile_groups(M, N)) return (int)cudaErrorInvalidValue;
  const cbn::Geom g{M, H, W};
  return mul ? cbn::launch_fwd_t<float, 9, true>(x, w, mul, add, y, part, s, g, K, N, st)
             : cbn::launch_fwd_t<float, 9, false>(x, w, mul, add, y, part, s, g, K, N, st);
}

}  // extern "C"
