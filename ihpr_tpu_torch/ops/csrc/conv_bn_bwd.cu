// K8: Fused stride-1 SAME 3x3 conv + BatchNorm statistics, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/conv_bn.py:_bwd_kernel (launched by _bwd_call).
// bf16 runs the TMA + wgmma kernels of conv3_hopper.cuh (what they compute,
// their design and what bounds them are described there); fp32 runs the FMA
// kernels of conv_bn_common.cuh (TAPS = 9), chosen by the operands' type.
// This file holds the C entry points that ihpr_tpu_torch/ops/conv_bn.py
// loads with ctypes.

#include "conv3_hopper.cuh"

extern "C" {

// Rows of the (rows, 2, K) fp32 dmul/dadd partials of one backward call on
// B images of H x W.
int ihpr_conv_bn_bwd_dx_partials(int B, int H, int W, int K, int is_bf16) {
  if (!is_bf16) return cbn::tile_groups(B * H * W, K);
  const c3::Geo g(B, H, W);
  return g.tiles(2 * g.bh);
}

// Rows of the (rows, 9, K, N) fp32 dw partials of one backward call on the
// current device (bf16: ranges of pixel tiles, one dw CTA per SM's share).
int ihpr_conv_bn_bwd_dw_partials(int B, int H, int W, int K, int N, int is_bf16) {
  if (!is_bf16) return cbn::dw_groups(B * H * W, K, N, 9);
  return c3::dw_ranges(c3::Geo(B, H, W), K, N, hopper::sm_count());
}

// x (B, H, W, K) NHWC; w (9, K, N); y, dy (B, H, W, N): contiguous, all
// bf16 (is_bf16) or all fp32. mul, add (K,) fp32, or both null for no
// prologue. ds (2, N) fp32 = [ds1; ds2]. Scratch: a (B*H*W, K) bf16 (bf16
// with mul only, else null), gc (B*H*W, N) in x's dtype, part_x (parts_x, 2,
// K) and part_w (parts_w, 9, K, N) fp32 with the counts above. Out: dx (B,
// H, W, K) in x's dtype, dw (9, K, N) fp32, dmd (2, K) fp32 = [dmul; dadd]
// (written with the prologue only). K and N are multiples of 8. Returns 0,
// the CUresult of a tensor-map encoding, or the first cudaError_t of the
// launches (cudaErrorInvalidValue for wrong counts or a missing a).
int ihpr_conv_bn_bwd(const void* x, const void* w, const float* mul, const float* add,
                     const void* y, const void* dy, const float* ds, void* a, void* gc, void* dx,
                     float* dw, float* dmd, float* part_x, int parts_x, float* part_w, int parts_w,
                     int B, int H, int W, int K, int N, int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return c3::launch_bwd(x, w, mul, add, y, dy, ds, a, gc, dx, dw, dmd, part_x, parts_x, part_w,
                          parts_w, B, H, W, K, N, st);
  const int M = B * H * W;
  if (parts_x != cbn::tile_groups(M, K) || parts_w != cbn::dw_groups(M, K, N, 9))
    return (int)cudaErrorInvalidValue;
  const cbn::Geom g{M, H, W};
  return mul ? cbn::launch_bwd_t<float, 9, true>(x, w, mul, add, y, dy, ds, gc, dx, dw, dmd, part_x,
                                                 part_w, g, K, N, st)
             : cbn::launch_bwd_t<float, 9, false>(x, w, mul, add, y, dy, ds, gc, dx, dw, dmd,
                                                  part_x, part_w, g, K, N, st);
}

}  // extern "C"
