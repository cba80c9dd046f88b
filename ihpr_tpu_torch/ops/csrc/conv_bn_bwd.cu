// K8: Fused stride-1 SAME 3x3 conv + BatchNorm statistics, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/conv_bn.py:_bwd_kernel (launched by _bwd_call).
// bf16 runs the TMA + wgmma kernels of conv3_hopper.cuh, fp32 (K8-fp32) the
// 3xTF32 wgmma kernels of conv3_f32.cuh (what each computes, its design and
// what bounds it are described there), chosen by the operands' type. This
// file holds the C entry points that ihpr_tpu_torch/ops/conv_bn.py loads
// with ctypes.

#include "conv3_f32.cuh"
#include "conv3_hopper.cuh"

extern "C" {

// Rows of the (rows, 2, K) fp32 dmul/dadd partials of one backward call on
// B images of H x W (fp32: per the current device's SM count).
int ihpr_conv_bn_bwd_dx_partials(int B, int H, int W, int K, int is_bf16) {
  const c3::Geo g(B, H, W);
  return is_bf16 ? g.tiles(2 * g.bh) : c3f::dx_partials(g, K, hopper::sm_count());
}

// Rows of the (rows, 9, K, N) fp32 dw partials of one backward call on the
// current device (ranges of pixel tiles, one dw CTA per SM's share).
int ihpr_conv_bn_bwd_dw_partials(int B, int H, int W, int K, int N, int is_bf16) {
  const c3::Geo g(B, H, W);
  const int sms = hopper::sm_count();
  return is_bf16 ? c3::dw_ranges(g, K, N, sms) : c3f::dw_ranges(g, K, N, sms);
}

// x (B, H, W, K) NHWC; w (9, K, N); y, dy (B, H, W, N): contiguous, all
// bf16 (is_bf16) or all fp32. mul, add (K,) fp32, or both null for no
// prologue. ds (2, N) fp32 = [ds1; ds2]. Scratch: bf16, a (B*H*W, K) bf16
// with mul (else null) and gc (B*H*W, N) bf16; fp32, w's split planes (9,
// 2, K, N rounded up to 32) and g (B*H*W, N), both fp32. part_x (parts_x,
// 2, K) and part_w (parts_w, 9, K, N) fp32 with the counts above. Out: dx
// (B, H, W, K) in x's dtype, dw (9, K, N) fp32, dmd (2, K) fp32 = [dmul;
// dadd] (written with the prologue only). K and N are multiples of 8.
// Returns 0, the CUresult of a tensor-map encoding, or the first
// cudaError_t of the launches (cudaErrorInvalidValue for wrong counts or
// missing scratch).
int ihpr_conv_bn_bwd(const void* x, const void* w, const float* mul, const float* add,
                     const void* y, const void* dy, const float* ds, void* scratch, void* gc, void* dx,
                     float* dw, float* dmd, float* part_x, int parts_x, float* part_w, int parts_w,
                     int B, int H, int W, int K, int N, int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return c3::launch_bwd(x, w, mul, add, y, dy, ds, scratch, gc, dx, dw, dmd, part_x, parts_x, part_w,
                          parts_w, B, H, W, K, N, st);
  return c3f::launch_bwd(x, w, mul, add, y, dy, ds, static_cast<float*>(scratch), static_cast<float*>(gc), dx, dw,
                         dmd, part_x, parts_x, part_w, parts_w, B, H, W, K, N, st);
}

}  // extern "C"
