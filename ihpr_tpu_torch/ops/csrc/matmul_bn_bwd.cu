// K6: Fused 1x1 conv (matmul) + BatchNorm statistics, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/matmul_bn.py:_bwd_kernel (launched by _bwd_call).
// bf16 runs the TMA + wgmma kernels of matmul_bn_hopper.cuh, fp32 (K6-fp32)
// the 3xTF32 wgmma kernels of matmul_bn_f32.cuh (what they compute, their
// design and what bounds them are described there), chosen by the operands'
// type. This file holds the C entry points that
// ihpr_tpu_torch/ops/matmul_bn.py loads with ctypes.

#include "matmul_bn_f32.cuh"
#include "matmul_bn_hopper.cuh"

extern "C" {

// Rows of the (rows, 2, K) fp32 dmul/dadd partials of one backward call on
// the current device (one per CTA of the kernel that writes them).
int ihpr_matmul_bn_bwd_dx_partials(int M, int K, int N, int is_bf16) {
  const int sms = hopper::sm_count();
  return is_bf16 ? mbh::dx_partials(M, K, N, sms) : mbf::dx_partials(M, K, sms);
}

// Rows of the (rows, K, N) fp32 dw partials of one backward call on the
// current device (ranges of row tiles, one CTA per SM's share).
int ihpr_matmul_bn_bwd_dw_partials(int M, int K, int N, int is_bf16) {
  const int sms = hopper::sm_count();
  return is_bf16 ? mbh::dw_partials(M, K, N, sms) : mbf::dw_partials(M, K, N, sms);
}

// x (M, K); w (K, N); y, dy (M, N): contiguous, all bf16 (is_bf16) or all
// fp32. mul, add (K,) fp32, or both null for no prologue. ds (2, N) fp32 =
// [ds1; ds2]. Scratch: planes (2, K, N rounded up to 32) fp32 (fp32 only;
// null for bf16), part_x (parts_x, 2, K) and part_w (parts_w, K, N) fp32
// with the counts above. Out: dx (M, K) in x's dtype, dw (K, N) fp32, dmd
// (2, K) fp32 = [dmul; dadd] (written with the prologue only). K and N are
// multiples of 8. Returns 0, the CUresult of a tensor-map encoding, or the
// first cudaError_t of the launches (cudaErrorInvalidValue for wrong counts
// or missing planes).
int ihpr_matmul_bn_bwd(const void* x, const void* w, const float* mul, const float* add,
                       const void* y, const void* dy, const float* ds, float* planes, void* dx,
                       float* dw, float* dmd, float* part_x, int parts_x, float* part_w,
                       int parts_w, int M, int K, int N, int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return mbh::launch_bwd(x, w, mul, add, y, dy, ds, dx, dw, dmd, part_x, parts_x, part_w, parts_w,
                           M, K, N, st);
  return mbf::launch_bwd(x, w, mul, add, y, dy, ds, planes, dx, dw, dmd, part_x, parts_x, part_w, parts_w,
                         M, K, N, st);
}

}  // extern "C"
