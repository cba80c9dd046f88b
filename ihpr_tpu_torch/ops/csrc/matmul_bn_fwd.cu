// K5: Fused 1x1 conv (matmul) + BatchNorm statistics, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/matmul_bn.py:_fwd_kernel (launched by _fwd_call).
// bf16 runs the TMA + wgmma kernel of matmul_bn_hopper.cuh (what it
// computes, its design and what bounds it are described there); fp32 runs
// the FMA kernel of conv_bn_common.cuh (TAPS = 1), chosen by the operands'
// type. This file holds the C entry points that
// ihpr_tpu_torch/ops/matmul_bn.py loads with ctypes.

#include "matmul_bn_hopper.cuh"

extern "C" {

// Rows of the (rows, 2, N) fp32 s1/s2 partials of one forward call on the
// current device (bf16: one per CTA of a column chunk, per the card's SM
// count).
int ihpr_matmul_bn_fwd_groups(int M, int N, int is_bf16) {
  return is_bf16 ? mbh::row_groups(M, N, hopper::sm_count()) : cbn::tile_groups(M, N);
}

// x (M, K); w (K, N); y (M, N): contiguous, all bf16 (is_bf16) or all
// fp32. mul, add (K,) fp32, or both null for no prologue. part (parts, 2,
// N) fp32 scratch with parts from ihpr_matmul_bn_fwd_groups; s (2, N) fp32
// out = [s1; s2]. K and N are multiples of 8. Returns 0, the CUresult of a
// tensor-map encoding, or the first cudaError_t of the launches
// (cudaErrorInvalidValue for a wrong parts).
int ihpr_matmul_bn_fwd(const void* x, const void* w, const float* mul, const float* add, void* y,
                       float* part, int parts, float* s, int M, int K, int N, int is_bf16,
                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return mbh::launch_fwd(x, w, mul, add, y, part, parts, s, M, K, N, st);
  if (parts != cbn::tile_groups(M, N)) return (int)cudaErrorInvalidValue;
  const cbn::Geom g{M, 1, 1};
  return mul ? cbn::launch_fwd_t<float, 1, true>(x, w, mul, add, y, part, s, g, K, N, st)
             : cbn::launch_fwd_t<float, 1, false>(x, w, mul, add, y, part, s, g, K, N, st);
}

}  // extern "C"
