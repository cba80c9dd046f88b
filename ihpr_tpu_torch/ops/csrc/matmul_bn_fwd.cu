// K5: Fused 1x1 conv (matmul) + BatchNorm statistics, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/matmul_bn.py:_fwd_kernel (launched by _fwd_call).
// bf16 runs the TMA + wgmma kernel of matmul_bn_hopper.cuh, fp32 (K5-fp32)
// the 3xTF32 wgmma kernel of matmul_bn_f32.cuh (what each computes, its
// design and what bounds it are described there), chosen by the operands'
// type. This file holds the C entry points that
// ihpr_tpu_torch/ops/matmul_bn.py loads with ctypes.

#include "matmul_bn_f32.cuh"
#include "matmul_bn_hopper.cuh"

extern "C" {

// Rows of the (rows, 2, N) fp32 s1/s2 partials of one forward call on the
// current device (one per CTA of a column chunk, per the card's SM count).
int ihpr_matmul_bn_fwd_groups(int M, int N, int is_bf16) {
  return is_bf16 ? mbh::row_groups(M, N, hopper::sm_count()) : mbf::row_groups(M, N, hopper::sm_count());
}

// x (M, K); w (K, N); y (M, N): contiguous, all bf16 (is_bf16) or all
// fp32. mul, add (K,) fp32, or both null for no prologue. Scratch: planes
// (2, N, K rounded up to 32) fp32 (fp32 only; null for bf16), part (parts,
// 2, N) fp32 with parts from ihpr_matmul_bn_fwd_groups; s (2, N) fp32 out =
// [s1; s2]. K and N are multiples of 8. Returns 0, the CUresult of a
// tensor-map encoding, or the first cudaError_t of the launches
// (cudaErrorInvalidValue for a wrong parts or missing planes).
int ihpr_matmul_bn_fwd(const void* x, const void* w, const float* mul, const float* add, void* y,
                       float* planes, float* part, int parts, float* s, int M, int K, int N, int is_bf16,
                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return mbh::launch_fwd(x, w, mul, add, y, part, parts, s, M, K, N, st);
  return mbf::launch_fwd(x, w, mul, add, y, planes, part, parts, s, M, K, N, st);
}

// The fp32 kernels' split pre-pass alone: w (K, N) fp32 -> planes (2, N,
// K rounded up to 32) (trans: K5-fp32's wt) or (2, K, N rounded up to 32)
// (K6-fp32's wn), what ops/matmul_bn.py:split_planes computes. Returns the
// launch's cudaError_t.
int ihpr_matmul_bn_split(const void* w, float* planes, int K, int N, int trans, void* stream) {
  return (int)mbf::split_w(static_cast<const float*>(w), planes, K, N, trans, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
