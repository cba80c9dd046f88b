// K7: Fused stride-1 SAME 3x3 conv + BatchNorm statistics, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/conv_bn.py:_fwd_kernel (launched by _fwd_call).
// bf16 runs the TMA + wgmma kernels of conv3_hopper.cuh, fp32 (K7-fp32) the
// 3xTF32 wgmma kernels of conv3_f32.cuh (what each computes, its design and
// what bounds it are described there), chosen by the operands' type. This
// file holds the C entry points that ihpr_tpu_torch/ops/conv_bn.py loads
// with ctypes.

#include "conv3_f32.cuh"
#include "conv3_hopper.cuh"

extern "C" {

// Rows of the (rows, 2, N) fp32 statistics partials of one forward call on
// B images of H x W (fp32: per the current device's SM count).
int ihpr_conv_bn_fwd_partials(int B, int H, int W, int N, int is_bf16) {
  const c3::Geo g(B, H, W);
  return is_bf16 ? g.tiles(2 * g.bh) : c3f::fwd_partials(g, N, hopper::sm_count());
}

// x (B, H, W, K) NHWC; w (9, K, N); y (B, H, W, N): contiguous, all bf16
// (is_bf16) or all fp32. mul, add (K,) fp32, or both null for no prologue.
// Scratch: bf16, a (B*H*W, K) bf16 with mul, else null; fp32, w's split
// planes (9, 2, N, K rounded up to 32) fp32. part (parts, 2, N) fp32 with
// parts from ihpr_conv_bn_fwd_partials. Out: s (2, N) fp32 = [s1; s2]. K
// and N are multiples of 8. Returns 0, the CUresult of a tensor-map
// encoding, or the first cudaError_t of the launches (cudaErrorInvalidValue
// for a wrong parts or missing scratch).
int ihpr_conv_bn_fwd(const void* x, const void* w, const float* mul, const float* add, void* scratch,
                     void* y, float* part, int parts, float* s, int B, int H, int W, int K, int N,
                     int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return c3::launch_fwd(x, w, mul, add, scratch, y, part, parts, s, B, H, W, K, N, st);
  return c3f::launch_fwd(x, w, mul, add, y, static_cast<float*>(scratch), part, parts, s, B, H, W, K, N, st);
}

// The fp32 kernels' split pre-pass alone: w (9, K, N) fp32 -> planes (9, 2,
// N, K rounded up to 32) (trans: K7-fp32's wt) or (9, 2, K, N rounded up to
// 32) (K8-fp32's wn), what ops/conv_bn.py:split_planes computes. Returns
// the launch's cudaError_t.
int ihpr_conv_bn_split(const void* w, float* planes, int K, int N, int trans, void* stream) {
  return (int)mbf::split_w(static_cast<const float*>(w), planes, K, N, trans, static_cast<cudaStream_t>(stream), 9);
}

}  // extern "C"
