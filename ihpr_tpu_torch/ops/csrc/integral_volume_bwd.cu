// Integral soft-argmax over an existing logits volume, backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/integral_pallas.py:_bwd_kernel
// (launched by _bwd_call, body in _dv_from_rows).
//
// What it computes. For coords c = sum p g over a joint's softmax p, with
// cotangent (gx, gy, gz) per (sample, joint), the gradient of each logit is
//     dv = p * (gx (x - cx) + gy (y - cy) + gz (z - cz)),
// p = exp(v - (m + log s)) recomputed from K3's per-joint max m and
// normalizer s. The per-joint constants arrive folded, (batch, J, 8) fp32
// rows m + log s, gx, gy, gz, cx, cy, cz, 0 (fused_head_integral
// .fold_bwd_rows); s = 0 gives +inf and p = 0. One read of the volume, one
// write of dv in the volume's dtype (bf16 rounded to nearest even); fp32
// arithmetic.
//
// Design. Elementwise, laid out as K3 (integral_volume_common.cuh): a CTA
// per (row chunk, sample), coalesced vector loads and stores along each row,
// 8 rows in flight per thread. A thread keeps the same lanes for all of its
// rows, so it reads each lane's joint constants once and folds the depth
// term gz (z - cz) once; per logit it spends one ex2, two subtractions and
// two FMAs. No reduction, so the result does not depend on the launch.
//
// What differs from the TPU kernel. The TPU folds the constants into five
// (B, J*D) lane rows and forms the x/y term with a small matmul; here each
// thread reads its lanes' constants straight from the (B, J, 8) rows. Any J,
// D and HW are taken (no joint padding), and offsets are 64-bit.
//
// What bounds it on an H100. One read and one write of the volume: 2.42 GB
// moved in bf16 at (128, 4096, 1152), ~0.8 ms at 3 TB/s.

#include "integral_volume_common.cuh"

namespace {

using namespace ivol;

template <bool kBf16, int VEC>
__global__ void __launch_bounds__(kThreads)
    dv_kernel(const typename Elem<kBf16>::S* __restrict__ vol, const float* __restrict__ rows,
              typename Elem<kBf16>::S* __restrict__ dv, int hw, int width, int J, int D,
              Layout L) {
  using S = typename Elem<kBf16>::S;
  const int tx = threadIdx.x % L.tx, ty = threadIdx.x / L.tx;
  const int chunk = blockIdx.x, b = blockIdx.y, jd = J * D;
  const int r_begin = chunk * L.chunk, r_end = min(hw, r_begin + L.chunk);
  const size_t base = (size_t)b * hw * jd;
  const float* rows_b = rows + (size_t)b * J * 8;

  for (int k = 0; k < L.vpt; ++k) {
    const int v = tx + k * L.tx;
    if (v >= L.nv) break;
    float a[VEC], gx[VEC], gy[VEC], cx[VEC], cy[VEC], tz[VEC];
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const int lane = v * VEC + l, j = lane / D, z = lane - j * D;
      const float* rw = rows_b + j * 8;
      a[l] = rw[0], gx[l] = rw[1], gy[l] = rw[2], cx[l] = rw[4], cy[l] = rw[5];
      tz[l] = rw[3] * ((float)z - rw[6]);
    }
    const size_t col = base + (size_t)v * VEC;
    for (int r0 = r_begin + ty; r0 < r_end; r0 += kRowBatch * L.ty) {
      Pack<S, VEC> vals[kRowBatch];
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int r = r0 + i * L.ty;
        if (r < r_end) vals[i] = *reinterpret_cast<const Pack<S, VEC>*>(vol + col + (size_t)r * jd);
      }
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int r = r0 + i * L.ty;
        if (r >= r_end) break;
        const int yi = r / width;
        const float y = (float)yi, x = (float)(r - yi * width);
        Pack<S, VEC> out;
#pragma unroll
        for (int l = 0; l < VEC; ++l) {
          const float p = ex2((Elem<kBf16>::to_float(vals[i].v[l]) - a[l]) * kLog2e);
          const float t = fmaf(gx[l], x - cx[l], fmaf(gy[l], y - cy[l], tz[l]));
          out.v[l] = Elem<kBf16>::from_float(p * t);
        }
        *reinterpret_cast<Pack<S, VEC>*>(dv + col + (size_t)r * jd) = out;
      }
    }
  }
}

template <bool kBf16, int VEC>
int launch(const void* vol, const float* rows, void* dv, int batch, int hw, int width, int J,
           int D, cudaStream_t stream) {
  using S = typename Elem<kBf16>::S;
  const Layout L = make_layout(hw, J * D, VEC);
  dv_kernel<kBf16, VEC><<<dim3(L.nchunks, batch), L.tx * L.ty, 0, stream>>>(
      static_cast<const S*>(vol), rows, static_cast<S*>(dv), hw, width, J, D, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vol and dv (batch, hw, J*D) contiguous, both bf16 (is_bf16) or fp32,
// their bases and row pitch aligned to vec elements (as
// ihpr_integral_volume_fwd). rows (batch, J, 8) fp32: m + log s, gx, gy,
// gz, cx, cy, cz, 0. Writes dv. Returns the cudaError_t of the launch (0
// on success; cudaErrorInvalidValue for a vec it does not take).
int ihpr_integral_volume_bwd(const void* vol, const float* rows, void* dv, int batch, int hw,
                             int width, int J, int D, int is_bf16, int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (vec) {
      case 8: return launch<true, 8>(vol, rows, dv, batch, hw, width, J, D, st);
      case 4: return launch<true, 4>(vol, rows, dv, batch, hw, width, J, D, st);
      case 2: return launch<true, 2>(vol, rows, dv, batch, hw, width, J, D, st);
      case 1: return launch<true, 1>(vol, rows, dv, batch, hw, width, J, D, st);
    }
  } else {
    switch (vec) {
      case 4: return launch<false, 4>(vol, rows, dv, batch, hw, width, J, D, st);
      case 2: return launch<false, 2>(vol, rows, dv, batch, hw, width, J, D, st);
      case 1: return launch<false, 1>(vol, rows, dv, batch, hw, width, J, D, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
