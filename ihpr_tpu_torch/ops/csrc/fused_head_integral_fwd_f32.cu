// Fused final 1x1 conv + integral soft-argmax, forward, fp32, for Hopper
// (sm_90a): K1-fp32.
//
// Replaces the TPU kernel ihpr_tpu/ops/fused_head_integral.py:_fwd_kernel
// for fp32 heads, which JAX runs with Precision.HIGHEST (_dot_precision)
// wherever _pad_plan finds a tiling: h36m3d_r50_fp32, parity_r50, the
// accuracy harness's tiny preset. bf16 heads take K1
// (fused_head_integral_fwd.cu).
//
// What it computes: K1's function in fp32. For each sample b and joint j,
// over rows r < HW of feat[b] (HW x C) and depth bins z < D,
//     v[r, z] = sum_c feat[b, r, c] * W[c, j*D + z] + bias[j*D + z]
//     p       = softmax of v over all (r, z)
//     coords[b, j] = (sum p * (r mod width), sum p * (r div width), sum p * z)
// and the per-(b, j) max m and normalizer s = sum exp(v - m). The
// (B, HW, J*D) logits volume is never written.
//
// Precision. The products are 3xTF32 (tf32x3.cuh): fp32 operands split
// into TF32 hi and lo parts, hi*hi + hi*lo + lo*hi on the tensor cores with
// fp32 accumulation, ~2^-21 relative per product, where one TF32 pass would
// give 2^-11. Nothing depends on the process's TF32 flags. The softmax runs
// in natural units with ex2.approx((v - m) * log2 e), as K3 does on the
// no-plan route.
//
// Design. One CTA (8 warps) per (joint, sample); blockIdx.x = joint, so a
// sample's J CTAs run close together and share feat[b] in L2. A small
// kernel first transposes W (C, J*D) to Wt (J*D, C) (fused_head_common.cuh),
// so that the joint's D columns are D rows of C contiguous floats. The CTA
// copies its Wt_j slab (64 bins x C, rows past D clamped into Wt and
// masked) into shared memory once and splits it there once into TF32 hi
// and lo planes, then streams feat[b] through a ring of two cp.async
// stages of 256 rows x 32 channels. Each warp owns 32 rows
// (two m16 tiles) of a 256-row tile and accumulates their 32 x 64 logits
// over the tile's C / 32 stages with mma.sync m16n8k8 (its A fragments
// split in registers, B read split; each 3xTF32 pass runs over all 16
// accumulators before the next, so no MMA waits on the one before it); n
// tiles wholly past D are skipped.
// After a tile's last stage the warp folds its logits into one online
// softmax state (max, sum e, sum e*x, sum e*y, sum e*z) per thread. A
// shuffle merge, then a fixed-order merge of the 8 warps' states, ends the
// CTA: no state crosses CTAs, nothing is atomic, and the result is bitwise
// the same from run to run. Shared memory rows are padded by 4 floats, so
// every fragment load is free of bank conflicts.
//
// Shapes: any J, D <= 64, any HW (the last tile's rows past HW are clamped
// loads and masked), C a multiple of 32 up to 256 (the route sends C = 128
// and 256 here).
//
// What bounds it on an H100: 3 * 2*B*HW*C*J*D tensor-core operations at
// TF32's 494.7 TFLOP/s (1.875 ms at the flagship's 128 x 4096 x 256 x 1152)
// against B*HW*C*4 bytes of features read once from device memory (268 MB,
// 0.08 ms): compute bound. mma.sync, not wgmma: wgmma takes TF32 operands
// K-major from shared memory only, and this first design favours one layout
// for all three products of K1/K2-fp32. Beside the products each logit costs
// the split of its fragments (two integer roundings and a subtraction per
// fp32 value, tf32x3.cuh) and
// ~8 fp32 operations of softmax.

#include "fused_head_common.cuh"
#include "tf32x3.cuh"

namespace {

using namespace fhi;
using namespace tf32x3;

constexpr int kBins = 64;            // depth bins of a joint's slab
constexpr int kCtaWarps = 8;
constexpr int kCtaThreads = kCtaWarps * 32;
constexpr int kRows = kCtaWarps * 32;  // feature rows per tile: 32 per warp
constexpr int kKc = 32;              // channels per ring stage
constexpr int kLdr = kKc + 4;        // ring row pitch, floats
constexpr int kStages = 2;  // ring stages: one computed while the next lands

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Online softmax state, logits in natural units.
struct Stats {
  float m, s, sx, sy, sz;
};

__device__ __forceinline__ void merge(Stats& a, const Stats& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == neg_inf()) return;  // both empty
  const float ca = ex2((a.m - m) * kLog2e), cb = ex2((b.m - m) * kLog2e);
  a.s = a.s * ca + b.s * cb;
  a.sx = a.sx * ca + b.sx * cb;
  a.sy = a.sy * ca + b.sy * cb;
  a.sz = a.sz * ca + b.sz * cb;
  a.m = m;
}

// Shared memory, in 4-byte words: the Wt_j slab split once, its TF32 hi
// and lo parts [2][kBins][C + 4], the ring [kStages][kRows][kLdr], the bias
// [kBins], the warps' states.
__host__ __device__ inline size_t smem_bytes(int C) {
  return sizeof(float) * (2 * (size_t)kBins * (C + 4) + (size_t)kStages * kRows * kLdr + kBins) +
         kCtaWarps * sizeof(Stats);
}

__global__ void __launch_bounds__(kCtaThreads, 1)
    fwd_f32_kernel(const float* __restrict__ feat, const float* __restrict__ wt,
                   const float* __restrict__ bias, float* __restrict__ coords, float* __restrict__ m_out,
                   float* __restrict__ s_out, int hw, int width, int C, int J, int D) {
  extern __shared__ __align__(16) float smem[];
  const int ldw = C + 4;
  float* w_s = smem;  // the slab lands here in fp32 and is split in place into hi
  uint32_t* w_hi = reinterpret_cast<uint32_t*>(w_s);
  uint32_t* w_lo = w_hi + kBins * ldw;
  float* ring = reinterpret_cast<float*>(w_lo + kBins * ldw);
  float* bias_s = ring + kStages * kRows * kLdr;
  Stats* red = reinterpret_cast<Stats*>(bias_s + kBins);

  const int j = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nnt = (D + 7) / 8;  // n tiles holding bins < D
  const int nkc = C / kKc, ntiles = (hw + kRows - 1) / kRows, total = ntiles * nkc;
  const int jd = J * D, cq = C / 4;
  const float* fb = feat + (size_t)b * hw * C;

  // Bias; -inf past D masks those bins.
  if (tid < kBins) bias_s[tid] = tid < D ? bias[j * D + tid] : neg_inf();
  for (int i = tid; i < kBins * cq; i += kCtaThreads) {
    const int z = i / cq, q = i % cq;
    cp_async16(w_s + z * ldw + q * 4, wt + (size_t)min(j * D + z, jd - 1) * C + q * 4);
  }
  // Ring stage n: rows of tile n / nkc, channels of block n % nkc.
  auto load = [&](int n) {
    const int tile = n / nkc, kc = n % nkc;
    float* dst = ring + (n % kStages) * kRows * kLdr;
    for (int i = tid; i < kRows * (kKc / 4); i += kCtaThreads) {
      const int r = i / (kKc / 4), q = i % (kKc / 4);
      const int row = min(tile * kRows + r, hw - 1);
      cp_async16(dst + r * kLdr + q * 4, fb + (size_t)row * C + kc * kKc + q * 4);
    }
  };
  load(0);  // with the slab
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Split the slab once: every warp reads every B fragment of it for every
  // tile, so splitting there would repeat the work 8 x ntiles times.
  for (int i = tid; i < kBins * C; i += kCtaThreads) {
    const int k = (i / C) * ldw + i % C;
    split(w_s[k], w_hi[k], w_lo[k]);
  }

  Stats st = {neg_inf(), 0.f, 0.f, 0.f, 0.f};
  float acc[2][8][4];
  for (int it = 0; it < total; ++it) {
    if (it > 0) cp_async_wait<0>();  // stage it, issued during it - 1
    __syncthreads();  // stage it and the split slab are in; every warp is done with stage it - 1
    if (it + 1 < total) load(it + 1);
    cp_async_commit();
    const int tile = it / nkc, kc = it % nkc;
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    const float* fs = ring + (it % kStages) * kRows * kLdr + warp * 32 * kLdr;
    const int wk = kc * kKc;
#pragma unroll
    for (int ks = 0; ks < kKc / 8; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = fs + (mt * 16 + g) * kLdr + ks * 8 + t;
        const float af[4] = {p[0], p[8 * kLdr], p[4], p[8 * kLdr + 4]};
        split(af, ah[mt], al[mt]);
      }
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < nnt) {
          const int q = (nt * 8 + g) * ldw + wk + ks * 8 + t;
          bh[nt][0] = w_hi[q], bh[nt][1] = w_hi[q + 4];
          bl[nt][0] = w_lo[q], bl[nt][1] = w_lo[q + 4];
        }
      }
      mma3(acc, ah, al, bh, bl, nnt);
    }
    if (kc != nkc - 1) continue;

    // The tile's logits are complete: v = acc + bias, -inf past HW or D.
    const int r0 = tile * kRows + warp * 32 + g;
    float tmax = neg_inf();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < nnt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + mt * 16 + (e >> 1) * 8;
            const float v = r < hw ? acc[mt][nt][e] + bias_s[nt * 8 + 2 * t + (e & 1)] : neg_inf();
            acc[mt][nt][e] = v;
            tmax = fmaxf(tmax, v);
          }
        }
      }
    }
    if (tmax == neg_inf()) continue;
    const float m_new = fmaxf(st.m, tmax);
    const float c = ex2((st.m - m_new) * kLog2e);
    st.s *= c, st.sx *= c, st.sy *= c, st.sz *= c;
    st.m = m_new;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      // x and y are per row: sum each row's probabilities first.
      float p_lo = 0.f, p_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < nnt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2((acc[mt][nt][e] - m_new) * kLog2e);  // 0 for masked entries
            (e < 2 ? p_lo : p_hi) += p;
            st.sz = fmaf(p, (float)(nt * 8 + 2 * t + (e & 1)), st.sz);
          }
        }
      }
      const int r_lo = r0 + mt * 16, r_hi = r_lo + 8;
      st.s += p_lo + p_hi;
      st.sx = fmaf(p_lo, (float)(r_lo % width), fmaf(p_hi, (float)(r_hi % width), st.sx));
      st.sy = fmaf(p_lo, (float)(r_lo / width), fmaf(p_hi, (float)(r_hi / width), st.sy));
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o;
    o.m = __shfl_xor_sync(0xffffffffu, st.m, off);
    o.s = __shfl_xor_sync(0xffffffffu, st.s, off);
    o.sx = __shfl_xor_sync(0xffffffffu, st.sx, off);
    o.sy = __shfl_xor_sync(0xffffffffu, st.sy, off);
    o.sz = __shfl_xor_sync(0xffffffffu, st.sz, off);
    merge(st, o);
  }
  if (lane == 0) red[warp] = st;
  __syncthreads();
  if (tid == 0) {
    Stats S = red[0];
    for (int w = 1; w < kCtaWarps; ++w) merge(S, red[w]);
    const int o = b * J + j;
    const float inv = 1.f / S.s;
    coords[o * 3 + 0] = S.sx * inv;
    coords[o * 3 + 1] = S.sy * inv;
    coords[o * 3 + 2] = S.sz * inv;
    m_out[o] = S.m;
    s_out[o] = S.s;
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for C channels.
size_t ihpr_fused_head_integral_fwd_f32_smem(int C) { return smem_bytes(C); }

// feat (batch, hw, C), w (C, J*D), bias (J*D,): contiguous fp32, feat
// 16-byte aligned, C a multiple of 32. Scratch wt (J*D, C) fp32. Writes
// coords (batch, J, 3), m and s (batch, J), fp32. Returns 0 or the first
// cudaError_t of the two launches (transpose, K1-fp32).
int ihpr_fused_head_integral_fwd_f32(const void* feat, const void* w, const void* bias, void* wt,
                                     float* coords, float* m, float* s, int batch, int hw, int width,
                                     int C, int J, int D, void* stream) {
  if (C % kKc || D < 1 || D > kBins) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int jd = J * D;
  cudaError_t err = transpose(static_cast<const float*>(w), static_cast<float*>(wt), C, jd, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(C);
  err = cudaFuncSetAttribute(fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_f32_kernel<<<dim3(J, batch), kCtaThreads, smem, st>>>(
      static_cast<const float*>(feat), static_cast<const float*>(wt), static_cast<const float*>(bias),
      coords, m, s, hw, width, C, J, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
