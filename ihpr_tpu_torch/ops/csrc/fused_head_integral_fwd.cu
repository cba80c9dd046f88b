// Fused final 1x1 conv + integral soft-argmax, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/fused_head_integral.py:_fwd_kernel
// (launched by _fwd_call, body in integral_pallas._online_stats_tail).
//
// What it computes. For each sample b and joint j, over rows r < HW of the
// head's penultimate features feat[b] (HW x C) and depth bins z < D:
//     v[r, z] = sum_c feat[b, r, c] * W[c, j*D + z] + bias[j*D + z]   (fp32)
//     p       = softmax of v over all (r, z)
//     coords[b, j] = (sum p * (r mod width), sum p * (r div width), sum p * z)
// plus the per-(b, j) max m and normalizer s = sum exp(v - m), which the
// backward will need. The (B, HW, J*D) logits volume is never written.
// bf16 operands only: fp32 heads take K1-fp32 (fused_head_integral_fwd_f32.cu,
// 3xTF32) where JAX fuses them, else the logits + K3 route
// (ops/fused_head_integral.py).
//
// Design. One CTA per (group of kG = 3 joints, sample); blockIdx.x = group,
// so a sample's J/kG CTAs run close together and share feat[b] in L2 (on an
// H100, 3 joints per CTA ran faster than 2: PERF.md). First a
// small kernel transposes W (C, J*D) to Wt (J*D, C) (fused_head_common.cuh:
// its 2C-byte pitch is one TMA can copy for any J*D). Then 3 warpgroups:
//   - producer (one thread issues, registers cut to 40): TMA-loads the
//     group's Wt slab once (kG x 64 rows x C, resident, 128-byte swizzle),
//     then streams feat[b] in 64-row tiles through a ring of kStages slots
//     (full/empty mbarriers);
//   - two consumer warpgroups (232 registers) take alternate tiles, so one's
//     epilogue overlaps the other's products. kStages is even, so each
//     warpgroup owns its own slots and waits on every phase of their full
//     barriers in turn. With an odd ring a warpgroup met its slot's barrier
//     again two phases on, the other's tile in between: a parity wait
//     cannot tell those phases apart, and could pass before the other's tile
//     had landed, reading a slot the TMA had not yet filled.
//     wgmma m64n192k16, both
//     operands K-major from shared memory, fp32 accumulation, then the
//     online softmax of K1 v1 on the wgmma accumulator (the per-warp
//     mma.sync m16n8 layout): base 2 with ex2.approx, one state (max, sum
//     e, sum e*x, sum e*y, sum e*z) per joint per thread, the max per joint.
// A shuffle + shared-memory merge of the 8 warps' states, in a fixed order,
// ends the CTA. No state crosses CTAs: no second pass, no atomics.
//
// Shapes. Any J (the last group may be ragged: a missing joint reloads
// joint J-1 and its columns are never read), D <= 64 (a 64-row box at j*D
// runs into joint j+1's rows; those columns get a -inf bias), any HW (a
// tile past HW reads TMA's zeros, and its rows are masked), C a multiple of
// 16 up to 256 (the k range is padded to 64 with TMA's zeros).
//
// What differs from the TPU kernel. The TPU walks a sample's row chunks in
// grid order and carries the running max and sums between grid steps; GPU
// CTAs run in no order, so the whole sample's rows are a loop inside one
// CTA. The TPU used one max shared by all joints of a sample; here the max
// is per joint, which is exact and cannot underflow a joint whose logits sit
// far below another's.
//
// What bounds it on an H100. 2*B*HW*C*J*D flops (155 GFLOP at the flagship
// 64 x 4096 x 256 x 1152) against B*HW*C*2 bytes of features (134 MB):
// compute bound on the tensor cores. v1 (one CTA per (joint, sample),
// ldmatrix + mma.sync, feat[b] read from L2 once per joint) ran at 128
// TFLOP/s: mma.sync issue and fragment reloads bound it. Here the products
// are asynchronous wgmma fed by TMA, feat[b] crosses L2 J/kG times, and the
// epilogue (one ex2 per logit on the SFU, ~6 fp32 operations) overlaps the
// other warpgroup's products.

#include "fused_head_common.cuh"
#include "hopper.cuh"

namespace {

using namespace fhi;
using namespace hopper;

constexpr int kG = 3;                 // joints per CTA
constexpr int kN = kG * kBox;         // logit columns per CTA (wgmma N = 192)
constexpr int kStages = 4;            // feature tiles in flight
static_assert(kStages % 2 == 0, "each consumer warpgroup must own its ring slots");
constexpr int kCtaThreads = 384;      // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;

// Online softmax state, logits in base-2 units (u = v * log2 e).
struct Stats {
  float m, s, sx, sy, sz;
};

__device__ __forceinline__ void merge(Stats& a, const Stats& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == neg_inf()) return;  // both empty
  const float ca = ex2(a.m - m), cb = ex2(b.m - m);
  a.s = a.s * ca + b.s * cb;
  a.sx = a.sx * ca + b.sx * cb;
  a.sy = a.sy * ca + b.sy * cb;
  a.sz = a.sz * ca + b.sz * cb;
  a.m = m;
}

// Shared memory, from a 1024-byte aligned base: the Wt slab [kb][kN rows],
// the ring [kStages][kb][64 rows] (both 128-byte rows of 64 channels), the
// mbarriers, the bias in base-2 units and the warps' states.
struct Layout {
  int nkb;
  __host__ __device__ explicit Layout(int C) : nkb((C + kBox - 1) / kBox) {}
  __host__ __device__ size_t ring() const { return (size_t)nkb * kN * 128; }
  __host__ __device__ size_t bars() const { return ring() + (size_t)kStages * nkb * kBoxBytes; }
  __host__ __device__ size_t bias() const { return bars() + (1 + 2 * kStages) * 8; }
  __host__ __device__ size_t red() const { return bias() + kN * sizeof(float); }
  __host__ __device__ size_t bytes() const {
    return 1024 + red() + kConsumerWarps * kG * sizeof(Stats);
  }
};

__global__ void __launch_bounds__(kCtaThreads, 1)
    fused_head_integral_fwd_kernel(const __grid_constant__ CUtensorMap fmap,
                                   const __grid_constant__ CUtensorMap wmap,
                                   const __nv_bfloat16* __restrict__ bias,
                                   float* __restrict__ coords, float* __restrict__ m_out,
                                   float* __restrict__ s_out, int hw, int width, int C, int J,
                                   int D, float scale, float unscale) {
  unsigned char* base = smem_base();
  const Layout L(C);
  const int nkb = L.nkb;
  unsigned char* w_s = base;
  unsigned char* ring = base + L.ring();
  uint64_t* w_full = reinterpret_cast<uint64_t*>(base + L.bars());
  uint64_t* full = w_full + 1;
  uint64_t* empty = full + kStages;
  float* bias_s = reinterpret_cast<float*>(base + L.bias());
  Stats* red = reinterpret_cast<Stats*>(base + L.red());

  const int j0 = blockIdx.x * kG, b = blockIdx.y;
  const int nj = min(kG, J - j0);
  const int tid = threadIdx.x;
  const int ntiles = (hw + kBox - 1) / kBox;

  // Bias in base-2 units (times scale: log2 e, or 1 where W and b come
  // pre-scaled, IHPR_EXP2); -inf for columns past D (or past the last
  // joint) masks their logits.
  if (tid < kN) {
    const int gi = tid / kBox, z = tid % kBox;
    bias_s[tid] = gi < nj && z < D ? __bfloat162float(bias[(j0 + gi) * D + z]) * scale : neg_inf();
  }
  if (tid == 0) {
    mbar_init(w_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(w_full, nkb * kN * 128);
      for (int gi = 0; gi < kG; ++gi) {
        const int jj = min(j0 + gi, J - 1);
        for (int kb = 0; kb < nkb; ++kb)
          tma_load_2d(w_s + kb * kN * 128 + gi * kBoxBytes, &wmap, w_full, kb * kBox, jj * D);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], nkb * kBoxBytes);
        for (int kb = 0; kb < nkb; ++kb)
          tma_load_3d(ring + (s * nkb + kb) * kBoxBytes, &fmap, &full[s], kb * kBox, t * kBox, b);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, warp = ctid >> 5, wq = warp & 3;
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3;
  Stats st[kG];
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) st[gi] = {neg_inf(), 0.f, 0.f, 0.f, 0.f};
  mbar_wait(w_full, 0);

  for (int t = wg; t < ntiles; t += 2) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const unsigned char* tile = ring + s * nkb * kBoxBytes;
    float acc[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
    wgmma_fence();
    for (int kk = 0; kk < 4 * nkb; ++kk) {
      const int kb = kk >> 2, q = kk & 3;
      mma_ss_n192<0, 0>(acc, desc_sw128(tile + kb * kBoxBytes + q * 32, 16, 1024),
                        desc_sw128(w_s + kb * kN * 128 + q * 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[s]);  // the tile's slot is free again

    // u = v * scale (base 2), in place of acc; rows past hw (last tile only) -> -inf.
    const int r_lo = t * kBox + wq * 16 + g, r_hi = r_lo + 8;
    const bool ragged = (t + 1) * kBox > hw;
    const float x_lo = (float)(r_lo % width), y_lo = (float)(r_lo / width);
    const float x_hi = (float)(r_hi % width), y_hi = (float)(r_hi / width);
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      if (gi < nj) {
        float tmax = neg_inf();
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = (gi * 8 + nt) * 4 + e;
            float u = fmaf(acc[i], scale, bias_s[gi * kBox + nt * 8 + 2 * tig + (e & 1)]);
            if (ragged && (e < 2 ? r_lo : r_hi) >= hw) u = neg_inf();
            acc[i] = u;
            tmax = fmaxf(tmax, u);
          }
        }
        Stats& S = st[gi];
        if (tmax != neg_inf()) {
          const float m_new = fmaxf(S.m, tmax);
          const float c = ex2(S.m - m_new);
          S.s *= c, S.sx *= c, S.sy *= c, S.sz *= c;
          S.m = m_new;
          // x and y are per row: sum each row's probabilities first.
          float p_lo = 0.f, p_hi = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = ex2(acc[(gi * 8 + nt) * 4 + e] - m_new);  // 0 for masked entries
              (e < 2 ? p_lo : p_hi) += p;
              S.sz = fmaf(p, (float)(nt * 8 + 2 * tig + (e & 1)), S.sz);
            }
          }
          S.s += p_lo + p_hi;
          S.sx = fmaf(p_lo, x_lo, fmaf(p_hi, x_hi, S.sx));
          S.sy = fmaf(p_lo, y_lo, fmaf(p_hi, y_hi, S.sy));
        }
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    Stats& S = st[gi];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Stats o;
      o.m = __shfl_xor_sync(0xffffffffu, S.m, off);
      o.s = __shfl_xor_sync(0xffffffffu, S.s, off);
      o.sx = __shfl_xor_sync(0xffffffffu, S.sx, off);
      o.sy = __shfl_xor_sync(0xffffffffu, S.sy, off);
      o.sz = __shfl_xor_sync(0xffffffffu, S.sz, off);
      merge(S, o);
    }
    if (lane == 0) red[warp * kG + gi] = S;
  }
  named_barrier(1, 256);  // the consumer warpgroups only
  if (ctid < nj) {
    Stats S = red[ctid];
    for (int w = 1; w < kConsumerWarps; ++w) merge(S, red[w * kG + ctid]);
    const int o = b * J + j0 + ctid;
    const float inv = 1.f / S.s;
    coords[o * 3 + 0] = S.sx * inv;
    coords[o * 3 + 1] = S.sy * inv;
    coords[o * 3 + 2] = S.sz * inv;
    m_out[o] = S.m * unscale;
    s_out[o] = S.s;
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for C channels.
size_t ihpr_fused_head_integral_fwd_smem(int C) { return Layout(C).bytes(); }

// feat (batch, hw, C), w (C, J*D), bias (J*D,): contiguous bf16, feat
// 16-byte aligned. Scratch wt (J*D, C) bf16. Writes coords (batch, J, 3),
// m and s (batch, J), fp32. mode bit 0 (IHPR_EXP2): w and bias come scaled
// by log2 e, the logits are base 2 as they are and m is a base-2 max.
// Returns 0, the CUresult of a tensor-map encoding, or the first
// cudaError_t of the two launches (transpose, K1).
int ihpr_fused_head_integral_fwd(const void* feat, const void* w, const void* bias, void* wt,
                                 float* coords, float* m, float* s, int batch, int hw, int width,
                                 int C, int J, int D, int mode, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int jd = J * D;
  cudaError_t err = transpose(static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wt),
                              C, jd, st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap fmap, wmap;
  int terr = tmap_batched(&fmap, feat, batch, hw, C);
  if (!terr) terr = tmap_matrix(&wmap, wt, jd, C);
  if (terr) return terr;
  const size_t smem = Layout(C).bytes();
  err = cudaFuncSetAttribute(fused_head_integral_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_head_integral_fwd_kernel<<<dim3((J + kG - 1) / kG, batch), kCtaThreads, smem, st>>>(
      fmap, wmap, static_cast<const __nv_bfloat16*>(bias), coords, m, s, hw, width, C, J, D,
      (mode & kModeExp2) ? 1.f : kLog2e, (mode & kModeExp2) ? 1.f : kLn2);
  return (int)cudaGetLastError();
}

}  // extern "C"
