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
// Precision. The products are 3xTF32 (fused_head_f32.cuh): fp32 operands
// split into TF32 hi and lo parts, lo*hi + hi*lo + hi*hi on the tensor cores
// with fp32 accumulation, ~2^-21 relative per product, where one TF32 pass
// would give 2^-11. Nothing depends on the process's TF32 flags. The
// softmax runs in base-2 units with ex2.approx, as K1 does.
//
// Design (an earlier one, 8 warps of mma.sync per CTA, each warp reading
// and splitting its operands through registers, ran 2.26 ms at B = 32).
//   1. split_planes_kernel (fused_head_f32.cuh) splits W once into TF32 hi
//      and lo planes of Wt (J*64, C), K-major over channels in perm32's
//      order: no kernel splits a weight again.
//   2. fwd_f32_kernel, one CTA per (joint, sample, part of the sample's
//      rows), 3 warpgroups:
//      - producer (one thread, registers cut to 40): TMA-loads the joint's
//        hi and lo slabs (64 bins x C each, resident, 128-byte swizzle),
//        then streams the rows in stages of 128 rows x 32 channels (two
//        3-D boxes: a box past HW reads zeros, not the next sample) through
//        a ring of kStages (full / empty mbarriers);
//      - two consumer warpgroups (232 registers), each on 64 rows of every
//        stage: A is the rows, two 16-byte loads a row and thread, split in
//        registers; B the slab planes; wgmma m64n64k8 TF32 with A from
//        registers, three passes a k-step. The stage is free once its A
//        values are in registers, and the next stage's values load and
//        split while this one's products run (f32h::pipelined). After a tile's
//        last stage the warpgroup folds its 64 x 64 logits into one online
//        softmax state (max, sum e, sum e*x, sum e*y, sum e*z) per thread.
//      A shuffle merge, then a fixed-order merge of the 8 warps' states,
//      ends the CTA, which writes its part's state.
//   3. merge_kernel: each (b, j)'s parts merged in part order, coords, m, s.
//   The parts fill the last wave of CTAs (parts_for below): at the
//   flagship's B = 32 576 (joint, sample) CTAs are 4.36 waves on 132 SMs,
//   2 parts 8.73. No state crosses CTAs except through the parts, nothing is
//   atomic, and the result is bitwise the same from run to run on one card.
//
// Shapes: any J, D <= 64 (bins past D get a -inf bias), any HW (rows past
// HW are masked to -inf), C a multiple of 32 up to 256 (the slab is
// resident: 2 x 64 x C x 4 bytes).
//
// What bounds it on an H100: 3 * 2*B*HW*C*J*D tensor-core operations at
// TF32's 494.7 TFLOP/s (0.469 ms at 32 x 4096 x 256 x 1152; wgmma TF32
// alone reaches 0.96 of that rate) against B*HW*C*4 bytes of features read
// once (134 MB, 0.04 ms): compute bound. Beside the products each A value
// costs two 16-byte loads per 8 and its split (three integer operations and
// a subtraction), and each logit ~8 fp32 operations of softmax; the two
// warpgroups' products cover each other's. Timed at ~0.64 of the bound
// (PERF.md §6).

#include "fused_head_f32.cuh"

namespace {

using namespace fhi;
using namespace hopper;
using namespace f32h;

constexpr int kRows = 2 * kBox;  // feature rows of a stage: 64 per consumer warpgroup
constexpr int kStages = 4;       // stages in flight
constexpr int kCtaThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kStateVals = 5;     // m, s, sx, sy, sz

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

// Shared memory, from a 1024-byte aligned base: the slab's hi tiles [nkb]
// then its lo tiles [nkb] (64 bins x 128 bytes each), the ring [kStages][2
// boxes of 64 rows x 128 bytes], the mbarriers, the bias in base-2 units
// and the warps' states.
struct Layout {
  int nkb;
  __host__ __device__ explicit Layout(int C) : nkb(C / kKb) {}
  __host__ __device__ size_t ring() const { return (size_t)2 * nkb * kTile; }
  __host__ __device__ size_t bars() const { return ring() + (size_t)kStages * 2 * kTile; }
  __host__ __device__ size_t bias() const { return bars() + (1 + 2 * kStages) * 8; }
  __host__ __device__ size_t red() const { return bias() + kBins * sizeof(float); }
  __host__ __device__ size_t bytes() const { return 1024 + red() + kConsumerWarps * sizeof(Stats); }
};

template <bool BASE2>
__global__ void __launch_bounds__(kCtaThreads, 1)
    fwd_f32_kernel(const __grid_constant__ CUtensorMap fmap, const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ bias, float* __restrict__ part, int hw, int width, int C, int J,
                   int D) {
  constexpr float scale = BASE2 ? 1.f : kLog2e;  // IHPR_EXP2: the logits come in base 2
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

  const int j = blockIdx.x, b = blockIdx.y, pi = blockIdx.z, parts = gridDim.z, tid = threadIdx.x;
  const int ntiles = cdiv(hw, kRows);
  const int t0 = ntiles * pi / parts, nst = (ntiles * (pi + 1) / parts - t0) * nkb;

  if (tid < kBins) bias_s[tid] = tid < D ? bias[j * D + tid] * scale : neg_inf();
  if (tid == 0) {
    mbar_init(w_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(w_full, 2 * nkb * kTile);
      for (int kb = 0; kb < nkb; ++kb) {
        tma_load_2d(w_s + kb * kTile, &wmap, w_full, kb * kKb, j * kBins);
        tma_load_2d(w_s + (nkb + kb) * kTile, &wmap, w_full, kb * kKb, (J + j) * kBins);
      }
      for (int n = 0; n < nst; ++n) {
        const int s = n % kStages, row0 = (t0 + n / nkb) * kRows, c0 = (n % nkb) * kKb;
        mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kTile);
        tma_load_3d(ring + s * 2 * kTile, &fmap, &full[s], c0, row0, b);
        tma_load_3d(ring + s * 2 * kTile + kTile, &fmap, &full[s], c0, row0 + kBox, b);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, warp = ctid >> 5, wq = warp & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  Stats st = {neg_inf(), 0.f, 0.f, 0.f, 0.f};
  float acc[kBins / 2];
  mbar_wait(w_full, 0);

  const int ntl = nst / nkb;  // this part's 128-row tiles
  for (int tl = 0; tl < ntl; ++tl) {
    const int n0 = tl * nkb;  // the tile's first stage
    zero(acc);
    fence_acc(acc);
    pipelined(
        nkb,
        [&](int kb, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
          const int n = n0 + kb, s = n % kStages;
          mbar_wait(&full[s], (n / kStages) & 1);
          load_a(ring + s * 2 * kTile + wg * kTile, wq, g, t, ah, al);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);  // the stage's values are in registers
        },
        [&](int kb, const uint32_t (&ah)[4][4], const uint32_t (&al)[4][4]) {
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma3<kBins>(acc, ah[q], al[q], kdesc(w_s + kb * kTile, q), kdesc(w_s + (nkb + kb) * kTile, q));
          wgmma_commit();
        });
    fence_acc(acc);

    // The tile's logits are complete: u = v scale (log2 e, or 1 for
    // IHPR_EXP2's pre-scaled W and b), -inf past HW or D.
    const int r_lo = (t0 + tl) * kRows + wg * kBox + wq * 16 + g, r_hi = r_lo + 8;
    float tmax = neg_inf();
#pragma unroll
    for (int i = 0; i < kBins / 2; ++i) {
      const int r = (i & 2) ? r_hi : r_lo;
      const float u = r < hw ? fmaf(acc[i], scale, bias_s[(i >> 2) * 8 + 2 * t + (i & 1)]) : neg_inf();
      acc[i] = u;
      tmax = fmaxf(tmax, u);
    }
    if (tmax == neg_inf()) continue;
    const float m_new = fmaxf(st.m, tmax);
    const float c = ex2(st.m - m_new);
    st.s *= c, st.sx *= c, st.sy *= c, st.sz *= c;
    st.m = m_new;
    // x and y are per row: sum each row's probabilities first.
    float p_lo = 0.f, p_hi = 0.f;
#pragma unroll
    for (int i = 0; i < kBins / 2; ++i) {
      const float p = f32_ex2(acc[i] - m_new);  // 0 for masked entries
      ((i & 2) ? p_hi : p_lo) += p;
      st.sz = fmaf(p, (float)((i >> 2) * 8 + 2 * t + (i & 1)), st.sz);
    }
    st.s += p_lo + p_hi;
    st.sx = fmaf(p_lo, (float)(r_lo % width), fmaf(p_hi, (float)(r_hi % width), st.sx));
    st.sy = fmaf(p_lo, (float)(r_lo / width), fmaf(p_hi, (float)(r_hi / width), st.sy));
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
  named_barrier(1, 256);  // the consumer warpgroups only
  if (ctid == 0) {
    Stats S = red[0];
    for (int w = 1; w < kConsumerWarps; ++w) merge(S, red[w]);
    float* o = part + ((size_t)(b * J + j) * parts + pi) * kStateVals;
    o[0] = S.m, o[1] = S.s, o[2] = S.sx, o[3] = S.sy, o[4] = S.sz;
  }
}

// coords, m (natural units: base-2 times unscale, which is 1 for
// IHPR_EXP2's base-2 m) and s of each (b, j) from its parts, merged in part
// order.
__global__ void merge_kernel(const float* __restrict__ part, float* __restrict__ coords, float* __restrict__ m_out,
                             float* __restrict__ s_out, int n, int parts, float unscale) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const float* p = part + (size_t)o * parts * kStateVals;
  Stats S = {p[0], p[1], p[2], p[3], p[4]};
  for (int i = 1; i < parts; ++i) {
    const float* q = p + i * kStateVals;
    merge(S, Stats{q[0], q[1], q[2], q[3], q[4]});
  }
  const float inv = 1.f / S.s;
  coords[o * 3 + 0] = S.sx * inv;
  coords[o * 3 + 1] = S.sy * inv;
  coords[o * 3 + 2] = S.sz * inv;
  m_out[o] = S.m * unscale;
  s_out[o] = S.s;
}

// Parts of each (joint, sample)'s rows: the fewest of 1 ... 4 (at most one
// 128-row tile a part) whose CTAs fill their last wave on this card to
// within 5% of the best. Whole samples a CTA (IHPR_F32_ONE_PART) timed
// slower at B = 32 and at serving's B = 2 (PERF.md §6).
int parts_for(int batch, int hw, int J) {
#ifdef IHPR_F32_ONE_PART
  return 1;  // a timing build (tools/f32_breakdown.py): whole samples a CTA
#endif
  const int sms = sm_count(), ntiles = cdiv(hw, kRows);
  auto fill = [&](int p) {
    const long long ctas = (long long)J * batch * p;
    return (double)ctas / (double)(((ctas + sms - 1) / sms) * sms);
  };
  double best = 0.0;
  for (int p = 1; p <= 4 && p <= ntiles; ++p) best = fill(p) > best ? fill(p) : best;
  for (int p = 1; p <= 4 && p <= ntiles; ++p)
    if (fill(p) >= best - 0.05) return p;
  return 1;
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for C channels.
size_t ihpr_fused_head_integral_fwd_f32_smem(int C) { return Layout(C).bytes(); }

// Scratch (in floats) the forward needs: the split planes (2, J*64, C) and
// the parts' states (batch, J, parts, 5).
size_t ihpr_fused_head_integral_fwd_f32_scratch(int batch, int hw, int C, int J) {
  return (size_t)2 * J * kBins * C + (size_t)batch * J * parts_for(batch, hw, J) * kStateVals;
}

// feat (batch, hw, C), w (C, J*D), bias (J*D,): contiguous fp32, feat
// 16-byte aligned, C a multiple of 32 up to 256. Scratch: as many floats as
// ihpr_fused_head_integral_fwd_f32_scratch gives, 16-byte aligned. Writes
// coords (batch, J, 3), m and s (batch, J), fp32. mode bit 0 (IHPR_EXP2):
// w and bias come scaled by log2 e and m is a base-2 max. Returns 0, the
// CUresult of a tensor-map encoding, or the first cudaError_t of the three
// launches (split planes, K1-fp32, merge).
int ihpr_fused_head_integral_fwd_f32(const void* feat, const void* w, const void* bias, void* scratch,
                                     float* coords, float* m, float* s, int batch, int hw, int width,
                                     int C, int J, int D, int mode, void* stream) {
  if (C % kKb || C > 256 || D < 1 || D > kBins) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  float* planes = static_cast<float*>(scratch);
  float* part = planes + (size_t)2 * J * kBins * C;
  cudaError_t err = split_planes(static_cast<const float*>(w), planes, nullptr, C, J, D, st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap fmap, wmap;
  int terr = tmap_batched_f32(&fmap, feat, batch, hw, C);
  if (!terr) terr = tmap_matrix_f32(&wmap, planes, (uint64_t)2 * J * kBins, C);
  if (terr) return terr;
  const size_t smem = Layout(C).bytes();
  // The natural base's instance keeps the constant log2 e (a runtime scale timed 1.5% slower).
  auto kernel = (mode & kModeExp2) ? fwd_f32_kernel<true> : fwd_f32_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int parts = parts_for(batch, hw, J);
  kernel<<<dim3(J, batch, parts), kCtaThreads, smem, st>>>(fmap, wmap, static_cast<const float*>(bias), part, hw,
                                                            width, C, J, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = batch * J;
  merge_kernel<<<cdiv(n, 128), 128, 0, st>>>(part, coords, m, s, n, parts, (mode & kModeExp2) ? 1.f : kLn2);
  return (int)cudaGetLastError();
}

}  // extern "C"
