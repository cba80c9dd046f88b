// Fused final 1x1 conv + integral soft-argmax, backward, fp32, for Hopper
// (sm_90a): K2-fp32.
//
// Replaces the TPU kernel ihpr_tpu/ops/fused_head_integral.py:_bwd_kernel
// for fp32 heads (Precision.HIGHEST), on the same route as K1-fp32
// (fused_head_integral_fwd_f32.cu). bf16 heads take K2
// (fused_head_integral_bwd.cu).
//
// What it computes. Given the coords' cotangent g (B, J, 3) and K1-fp32's
// per-joint max m and normalizer s:
//     p     = exp(v - (m + log s)),  v = feat W + bias (recomputed)
//     dv    = p * (gx (x - cx) + gy (y - cy) + gz (z - cz))
//     dfeat = dv W^T           (B, HW, C)
//     dW    = sum_b feat^T dv  (C, J*D)
//     db    = sum_{b,r} dv     (J*D,)
// all in fp32, dv not rounded (ops/fused_head_integral.py:plain_bwd for
// fp32 operands). The logits and dv are recomputed in each kernel and
// never written. Every product is 3xTF32 on wgmma (fused_head_f32.cuh).
//
// Design (an earlier one on mma.sync, every operand read and split through
// registers, ran 9.46 ms at B = 32): four launches, as K2's (bf16):
// dfeat contracts over all J*D columns and dW over all rows of all samples,
// so no one layout of CTAs owns both sums.
//   1. split_planes_kernel: W split once into TF32 hi / lo planes, Wt
//      (J*64, C) K-major over channels and W (C, J*64) K-major over bins in
//      as_a's order.
//   2. dfeat_kernel, one CTA per (128 rows, sample): the rows land once by
//      TMA and stay (64 per consumer warpgroup); the weights stream through
//      a ring of kStages stages of 16 KB (a 64 x 32 hi tile and its lo
//      tile), which both warpgroups read. Per joint: S = F Wt_j^T (64 rows
//      x 64 bins, wgmma m64n64k8, A the rows split in registers), dv in the
//      accumulator, then dfeat (64 rows x C, 4 accumulators of n64) += dv
//      W_j with dv's accumulator turned into A in registers (as_a).
//   3. dw_kernel, one CTA per (joint, range of 64-row feature tiles, any
//      samples): Wt_j's planes resident; the tile's 32-channel blocks land
//      in a ring of one slot each. Warpgroup w forms S for bins [32w, 32w +
//      32) (n32), writes dv^T into two shared-memory planes (hi, lo: bins x
//      64 rows, K-major over rows) and, after a barrier of both
//      warpgroups, adds F^T dv (channel tiles w, w + 2, all 64 bins: A the
//      tile's values read transposed and split in registers, each k-step's
//      wgmmas issued as soon as its A is split; B the dv^T planes) into its
//      dW_j accumulators, flushed into the partial every kFlush tiles; db's
//      sums in fp32. A block is free once the warpgroup whose channels it
//      holds has read it for F^T, so the next tile's blocks land while the
//      channel tiles after them are multiplied. (Warpgroups that each own
//      32 bins end to end, sharing only the ring, ran 1.5x slower: twice
//      the F^T splits, n32 products.)
//   4. reduce_kernel: dW and db as the sums of the ranges' partials in a
//      fixed order.
// Every sum has a fixed order, so the results are bitwise the same from
// run to run (on one card: the ranges follow its SM count); nothing is
// atomic. The TPU kernel carried dW / db in VMEM scratch across a grid that
// runs in order, which on a GPU grid would race.
//
// Shapes: any J, D <= 64, any HW; C a multiple of 32 up to 256. Bins past D
// get dv = 0 and rows past HW dv = 0; neither adds anything.
//
// What bounds it on an H100: four products (the logits in both kernels,
// dfeat, dW), 3 * 4 * 2*B*HW*C*J*D tensor-core operations at TF32's 494.7
// TFLOP/s (1.875 ms at 32 x 4096 x 256 x 1152; 1.406 for the three products
// of the function) against reading feat and writing dfeat once
// (2*B*HW*C*4 bytes): compute bound. Beside the products: the A splits in
// registers (each feature value split J times in dfeat and twice a joint in
// dW), the weights re-read from L2 by every dfeat CTA, and feat re-read from
// L2 by the J dW CTAs of a range.

#include <algorithm>

#include "fused_head_f32.cuh"

namespace {

using namespace fhi;
using namespace hopper;
using namespace f32h;

constexpr int kMaxC = 256;        // channels the accumulators hold
constexpr int kRowVals = 8;       // per (b, j): m + log s, gx, gy, gz, cx, cy, cz, 0
constexpr int kCtaThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kStages = 4;        // dfeat: weight stages in flight (4 and 6 timed alike)
constexpr int kFlush = 16;        // dW: 64-row tiles summed in the accumulators between flushes

// The per-(b, j) row of K1's results and the cotangent.
struct Row {
  float lse, gx, gy, gz, cx, cy, cz;
  __device__ explicit Row(const float* r)
      : lse(__ldg(r)), gx(__ldg(r + 1)), gy(__ldg(r + 2)), gz(__ldg(r + 3)), cx(__ldg(r + 4)),
        cy(__ldg(r + 5)), cz(__ldg(r + 6)) {}
  // gx (x - cx) + gy (y - cy) for feature row `row` of a width-wide map.
  __device__ float tx(int row, int width) const {
    return gx * ((float)(row % width) - cx) + gy * ((float)(row / width) - cy);
  }
  // dv of a logit v (without bias) at bias bz, given tx + tz; scale and
  // BEXP are the exp modes' (dv_exp).
  template <bool BEXP>
  __device__ float dv(float v, float bz, float txz, float scale) const {
    const float a = v + bz - lse;
    return (BEXP ? round_bf16(f32_ex2(round_bf16(a) * scale)) : f32_ex2(a * scale)) * txz;
  }
};

// ---- dfeat ---------------------------------------------------------------------------

// Shared memory: the rows [2 warpgroups][nkb] tiles, the ring [kStages][hi,
// lo] tiles, the mbarriers.
struct DfLayout {
  int nkb;
  __host__ __device__ explicit DfLayout(int C) : nkb(C / kKb) {}
  __host__ __device__ size_t ring() const { return (size_t)2 * nkb * kTile; }
  __host__ __device__ size_t bars() const { return ring() + (size_t)kStages * 2 * kTile; }
  __host__ __device__ size_t bytes() const { return 1024 + bars() + (1 + 2 * kStages) * 8; }
};

// Weight stages of one joint: the logits' nkb channel blocks of Wt_j, then
// dfeat's (bin block kbb < nkbb, channel chunk nc < nnc) tiles of W_j.
__device__ __forceinline__ int df_stages(int C, int D) { return C / kKb + (D > kKb ? 2 : 1) * cdiv(C, kBox); }

template <bool BEXP, bool BASE2>
__global__ void __launch_bounds__(kCtaThreads, 1)
    dfeat_kernel(const __grid_constant__ CUtensorMap fmap, const __grid_constant__ CUtensorMap wtmap,
                 const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                 const float* __restrict__ rows, float* __restrict__ dfeat, int hw, int width, int C, int J,
                 int D) {
  constexpr float scale = BASE2 ? 1.f : kLog2e;  // IHPR_EXP2: the logits come in base 2
  unsigned char* base = smem_base();
  const DfLayout L(C);
  const int nkb = L.nkb, nnc = cdiv(C, kBox), nkbb = D > kKb ? 2 : 1, per_joint = df_stages(C, D);
  unsigned char* f_s = base;
  unsigned char* ring = base + L.ring();
  uint64_t* f_full = reinterpret_cast<uint64_t*>(base + L.bars());
  uint64_t* full = f_full + 1;
  uint64_t* empty = full + kStages;
  const int b = blockIdx.y, row0 = blockIdx.x * 2 * kBox, tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(f_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(f_full, 2 * nkb * kTile);
      for (int h = 0; h < 2; ++h)
        for (int kb = 0; kb < nkb; ++kb)
          tma_load_3d(f_s + (h * nkb + kb) * kTile, &fmap, f_full, kb * kKb, row0 + h * kBox, b);
      const int total = J * per_joint, jd = J * kBins;
      for (int n = 0; n < total; ++n) {
        const int s = n % kStages, j = n / per_joint, k = n % per_joint;
        unsigned char* dst = ring + s * 2 * kTile;
        mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kTile);
        if (k < nkb) {  // Wt_j's channel block k: 64 bins x 32 channels
          tma_load_2d(dst, &wtmap, &full[s], k * kKb, j * kBins);
          tma_load_2d(dst + kTile, &wtmap, &full[s], k * kKb, jd + j * kBins);
        } else {  // W_j's bins [32 kbb, + 32) of channels [64 nc, + 64)
          const int kbb = (k - nkb) / nnc, nc = (k - nkb) % nnc;
          tma_load_2d(dst, &wmap, &full[s], j * kBins + kbb * kKb, nc * kBox);
          tma_load_2d(dst + kTile, &wmap, &full[s], j * kBins + kbb * kKb, C + nc * kBox);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, wq = (ctid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = row0 + wg * kBox + wq * 16 + g, r_hi = r_lo + 8;
  const unsigned char* fw = f_s + wg * nkb * kTile;
  const float* rows_b = rows + (size_t)b * J * kRowVals;

  float dacc[kMaxC / kBox][kBins / 2];  // dfeat: channel chunk nc, n64
#pragma unroll
  for (int nc = 0; nc < kMaxC / kBox; ++nc) zero(dacc[nc]);
  mbar_wait(f_full, 0);

  int n = 0;  // the stage counter, as the producer's
  for (int j = 0; j < J; ++j) {
    // S = F Wt_j^T (64 rows x 64 bins).
    float sacc[kBins / 2];
    zero(sacc);
    for (int kb = 0; kb < nkb; ++kb, ++n) {
      const int s = n % kStages;
      uint32_t ah[4][4], al[4][4];
      load_a(fw + kb * kTile, wq, g, t, ah, al);
      mbar_wait(&full[s], (n / kStages) & 1);
      const unsigned char* ws = ring + s * 2 * kTile;
      fence_acc(sacc);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) mma3<kBins>(sacc, ah[q], al[q], kdesc(ws, q), kdesc(ws + kTile, q));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sacc);
      if (lane == 0) mbar_arrive(&empty[s]);  // the warp's products have read the stage
    }

    // dv in place, split into A fragments over bins (as_a); 0 past D and HW.
    const Row r(rows_b + j * kRowVals);
    const float tx_lo = r.tx(r_lo, width), tx_hi = r.tx(r_hi, width);
    uint32_t dh[kBins / 8][4], dl[kBins / 8][4];
#pragma unroll
    for (int i = 0; i < kBins / 8; ++i) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int z = i * 8 + 2 * t + q;
        const bool in = z < D;
        const float bz = in ? __ldg(bias + j * D + z) : 0.f;
        const float tz = r.gz * ((float)z - r.cz);
        float* sv = sacc + 4 * i;
        sv[q] = in && r_lo < hw ? r.dv<BEXP>(sv[q], bz, tx_lo + tz, scale) : 0.f;
        sv[q + 2] = in && r_hi < hw ? r.dv<BEXP>(sv[q + 2], bz, tx_hi + tz, scale) : 0.f;
      }
      const float a[4] = {sacc[4 * i], sacc[4 * i + 2], sacc[4 * i + 1], sacc[4 * i + 3]};  // as_a
      split_a(a, dh[i], dl[i]);
    }

    // dfeat (64 rows x C) += dv W_j.
#pragma unroll
    for (int kbb = 0; kbb < 2; ++kbb) {
      if (kbb >= nkbb) break;
#pragma unroll
      for (int nc = 0; nc < kMaxC / kBox; ++nc) {
        if (nc >= nnc) break;
        const int s = n % kStages;
        mbar_wait(&full[s], (n / kStages) & 1);
        const unsigned char* ws = ring + s * 2 * kTile;
        fence_acc(dacc[nc]);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma3<kBins>(dacc[nc], dh[4 * kbb + q], dl[4 * kbb + q], kdesc(ws, q), kdesc(ws + kTile, q));
        wgmma_commit();
        wgmma_wait<0>();  // one group at a time: with one more in flight ptxas
                          // serialized every wgmma here (C7512, register resources)
        fence_acc(dacc[nc]);
        if (lane == 0) mbar_arrive(&empty[s]);
        ++n;
      }
    }
  }

  float* out = dfeat + (size_t)b * hw * C;
#pragma unroll
  for (int nc = 0; nc < kMaxC / kBox; ++nc) {
#pragma unroll
    for (int i = 0; i < kBins / 8; ++i) {
      const int c = nc * kBox + i * 8 + 2 * t;
      const float* dd = dacc[nc] + 4 * i;
      if (c < C) {
        if (r_lo < hw) *reinterpret_cast<float2*>(out + (size_t)r_lo * C + c) = make_float2(dd[0], dd[1]);
        if (r_hi < hw) *reinterpret_cast<float2*>(out + (size_t)r_hi * C + c) = make_float2(dd[2], dd[3]);
      }
    }
  }
}

// ---- dW ------------------------------------------------------------------------------

// Shared memory: Wt_j's hi tiles [nkb] and lo tiles [nkb], the feature
// tile's channel blocks [nkb] (one ring slot each), the dv^T planes [hi,
// lo][2 row blocks] (64 bins x 128 bytes each; db's warp sums at the end),
// the mbarriers.
struct DwLayout {
  int nkb;
  __host__ __device__ explicit DwLayout(int C) : nkb(C / kKb) {}
  __host__ __device__ size_t ring() const { return (size_t)2 * nkb * kTile; }
  __host__ __device__ size_t dvt() const { return ring() + (size_t)nkb * kTile; }
  __host__ __device__ size_t bars() const { return dvt() + (size_t)4 * kTile; }
  __host__ __device__ size_t bytes() const { return 1024 + bars() + (1 + 2 * nkb) * 8; }
};

// One CTA per (joint j = blockIdx.x, range = blockIdx.y of the B * ntiles
// 64-row feature tiles, sample-major). Writes partial `range` of dW_j (C x
// 64) and db_j (64).
template <bool BEXP, bool BASE2>
__global__ void __launch_bounds__(kCtaThreads, 1)
    dw_kernel(const __grid_constant__ CUtensorMap fmap, const __grid_constant__ CUtensorMap wtmap,
              const float* __restrict__ bias, const float* __restrict__ rows, float* __restrict__ part,
              float* __restrict__ dbpart, int batch, int hw, int width, int C, int J, int D) {
  constexpr float scale = BASE2 ? 1.f : kLog2e;  // IHPR_EXP2: the logits come in base 2
  unsigned char* base = smem_base();
  const DwLayout L(C);
  const int nkb = L.nkb;
  unsigned char* w_s = base;
  unsigned char* ring = base + L.ring();
  uint64_t* w_full = reinterpret_cast<uint64_t*>(base + L.bars());
  uint64_t* full = w_full + 1;
  uint64_t* empty = full + nkb;
  float* red = reinterpret_cast<float*>(base + L.dvt());  // db's [8 warps][64 bins], after the last tile
  const int j = blockIdx.x, range = blockIdx.y, ranges = gridDim.y, tid = threadIdx.x;
  const int ntiles = cdiv(hw, kBox);
  const long long total = (long long)batch * ntiles;
  const int i0 = (int)(total * range / ranges), n = (int)(total * (range + 1) / ranges) - i0;

  if (tid == 0) {
    mbar_init(w_full, 1);
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_init(&full[kb], 1);
      mbar_init(&empty[kb], 4);  // the warps of the warpgroup whose channel tile holds the block
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(w_full, 2 * nkb * kTile);
      for (int kb = 0; kb < nkb; ++kb) {
        tma_load_2d(w_s + kb * kTile, &wtmap, w_full, kb * kKb, j * kBins);
        tma_load_2d(w_s + (nkb + kb) * kTile, &wtmap, w_full, kb * kKb, (J + j) * kBins);
      }
      for (int i = 0; i < n; ++i) {
        const int tt = i0 + i, bb = tt / ntiles, r0 = (tt % ntiles) * kBox;
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(&empty[kb], (i & 1) ^ 1);
          mbar_arrive_expect_tx(&full[kb], kTile);
          tma_load_3d(ring + kb * kTile, &fmap, &full[kb], kb * kKb, r0, bb);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, warp = ctid >> 5, wq = warp & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nmt = cdiv(C, kBox);  // channel tiles of 64
  const int zw = wg * kKb;        // this warpgroup's first bin of the logits
  unsigned char* dvt_hi = base + L.dvt();  // [2 row blocks] x kTile
  unsigned char* dvt_lo = dvt_hi + 2 * kTile;

  float wacc[2][kBins / 2];  // dW_j, channel tiles wg and wg + 2, all 64 bins
  zero(wacc[0]);
  zero(wacc[1]);
  float db[kKb / 8][2] = {};  // db over bins zw + 8i + 2t + q, this thread's rows
  float bz[kKb / 8][2];
#pragma unroll
  for (int i = 0; i < kKb / 8; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int z = zw + i * 8 + 2 * t + q;
      bz[i][q] = z < D ? __ldg(bias + j * D + z) : 0.f;
    }
  mbar_wait(w_full, 0);

  for (int i = 0; i < n; ++i) {
    const int tt = i0 + i, bb = tt / ntiles, r0 = (tt % ntiles) * kBox;
    const uint32_t par = i & 1;

    // S = F Wt_j^T for this warpgroup's bins (64 rows x 32 bins).
    float sacc[kKb / 2];
    zero(sacc);
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(&full[kb], par);
      uint32_t ah[4][4], al[4][4];
      load_a(ring + kb * kTile, wq, g, t, ah, al);
      fence_acc(sacc);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mma3<kKb>(sacc, ah[q], al[q], kdesc(w_s + kb * kTile + wg * (kTile / 2), q),
                  kdesc(w_s + (nkb + kb) * kTile + wg * (kTile / 2), q));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sacc);
    }

    // dv in place; db's sums; then dv^T's planes, once both warpgroups'
    // products of the last tile have read them.
    const Row r(rows + ((size_t)bb * J + j) * kRowVals);
    const int rl = wq * 16 + g, rh = rl + 8;  // rows in the tile
    const float tx_lo = r.tx(r0 + rl, width), tx_hi = r.tx(r0 + rh, width);
    const bool ok_lo = r0 + rl < hw, ok_hi = r0 + rh < hw;
#pragma unroll
    for (int ii = 0; ii < kKb / 8; ++ii) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int z = zw + ii * 8 + 2 * t + (e & 1);
        const float tz = r.gz * ((float)z - r.cz);
        float& v = sacc[4 * ii + e];
        v = z < D && ((e & 2) ? ok_hi : ok_lo) ? r.dv<BEXP>(v, bz[ii][e & 1], ((e & 2) ? tx_hi : tx_lo) + tz, scale) : 0.f;
        db[ii][e & 1] += v;
      }
    }
    named_barrier(1, 256);  // both warpgroups' dW products of the last tile are done
#pragma unroll
    for (int ii = 0; ii < kKb / 8; ++ii) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int z = zw + ii * 8 + 2 * t + (e & 1), row = (e & 2) ? rh : rl;
        uint32_t hi, lo;
        split_v(sacc[4 * ii + e], hi, lo);
        const int off = (row >> 5) * kTile + swz(z, row & 31);
        *reinterpret_cast<uint32_t*>(dvt_hi + off) = hi;
        *reinterpret_cast<uint32_t*>(dvt_lo + off) = lo;
      }
    }
    fence_proxy_async();
    named_barrier(2, 256);  // dv^T complete

    // dW_j (channel tiles wg, wg + 2: 64 channels x 64 bins) += F^T dv.
    // A: m row 16 wq + g (+ 8) is channel 64 mt + 16 wq + 2g (+ 1), k-slot
    // t (+ 4) of k-step s is tile row 8s + t (+ 4); each k-step's products
    // issue as soon as its A is split.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mt = wg + 2 * h;
      if (mt >= nmt) break;
      const int c = mt * kBox + wq * 16 + 2 * g;  // this thread's channel pair
      const bool c_in = c < C;
      const unsigned char* blk = ring + (c_in ? c / kKb : 0) * kTile;
      uint32_t ah[8][4], al[8][4];  // k-step s's own registers: no wgmma of this tile waits on another's
      fence_acc(wacc[h]);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        float2 x0 = make_float2(0.f, 0.f), x1 = x0;
        if (c_in) {
          x0 = *reinterpret_cast<const float2*>(blk + swz(8 * s + t, c % kKb));
          x1 = *reinterpret_cast<const float2*>(blk + swz(8 * s + t + 4, c % kKb));
        }
        const float a[4] = {x0.x, x0.y, x1.x, x1.y};
        split_a(a, ah[s], al[s]);
        wgmma_fence();
        mma3<kBins>(wacc[h], ah[s], al[s], kdesc(dvt_hi + (s >> 2) * kTile, s & 3),
                    kdesc(dvt_lo + (s >> 2) * kTile, s & 3));
      }
      wgmma_commit();
      __syncwarp();
      if (lane == 0) {  // the channel tile's blocks are read: the next tile's may land
        mbar_arrive(&empty[2 * mt]);
        if (2 * mt + 1 < nkb) mbar_arrive(&empty[2 * mt + 1]);
      }
      wgmma_wait<0>();
      fence_acc(wacc[h]);
    }
    // Every kFlush tiles (and at the end) the accumulators are added to the
    // partial with round to nearest and start again from 0: summed by the
    // tensor cores over a whole range (~10^5 rows at B = 128) they erred by
    // 1.6e-4 of dW's largest (PERF.md §6).
    if ((i + 1) % kFlush == 0 || i + 1 == n) {
      float* out = part + ((size_t)range * J + j) * C * kBins;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mt = wg + 2 * h, c = mt * kBox + wq * 16 + 2 * g;
        if (mt >= nmt || c >= C) continue;
#pragma unroll
        for (int ii = 0; ii < kBins / 8; ++ii) {
          float* w = wacc[h] + 4 * ii;
          float2* o0 = reinterpret_cast<float2*>(out + (size_t)c * kBins + ii * 8 + 2 * t);
          float2* o1 = reinterpret_cast<float2*>(out + (size_t)(c + 1) * kBins + ii * 8 + 2 * t);
          const float2 p0 = i < kFlush ? make_float2(0.f, 0.f) : *o0, p1 = i < kFlush ? make_float2(0.f, 0.f) : *o1;
          *o0 = make_float2(p0.x + w[0], p0.y + w[1]);
          *o1 = make_float2(p1.x + w[2], p1.y + w[3]);
          w[0] = w[1] = w[2] = w[3] = 0.f;
        }
      }
    }
  }

  // db_j partial: each warp's sums over its lanes' rows (g), then the 4
  // warps of the bins' warpgroup, in order.
  named_barrier(1, 256);  // both warpgroups' last products have read dv^T
#pragma unroll
  for (int ii = 0; ii < kKb / 8; ++ii)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float v = db[ii][q];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[warp * kBins + zw + ii * 8 + 2 * t + q] = v;
    }
  named_barrier(1, 256);
  if (ctid < kBins) {
    const int w0 = (ctid / kKb) * 4;  // the warps of the bin's warpgroup
    float v = red[w0 * kBins + ctid];
    for (int w = 1; w < 4; ++w) v += red[(w0 + w) * kBins + ctid];
    dbpart[((size_t)range * J + j) * kBins + ctid] = v;
  }
}

// dW[c, j*D + z] = sum_p part[p, j, c, z] and db[j*D + z] = sum_p dbpart[p, j, z],
// in partial order, times dscale (log2 e for IHPR_EXP2, else 1).
__global__ void reduce_kernel(const float* __restrict__ part, const float* __restrict__ dbpart,
                              float* __restrict__ dw, float* __restrict__ db, int parts, int C, int J, int D,
                              float dscale) {
  const size_t n = (size_t)J * C * kBins;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int z = (int)(i % kBins);
    const size_t jc = i / kBins;
    const int c = (int)(jc % C), j = (int)(jc / C);
    if (z < D) {
      float s = 0.f;
#pragma unroll 8
      for (int p = 0; p < parts; ++p) s += part[(size_t)p * n + i];
      dw[(size_t)c * J * D + j * D + z] = s * dscale;
    }
  }
  if (i < (size_t)J * kBins) {
    const int z = (int)(i % kBins), j = (int)(i / kBins);
    if (z < D) {
      float s = 0.f;
      for (int p = 0; p < parts; ++p) s += dbpart[(size_t)p * J * kBins + i];
      db[j * D + z] = s * dscale;
    }
  }
}

// The dfeat and dW launches with the exp modes' kernels (the natural base's
// instance keeps the constant log2 e of the kernels before the modes).
template <bool BEXP, bool BASE2>
cudaError_t launch_products(const CUtensorMap& fmap, const CUtensorMap& wtmap, const CUtensorMap& wmap,
                            const float* bias, const float* rows, void* dfeat, float* part, float* dbpart,
                            int batch, int hw, int width, int C, int J, int D, int parts, cudaStream_t st) {
  const size_t smem_a = DfLayout(C).bytes();
  cudaError_t err =
      cudaFuncSetAttribute(dfeat_kernel<BEXP, BASE2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  dfeat_kernel<BEXP, BASE2><<<dim3(cdiv(hw, 2 * kBox), batch), kCtaThreads, smem_a, st>>>(
      fmap, wtmap, wmap, bias, rows, static_cast<float*>(dfeat), hw, width, C, J, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_b = DwLayout(C).bytes();
  err = cudaFuncSetAttribute(dw_kernel<BEXP, BASE2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;
  dw_kernel<BEXP, BASE2><<<dim3(J, parts), kCtaThreads, smem_b, st>>>(fmap, wtmap, bias, rows, part, dbpart, batch,
                                                               hw, width, C, J, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest shared memory one CTA of the backward needs for C channels.
size_t ihpr_fused_head_integral_bwd_f32_smem(int C) { return std::max(DfLayout(C).bytes(), DwLayout(C).bytes()); }

// Channels the kernels' accumulators hold.
int ihpr_fused_head_integral_bwd_f32_max_channels() { return kMaxC; }

// The pre-pass alone: w (C, J*D) fp32 -> planes (4, J*64, C): Wt's hi and
// lo planes (2, J*64, C), then W's (2, C, J*64) (what
// ops/fused_head_integral.py:split_planes computes). Returns the launch's
// cudaError_t.
int ihpr_fused_head_integral_bwd_f32_split(const void* w, void* planes, int C, int J, int D, void* stream) {
  if (C % kKb || D < 1 || D > kBins) return (int)cudaErrorInvalidValue;
  float* wt = static_cast<float*>(planes);
  return (int)split_planes(static_cast<const float*>(w), wt, wt + (size_t)2 * J * kBins * C, C, J, D,
                           static_cast<cudaStream_t>(stream));
}

// Partials of dW / db the backward should write for this shape on the
// current device: one per feature-tile range of the dW kernel, with as many
// (joint, range) CTAs as the card has SMs (one wave), at least one range
// and at most one tile per range.
int ihpr_fused_head_integral_bwd_f32_partials(int batch, int hw, int J) {
  const long long tiles = (long long)batch * cdiv(hw, kBox);
  return (int)std::max(1LL, std::min<long long>(sm_count() / J, tiles));
}

// feat (batch, hw, C), w (C, J*D), bias (J*D,): contiguous fp32, feat
// 16-byte aligned, C a multiple of 32 up to 256. rows (batch, J, 8) fp32:
// m + log s, gx, gy, gz, cx, cy, cz, 0. Scratch: planes (4, J*64, C) fp32
// (Wt's hi and lo, then W's), part (parts, J, C, 64) and dbpart (parts, J,
// 64) fp32, parts positive (as ihpr_fused_head_integral_bwd_f32_partials
// gives it). Writes dfeat (batch, hw, C), dw (C, J*D) and db (J*D,) in
// fp32. mode: the exp modes, as ihpr_fused_head_integral_bwd takes them.
// Returns 0, the CUresult of a tensor-map encoding, or the first
// cudaError_t of the four launches.
int ihpr_fused_head_integral_bwd_f32(const void* feat, const void* w, const void* bias, const float* rows,
                                     void* planes, float* part, float* dbpart, void* dfeat, void* dw, void* db,
                                     int batch, int hw, int width, int C, int J, int D, int parts, int mode,
                                     void* stream) {
  if (parts < 1 || C % kKb || C > kMaxC || D < 1 || D > kBins) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int jd = J * kBins;
  float* wt_planes = static_cast<float*>(planes);
  float* w_planes = wt_planes + (size_t)2 * jd * C;
  const auto* bias_c = static_cast<const float*>(bias);
  cudaError_t err = split_planes(static_cast<const float*>(w), wt_planes, w_planes, C, J, D, st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap fmap, wtmap, wmap;
  int terr = tmap_batched_f32(&fmap, feat, batch, hw, C);
  if (!terr) terr = tmap_matrix_f32(&wtmap, wt_planes, (uint64_t)2 * jd, C);
  if (!terr) terr = tmap_matrix_f32(&wmap, w_planes, (uint64_t)2 * C, jd);
  if (terr) return terr;

  const bool base2 = mode & kModeExp2;
  auto launch = [&](auto products) {
    return products(fmap, wtmap, wmap, bias_c, rows, dfeat, part, dbpart, batch, hw, width, C, J, D, parts, st);
  };
  err = (mode & kModeBexp) ? (base2 ? launch(launch_products<true, true>) : launch(launch_products<true, false>))
                           : (base2 ? launch(launch_products<false, true>) : launch(launch_products<false, false>));
  if (err != cudaSuccess) return (int)err;

  const size_t n = (size_t)J * C * kBins;
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, dbpart, static_cast<float*>(dw),
                                                              static_cast<float*>(db), parts, C, J, D,
                                                              base2 ? kLog2e : 1.f);
  return (int)cudaGetLastError();
}

}  // extern "C"
