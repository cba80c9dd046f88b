// Fused final 1x1 conv + integral soft-argmax, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/fused_head_integral.py:_bwd_kernel
// (launched by _bwd_call; dv from integral_pallas._dv_from_rows).
//
// What it computes. The forward (K1, fused_head_integral_fwd.cu) turned the
// head features feat[b] (HW x C) into logits v = feat W + bias, a softmax p
// per (sample b, joint j) over all (row r, depth bin z), and coords
// (sum p x, sum p y, sum p z). Given the coords' cotangent g (B, J, 3) and
// K1's per-joint max m and normalizer s, the backward is
//     p     = exp(v - (m + log s))                      (recomputed, fp32)
//     dv    = p * (gx (x - cx) + gy (y - cy) + gz (z - cz))   (fp32)
//     dvc   = dv rounded to bf16
//     dfeat = dvc W^T          (B, HW, C), fp32 accumulate, bf16
//     dW    = sum_b feat^T dvc (C, J*D),   fp32 accumulate, bf16
//     db    = sum_{b,r} dv     (J*D,),     fp32, bf16
// the rounding of ops/fused_head_integral.py:plain_bwd (and of the TPU
// kernel). bf16 only, as K1. The logits are recomputed in each kernel and
// never written, nor is dv.
//
// Design: four launches. dfeat contracts over all J*D columns and dW over
// all rows of all samples, so no one layout of CTAs owns both sums:
//   1. transpose (fused_head_common.cuh): W (C, J*D) -> Wt (J*D, C), whose
//      2C-byte pitch TMA can copy; a joint's 64-row slab of Wt is K-major
//      for feat W_j and MN-major for dv W_j^T.
//   2. dfeat_kernel, one CTA per (128 rows, sample): each consumer
//      warpgroup keeps its 64 feature rows in shared memory (TMA, once) and
//      walks every joint while the producer streams Wt_j through a ring.
//      Per joint: S = F W_j (wgmma, both operands from shared memory), dv in
//      fp32 registers, rounded to bf16 in place as the A fragments of the
//      next wgmma (two adjacent 8-column accumulator chunks make one k16
//      fragment), dfeat_acc (64 x C fp32, registers) += dv W_j^T with B the
//      same Wt_j tile read MN-major. dv never touches shared memory.
//   3. dw_kernel, one CTA per (joint, range of feature tiles): Wt_j stays
//      resident, the range's 64-row tiles of feat (any samples) stream
//      through a ring; the two consumer warpgroups take alternate tiles.
//      Per tile: S = F W_j, dv, db's column sums in fp32, bf16 dv into the
//      warpgroup's shared-memory tile (128-byte swizzle, MN-major B), then
//      dW_acc (C x 64 fp32, registers) += F^T dv with A = the feature tile
//      read M-major. Each warpgroup writes its partial: 2 x ranges x J x C x
//      64 fp32 (ranges = SMs / J, 7 at J = 18: 16.5 MB at C = 256, against
//      v1's B*J*C*64, 151 MB at B = 128).
//   4. reduce_kernel: dW and db as the sums of the partials in a fixed
//      order, rounded once.
// Every sum has a fixed order, so dW, db and dfeat are bitwise the same
// from run to run (on one card: the ranges follow its SM count); nothing
// is atomic. The TPU kernel instead carried dW/db in VMEM scratch across a
// grid that runs in order, which on a GPU grid would race.
//
// Shapes: any J, D <= 64 and any HW, as K1; C a multiple of 16 up to 256
// (the register accumulators). Masked columns (z >= D) get a -inf logit so
// p = 0 and dv = 0 exactly; rows past HW get dv = 0; neither adds anything.
//
// What bounds it on an H100. 4 * 2*B*HW*C*J*D flops (1.24 TFLOP at the
// flagship 128 x 4096 x 256 x 1152), compute bound on the tensor cores.
// v1 (mma.sync fed by ldmatrix, dv staged in shared memory, 151 MB of
// partials) took 6.9 ms. Beside the products: two ex2 passes (one per
// kernel), Wt_j re-read from L2 by every dfeat CTA (J x 32 KB), feat
// re-read from L2 by the J dW CTAs of a range, and each warpgroup waiting
// on its own wgmma between the two products of a joint or tile (the other
// warpgroup's work fills that gap).

#include <algorithm>

#include "fused_head_common.cuh"
#include "hopper.cuh"

namespace {

using namespace fhi;
using namespace hopper;

constexpr int kMaxC = 256;         // channels the register accumulators hold
constexpr int kMaxKb = kMaxC / kBox;
constexpr int kRowVals = 8;        // per (b, j): m + log s, gx, gy, gz, cx, cy, cz, 0
constexpr int kStages = 4;         // Wt_j slabs (dfeat) or feature tiles (dW) in flight
constexpr int kCtaThreads = 384;   // producer warpgroup + 2 consumer warpgroups

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
};

// Turns this thread's logits accumulator S (v - bias, 64 rows x 64 bins of
// joint j) into fp32 dv in place: cb(z) = bias - (m + log s), -inf past D,
// so p = 0 there. Rows not ok get dv = 0.
template <typename Bias>
__device__ __forceinline__ void form_dv(float (&acc)[32], const Row& r, Bias bias_of, int D,
                                        float tx_lo, float tx_hi, bool ok_lo, bool ok_hi, int tig) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int z = nt * 8 + 2 * tig + q;
      const float cb = z < D ? bias_of(z) - r.lse : neg_inf();
      const float tz = z < D ? r.gz * ((float)z - r.cz) : 0.f;
      const int lo = nt * 4 + q, hi = lo + 2;
      acc[lo] = ok_lo ? ex2((acc[lo] + cb) * kLog2e) * (tx_lo + tz) : 0.f;
      acc[hi] = ok_hi ? ex2((acc[hi] + cb) * kLog2e) * (tx_hi + tz) : 0.f;
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (64 rows x 64 bins) = F (64 rows x C) W_j, both K-major tiles of nkb
// 64-channel blocks 8192 bytes apart.
__device__ __forceinline__ void logits(float (&acc)[32], const unsigned char* f,
                                       const unsigned char* w, int nkb) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_acc(acc);
  wgmma_fence();
  for (int kk = 0; kk < 4 * nkb; ++kk) {
    const int off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
    mma_ss_n64<0, 0>(acc, desc_sw128(f + off, 16, 1024), desc_sw128(w + off, 16, 1024));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

struct DfeatLayout {
  int nkb;
  __host__ __device__ explicit DfeatLayout(int C) : nkb((C + kBox - 1) / kBox) {}
  __host__ __device__ size_t ring() const { return (size_t)2 * nkb * kBoxBytes; }
  __host__ __device__ size_t bars() const { return ring() + (size_t)kStages * nkb * kBoxBytes; }
  __host__ __device__ size_t bytes() const { return 1024 + bars() + (1 + 2 * kStages) * 8; }
};

__global__ void __launch_bounds__(kCtaThreads, 1)
    dfeat_kernel(const __grid_constant__ CUtensorMap fmap, const __grid_constant__ CUtensorMap wmap,
                 const __nv_bfloat16* __restrict__ bias, const float* __restrict__ rows,
                 __nv_bfloat16* __restrict__ dfeat, int hw, int width, int C, int J, int D) {
  unsigned char* base = smem_base();
  const DfeatLayout L(C);
  const int nkb = L.nkb;
  unsigned char* feat_s = base;  // [2 warpgroups][nkb][64 rows]
  unsigned char* ring = base + L.ring();  // [kStages][nkb][64 rows of Wt_j]
  uint64_t* f_full = reinterpret_cast<uint64_t*>(base + L.bars());
  uint64_t* full = f_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.y, row0 = blockIdx.x * 2 * kBox;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(f_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp reads every slab
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(f_full, 2 * nkb * kBoxBytes);
      for (int h = 0; h < 2; ++h) {
        // A half wholly past HW loads rows from inside the sample instead;
        // all its rows are masked.
        const int r = row0 + h * kBox < hw ? row0 + h * kBox : max(hw - kBox, 0);
        for (int kb = 0; kb < nkb; ++kb)
          tma_load_3d(feat_s + (h * nkb + kb) * kBoxBytes, &fmap, f_full, kb * kBox, r, b);
      }
      for (int j = 0; j < J; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], nkb * kBoxBytes);
        for (int kb = 0; kb < nkb; ++kb)
          tma_load_2d(ring + (s * nkb + kb) * kBoxBytes, &wmap, &full[s], kb * kBox, j * D);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, wq = (ctid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int r_lo = row0 + wg * kBox + wq * 16 + g, r_hi = r_lo + 8;
  const bool ok_lo = r_lo < hw, ok_hi = r_hi < hw;
  const unsigned char* f = feat_s + wg * nkb * kBoxBytes;
  const float* rows_b = rows + (size_t)b * J * kRowVals;

  float dacc[kMaxKb][32];
#pragma unroll
  for (int kb = 0; kb < kMaxKb; ++kb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dacc[kb][i] = 0.f;
  mbar_wait(f_full, 0);

  for (int j = 0; j < J; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    const unsigned char* w = ring + s * nkb * kBoxBytes;
    float acc[32];
    logits(acc, f, w, nkb);
    const Row r(rows_b + j * kRowVals);
    const __nv_bfloat16* bias_j = bias + j * D;
    form_dv(acc, r, [bias_j](int z) { return __bfloat162float(bias_j[z]); }, D,
            r.tx(r_lo, width), r.tx(r_hi, width), ok_lo, ok_hi, tig);
    // dv in bf16 as wgmma A fragments: k-step ks (bins 16 ks ...) is
    // accumulator chunks 2 ks (a0 row g, a1 row g+8) and 2 ks + 1 (a2, a3).
    uint32_t af[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      af[nt >> 1][(nt & 1) * 2] = pack_bf16(acc[nt * 4], acc[nt * 4 + 1]);
      af[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(acc[nt * 4 + 2], acc[nt * 4 + 3]);
    }
#pragma unroll
    for (int kb = 0; kb < kMaxKb; ++kb) fence_acc(dacc[kb]);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kMaxKb; ++kb) {
      if (kb < nkb) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          mma_rs_n64(dacc[kb], af[ks], desc_sw128(w + kb * kBoxBytes + ks * 2048, kBoxBytes, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kb = 0; kb < kMaxKb; ++kb) fence_acc(dacc[kb]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* out = dfeat + (size_t)b * hw * C;
#pragma unroll
  for (int kb = 0; kb < kMaxKb; ++kb) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = kb * kBox + nt * 8 + 2 * tig;
      if (kb < nkb && c < C) {
        if (ok_lo) Elem<__nv_bfloat16>::store2(out + (size_t)r_lo * C + c, dacc[kb][nt * 4], dacc[kb][nt * 4 + 1]);
        if (ok_hi) Elem<__nv_bfloat16>::store2(out + (size_t)r_hi * C + c, dacc[kb][nt * 4 + 2], dacc[kb][nt * 4 + 3]);
      }
    }
  }
}

struct DwLayout {
  int nkb;
  __host__ __device__ explicit DwLayout(int C) : nkb((C + kBox - 1) / kBox) {}
  __host__ __device__ size_t ring() const { return (size_t)nkb * kBoxBytes; }
  __host__ __device__ size_t dv() const { return ring() + (size_t)kStages * nkb * kBoxBytes; }
  __host__ __device__ size_t bars() const { return dv() + 2 * kBoxBytes; }
  __host__ __device__ size_t bias() const { return bars() + (1 + 2 * kStages) * 8; }
  __host__ __device__ size_t red() const { return bias() + kBox * sizeof(float); }
  __host__ __device__ size_t bytes() const { return 1024 + red() + 8 * kBox * sizeof(float); }
};

// One CTA per (joint j = blockIdx.x, range r = blockIdx.y of the B * ntiles
// 64-row feature tiles, sample-major). Writes partials 2r and 2r + 1 (one
// per consumer warpgroup) of dW_j (C x 64) and db_j (64).
__global__ void __launch_bounds__(kCtaThreads, 1)
    dw_kernel(const __grid_constant__ CUtensorMap fmap, const __grid_constant__ CUtensorMap wmap,
              const __nv_bfloat16* __restrict__ bias, const float* __restrict__ rows,
              float* __restrict__ part, float* __restrict__ dbpart, int batch, int hw, int width,
              int C, int J, int D) {
  unsigned char* base = smem_base();
  const DwLayout L(C);
  const int nkb = L.nkb;
  unsigned char* w_s = base;              // [nkb][64 rows of Wt_j]
  unsigned char* ring = base + L.ring();  // [kStages][nkb][64 feature rows]
  unsigned char* dv_s = base + L.dv();    // [2 warpgroups][64 rows][64 bins], MN-major
  uint64_t* w_full = reinterpret_cast<uint64_t*>(base + L.bars());
  uint64_t* full = w_full + 1;
  uint64_t* empty = full + kStages;
  float* bias_s = reinterpret_cast<float*>(base + L.bias());
  float* red = reinterpret_cast<float*>(base + L.red());  // [8 warps][64 bins]

  const int j = blockIdx.x, range = blockIdx.y, ranges = gridDim.y;
  const int ntiles = (hw + kBox - 1) / kBox;
  const long long total = (long long)batch * ntiles;
  const int t0 = (int)(total * range / ranges), n = (int)(total * (range + 1) / ranges) - t0;
  const int tid = threadIdx.x;

  if (tid < kBox) bias_s[tid] = tid < D ? __bfloat162float(bias[j * D + tid]) : 0.f;
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
      mbar_arrive_expect_tx(w_full, nkb * kBoxBytes);
      for (int kb = 0; kb < nkb; ++kb) tma_load_2d(w_s + kb * kBoxBytes, &wmap, w_full, kb * kBox, j * D);
      for (int i = 0; i < n; ++i) {
        const int t = t0 + i, s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], nkb * kBoxBytes);
        for (int kb = 0; kb < nkb; ++kb)
          tma_load_3d(ring + (s * nkb + kb) * kBoxBytes, &fmap, &full[s], kb * kBox,
                      (t % ntiles) * kBox, t / ntiles);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, warp = ctid >> 5, wq = warp & 3;
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3;
  unsigned char* dv = dv_s + wg * kBoxBytes;

  float wacc[kMaxKb][32];
  float dbacc[16];
#pragma unroll
  for (int kb = 0; kb < kMaxKb; ++kb)
#pragma unroll
    for (int i = 0; i < 32; ++i) wacc[kb][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) dbacc[i] = 0.f;
  mbar_wait(w_full, 0);

  for (int i = wg; i < n; i += 2) {
    const int t = t0 + i, s = i % kStages;
    const int bb = t / ntiles, row0 = (t % ntiles) * kBox;
    mbar_wait(&full[s], (i / kStages) & 1);
    const unsigned char* tile = ring + s * nkb * kBoxBytes;
    float acc[32];
    logits(acc, tile, w_s, nkb);
    const Row r(rows + ((size_t)bb * J + j) * kRowVals);
    const int l_lo = wq * 16 + g, l_hi = l_lo + 8;  // rows of the tile
    form_dv(acc, r, [bias_s](int z) { return bias_s[z]; }, D, r.tx(row0 + l_lo, width),
            r.tx(row0 + l_hi, width), row0 + l_lo < hw, row0 + l_hi < hw, tig);
    // db in fp32; dv in bf16 into the tile's MN-major B operand: bin z of
    // row l at byte l*128 + ((z/8) ^ (l%8))*16 + (z%8)*2.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      dbacc[2 * nt] += acc[nt * 4] + acc[nt * 4 + 2];
      dbacc[2 * nt + 1] += acc[nt * 4 + 1] + acc[nt * 4 + 3];
      const int chunk = ((nt ^ g) << 4) + tig * 4;
      *reinterpret_cast<uint32_t*>(dv + l_lo * 128 + chunk) = pack_bf16(acc[nt * 4], acc[nt * 4 + 1]);
      *reinterpret_cast<uint32_t*>(dv + l_hi * 128 + chunk) = pack_bf16(acc[nt * 4 + 2], acc[nt * 4 + 3]);
    }
    fence_proxy_async();
    named_barrier(2 + wg, 128);  // the warpgroup's dv tile is complete
#pragma unroll
    for (int kb = 0; kb < kMaxKb; ++kb) fence_acc(wacc[kb]);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kMaxKb; ++kb) {
      if (kb < nkb) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          mma_ss_n64<1, 1>(wacc[kb], desc_sw128(tile + kb * kBoxBytes + ks * 2048, kBoxBytes, 1024),
                           desc_sw128(dv + ks * 2048, kBoxBytes, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kb = 0; kb < kMaxKb; ++kb) fence_acc(wacc[kb]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // dW_j partial: channel kb*64 + 16 wq + g (+8), bin 8 nt + 2 tig (+1).
  const int p = 2 * range + wg;
  float* out = part + ((size_t)p * J + j) * C * kBox;
#pragma unroll
  for (int kb = 0; kb < kMaxKb; ++kb) {
    const int c = kb * kBox + wq * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int z = nt * 8 + 2 * tig;
      if (kb < nkb && c < C)
        *reinterpret_cast<float2*>(out + (size_t)c * kBox + z) = make_float2(wacc[kb][nt * 4], wacc[kb][nt * 4 + 1]);
      if (kb < nkb && c + 8 < C)
        *reinterpret_cast<float2*>(out + (size_t)(c + 8) * kBox + z) =
            make_float2(wacc[kb][nt * 4 + 2], wacc[kb][nt * 4 + 3]);
    }
  }
  // db_j partial: the column sums over the 8 row groups of each warp, then
  // the warpgroup's 4 warps in order.
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    float v = dbacc[q];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (g == 0) red[warp * kBox + (q >> 1) * 8 + 2 * tig + (q & 1)] = v;
  }
  named_barrier(2 + wg, 128);
  const int z = ctid & 127;
  if (z < kBox) {
    const float* rw = red + wg * 4 * kBox;
    dbpart[((size_t)p * J + j) * kBox + z] = ((rw[z] + rw[kBox + z]) + rw[2 * kBox + z]) + rw[3 * kBox + z];
  }
}

// dW[c, j*D + z] = sum_p part[p, j, c, z] and db[j*D + z] = sum_p dbpart[p, j, z],
// in partial order, rounded once to bf16.
__global__ void reduce_kernel(const float* __restrict__ part, const float* __restrict__ dbpart,
                              __nv_bfloat16* __restrict__ dw, __nv_bfloat16* __restrict__ db,
                              int parts, int C, int J, int D) {
  const size_t n = (size_t)J * C * kBox;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int z = (int)(i % kBox);
    const size_t jc = i / kBox;
    const int c = (int)(jc % C), j = (int)(jc / C);
    if (z < D) {
      float s = 0.f;
#pragma unroll 8
      for (int p = 0; p < parts; ++p) s += part[(size_t)p * n + i];
      dw[(size_t)c * J * D + j * D + z] = __float2bfloat16(s);
    }
  }
  if (i < (size_t)J * kBox) {
    const int z = (int)(i % kBox), j = (int)(i / kBox);
    if (z < D) {
      float s = 0.f;
      for (int p = 0; p < parts; ++p) s += dbpart[(size_t)p * J * kBox + i];
      db[j * D + z] = __float2bfloat16(s);
    }
  }
}

}  // namespace

extern "C" {

// Largest shared memory one CTA of the backward needs for C channels.
size_t ihpr_fused_head_integral_bwd_smem(int C) {
  const size_t a = DfeatLayout(C).bytes(), b = DwLayout(C).bytes();
  return a > b ? a : b;
}

// Channels the kernels' register accumulators hold.
int ihpr_fused_head_integral_bwd_max_channels() { return kMaxC; }

// Partials of dW / db the backward should write for this shape on the
// current device: two (one per consumer warpgroup) per feature-tile range
// of the dW kernel, with as many (joint, range) CTAs as the card has SMs
// (one wave), at least one range and at most one tile per range.
int ihpr_fused_head_integral_bwd_partials(int batch, int hw, int J) {
  const int sms = hopper::sm_count();
  const long long tiles = (long long)batch * ((hw + kBox - 1) / kBox);
  return 2 * (int)std::max(1LL, std::min<long long>(sms / J, tiles));
}

// feat (batch, hw, C), w (C, J*D), bias (J*D,): contiguous bf16, feat
// 16-byte aligned. rows (batch, J, 8) fp32: m + log s, gx, gy, gz, cx, cy,
// cz, 0. Scratch: wt (J*D, C) bf16, part (parts, J, C, 64) and dbpart
// (parts, J, 64) fp32, parts even and positive (as
// ihpr_fused_head_integral_bwd_partials gives it). Writes dfeat (batch,
// hw, C), dw (C, J*D) and db (J*D,) in bf16. Returns 0, the CUresult of a
// tensor-map encoding, or the first cudaError_t of the four launches.
int ihpr_fused_head_integral_bwd(const void* feat, const void* w, const void* bias,
                                 const float* rows, void* wt, float* part, float* dbpart,
                                 void* dfeat, void* dw, void* db, int batch, int hw, int width,
                                 int C, int J, int D, int parts, void* stream) {
  if (parts < 2 || parts % 2) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int jd = J * D;
  const auto* bias_h = static_cast<const __nv_bfloat16*>(bias);
  cudaError_t err = transpose(static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wt),
                              C, jd, st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap fmap, wmap;
  int terr = tmap_batched(&fmap, feat, batch, hw, C);
  if (!terr) terr = tmap_matrix(&wmap, wt, jd, C);
  if (terr) return terr;

  const size_t smem_a = DfeatLayout(C).bytes();
  err = cudaFuncSetAttribute(dfeat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  dfeat_kernel<<<dim3((hw + 2 * kBox - 1) / (2 * kBox), batch), kCtaThreads, smem_a, st>>>(
      fmap, wmap, bias_h, rows, static_cast<__nv_bfloat16*>(dfeat), hw, width, C, J, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int ranges = parts / 2;
  const size_t smem_b = DwLayout(C).bytes();
  err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  dw_kernel<<<dim3(J, ranges), kCtaThreads, smem_b, st>>>(fmap, wmap, bias_h, rows, part, dbpart,
                                                         batch, hw, width, C, J, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t n = (size_t)J * C * kBox;
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, dbpart, static_cast<__nv_bfloat16*>(dw), static_cast<__nv_bfloat16*>(db), parts, C, J, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
