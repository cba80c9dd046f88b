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
// never written. Every product is 3xTF32 on mma.sync m16n8k8 (tf32x3.cuh).
//
// Design: four launches, as K2's (bf16): dfeat contracts over all J*D
// columns and dW over all rows of all samples, so no one layout of CTAs
// owns both sums.
//   1. transpose (fused_head_common.cuh): W (C, J*D) -> Wt (J*D, C).
//   2. dfeat_kernel, one CTA (8 warps) per (128 rows, sample): the rows
//      stay in shared memory, and Wt streams through a two-stage cp.async
//      ring in chunks of 32 bins of one joint. Per chunk each warp forms
//      S = F W (16 rows x 32 bins), turns it into dv in registers, and
//      adds dv W^T to its 16 x C dfeat accumulator; dv's accumulator
//      fragments serve as the next product's A operand in place
//      (tf32x3::as_a), so dv never touches shared memory.
//   3. dw_kernel, one CTA per (joint, range of 32-row feature tiles, any
//      samples): Wt_j stays resident; the warps form two groups of four
//      that take alternate tiles of a two-stage ring, and each warp owns 16
//      bins. Per tile: S^T = W_j^T F^T (16 bins x 32 rows), dv^T in place,
//      db's sums in fp32, then dW_j^T (16 bins x C, registers) += dv^T F.
//      Each group writes its partial: 2 x ranges x J x C x 64 fp32.
//   4. reduce_kernel: dW and db as the sums of the partials in a fixed
//      order.
// Every sum has a fixed order, so the results are bitwise the same from
// run to run (on one card: the ranges follow its SM count); nothing is
// atomic. The TPU kernel carried dW / db in VMEM scratch across a grid that
// runs in order, which on a GPU grid would race.
//
// Shapes: any J, D <= 64, any HW; C a multiple of 32 up to 256 (the
// register accumulators). Bins past D get dv = 0 and rows past HW dv = 0;
// neither adds anything.
//
// What bounds it on an H100: three products, 3 * 3 * 2*B*HW*C*J*D
// tensor-core operations at TF32's 494.7 TFLOP/s (5.625 ms at 128 x 4096 x
// 256 x 1152), against reading feat and writing dfeat once (2*B*HW*C*4
// bytes): compute bound. Beside the products: the operand splits, two exp
// passes (one per kernel), Wt re-read from L2 by every dfeat CTA, and feat
// re-read from L2 by the J dW CTAs of a range.

#include <algorithm>

#include "fused_head_common.cuh"
#include "tf32x3.cuh"

namespace {

using namespace fhi;
using namespace tf32x3;

constexpr int kMaxC = 256;       // channels the register accumulators hold
constexpr int kMaxNt = kMaxC / 8;
constexpr int kBins = 64;        // depth bins of a joint's slab
constexpr int kRowVals = 8;      // per (b, j): m + log s, gx, gy, gz, cx, cy, cz, 0
constexpr int kCtaThreads = 256;  // 8 warps
constexpr int kDfRows = 128;     // dfeat: feature rows per CTA, 16 per warp
constexpr int kZc = 32;          // dfeat: bins per Wt chunk
constexpr int kDwRows = 32;      // dW: feature rows per tile

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
  // dv of a logit v (without bias) at bias bz, given tx + tz.
  __device__ float dv(float v, float bz, float txz) const { return ex2((v + bz - lse) * kLog2e) * txz; }
};

// Copies rows [row0, row0 + n) of a (rows_total, C) fp32 matrix into
// shared memory at pitch C + 4, rows past rows_total clamped to its last.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n, int rows_total,
                                          int C, int tid) {
  const int cq = C / 4;
  for (int i = tid; i < n * cq; i += kCtaThreads) {
    const int r = i / cq, q = i % cq;
    cp_async16(dst + r * (C + 4) + q * 4, src + (size_t)min(row0 + r, rows_total - 1) * C + q * 4);
  }
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&d)[M][N][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[m][n][e] = 0.f;
}

// acc (16 x 8*nct, in groups of 8 n tiles) += A (16 x 8, given split) B,
// B's k-slot t at q[0] and slot t + 4 at q[ld], n tile nt at q[8 nt]: the
// products over dv (as_a), whose k-slot t is row or bin 2t. Each group's
// B tiles are split, then its 3xTF32 passes run.
template <int G>
__device__ __forceinline__ void mma3_b_rows(float (&acc)[G][1][8][4], const uint32_t (&ah)[1][4],
                                            const uint32_t (&al)[1][4], const float* q, int ld, int nct) {
#pragma unroll
  for (int grp = 0; grp < G; ++grp) {
    if (grp * 8 < nct) {
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* p = q + (grp * 8 + nt) * 8;
        if (grp * 8 + nt < nct) split_b(p[0], p[ld], bh[nt], bl[nt]);
      }
      mma3(acc[grp], ah, al, bh, bl, nct - grp * 8);
    }
  }
}

__host__ __device__ inline size_t dfeat_smem(int C) {
  return sizeof(float) * (size_t)(kDfRows + 2 * kZc) * (C + 4);
}

__global__ void __launch_bounds__(kCtaThreads, 1)
    dfeat_kernel(const float* __restrict__ feat, const float* __restrict__ wt,
                 const float* __restrict__ bias, const float* __restrict__ rows,
                 float* __restrict__ dfeat, int hw, int width, int C, int J, int D) {
  extern __shared__ __align__(16) float smem[];
  const int ld = C + 4;
  float* f_s = smem;                // [kDfRows][ld]
  float* ring = f_s + kDfRows * ld;  // [2][kZc][ld]
  const int b = blockIdx.y, row0 = blockIdx.x * kDfRows, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nq = (D + kZc - 1) / kZc, nchunks = J * nq, nct = C / 8;
  const float* fb = feat + (size_t)b * hw * C;

  // Chunk n: bins [32 (n % nq), + 32) of joint n / nq.
  auto load = [&](int n) {
    load_rows(ring + (n & 1) * kZc * ld, wt, (n / nq) * D + (n % nq) * kZc, kZc, J * D, C, tid);
  };
  load_rows(f_s, fb, row0, kDfRows, hw, C, tid);
  load(0);
  cp_async_commit();

  const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;
  const bool ok_lo = r_lo < hw, ok_hi = r_hi < hw;
  const float* fw = f_s + warp * 16 * ld;
  const float* rows_b = rows + (size_t)b * J * kRowVals;

  float dacc[kMaxNt / 8][1][8][4];  // 8 n tiles (64 channels) a group
#pragma unroll
  for (int q = 0; q < kMaxNt / 8; ++q)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[q][0][nt][e] = 0.f;

  for (int n = 0; n < nchunks; ++n) {
    if (n + 1 < nchunks) {
      load(n + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk n (and the rows) are in
    const int j = n / nq, q0 = (n % nq) * kZc;
    const int nzt = (min(kZc, D - q0) + 7) / 8;  // n tiles holding bins < D
    const float* ws = ring + (n & 1) * kZc * ld;

    // S = F W_j (16 rows x 32 bins).
    float s[1][4][4];
    zero(s);
    for (int ks = 0; ks < C / 8; ++ks) {
      const float* p = fw + g * ld + ks * 8 + t;
      const float af[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
      uint32_t ah[1][4], al[1][4], bh[4][2], bl[4][2];
      split(af, ah[0], al[0]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* q = ws + (nt * 8 + g) * ld + ks * 8 + t;
        if (nt < nzt) split_b(q[0], q[4], bh[nt], bl[nt]);
      }
      mma3(s, ah, al, bh, bl, nzt);
    }

    // dv in place; 0 past D and past HW.
    const Row r(rows_b + j * kRowVals);
    const float tx_lo = r.tx(r_lo, width), tx_hi = r.tx(r_hi, width);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int z = q0 + nt * 8 + 2 * t + q;
        const bool in = nt < nzt && z < D;
        const float bz = in ? __ldg(bias + j * D + z) : 0.f;
        const float tz = r.gz * ((float)z - r.cz);
        float* sv = s[0][nt];
        sv[q] = in && ok_lo ? r.dv(sv[q], bz, tx_lo + tz) : 0.f;
        sv[q + 2] = in && ok_hi ? r.dv(sv[q + 2], bz, tx_hi + tz) : 0.f;
      }
    }

    // dfeat (16 rows x C) += dv W_j^T, k relabelled: slot t is bin 2t.
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks < nzt) {
        float af[4];
        as_a(s[0][ks], af);
        uint32_t ah[1][4], al[1][4];
        split(af, ah[0], al[0]);
        mma3_b_rows(dacc, ah, al, ws + (ks * 8 + 2 * t) * ld + g, ld, nct);
      }
    }
    __syncthreads();  // every warp is done with chunk n's slot
  }

  float* out = dfeat + (size_t)b * hw * C;
#pragma unroll
  for (int q = 0; q < kMaxNt / 8; ++q) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* dd = dacc[q][0][nt];
      const int c = (q * 8 + nt) * 8 + 2 * t;
      if (q * 8 + nt < nct) {
        if (ok_lo) *reinterpret_cast<float2*>(out + (size_t)r_lo * C + c) = make_float2(dd[0], dd[1]);
        if (ok_hi) *reinterpret_cast<float2*>(out + (size_t)r_hi * C + c) = make_float2(dd[2], dd[3]);
      }
    }
  }
}

__host__ __device__ inline size_t dw_smem(int C) {
  return sizeof(float) * (size_t)(kBins + 4 * kDwRows) * (C + 4);
}

// One CTA per (joint j = blockIdx.x, range = blockIdx.y of the B * ntiles
// 32-row feature tiles, sample-major). Writes partials 2 range and
// 2 range + 1 (one per warp group) of dW_j (C x 64) and db_j (64).
__global__ void __launch_bounds__(kCtaThreads, 1)
    dw_kernel(const float* __restrict__ feat, const float* __restrict__ wt, const float* __restrict__ bias,
              const float* __restrict__ rows, float* __restrict__ part, float* __restrict__ dbpart,
              int batch, int hw, int width, int C, int J, int D) {
  extern __shared__ __align__(16) float smem[];
  const int ld = C + 4;
  float* w_s = smem;               // [kBins][ld]
  float* ring = w_s + kBins * ld;  // [2 stages][2 groups][kDwRows][ld]
  const int j = blockIdx.x, range = blockIdx.y, ranges = gridDim.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, z0 = (warp & 3) * 16, nct = C / 8;
  const int ntiles = (hw + kDwRows - 1) / kDwRows;
  const long long total = (long long)batch * ntiles;
  const int i0 = (int)(total * range / ranges), n = (int)(total * (range + 1) / ranges) - i0;
  const int npairs = (n + 1) / 2;

  // Tile i of the range: rows [row0, + 32) of sample bb.
  auto load = [&](int pi) {
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * pi + h;
      if (i < n) {
        const int tt = i0 + i, bb = tt / ntiles;
        load_rows(ring + ((pi & 1) * 2 + h) * kDwRows * ld, feat + (size_t)bb * hw * C,
                  (tt % ntiles) * kDwRows, kDwRows, hw, C, tid);
      }
    }
  };
  load_rows(w_s, wt, j * D, kBins, J * D, C, tid);
  load(0);
  cp_async_commit();

  const bool active = z0 < D;  // the warp's 16 bins start before D
  const int z_lo = z0 + g, z_hi = z_lo + 8;
  const float bz_lo = z_lo < D ? __ldg(bias + j * D + z_lo) : 0.f;
  const float bz_hi = z_hi < D ? __ldg(bias + j * D + z_hi) : 0.f;
  float wacc[kMaxNt / 8][1][8][4];  // 8 n tiles (64 channels) a group
#pragma unroll
  for (int q = 0; q < kMaxNt / 8; ++q)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) wacc[q][0][nt][e] = 0.f;
  float db_lo = 0.f, db_hi = 0.f;

  for (int pi = 0; pi < npairs; ++pi) {
    if (pi + 1 < npairs) {
      load(pi + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // pair pi (and Wt_j) are in
    const int i = 2 * pi + grp;
    if (active && i < n) {
      const int tt = i0 + i, bb = tt / ntiles, row0 = (tt % ntiles) * kDwRows;
      const float* fs = ring + ((pi & 1) * 2 + grp) * kDwRows * ld;

      // S^T = W_j^T F^T (16 bins x 32 rows).
      float s[1][4][4];
      zero(s);
      for (int ks = 0; ks < C / 8; ++ks) {
        const float* p = w_s + z_lo * ld + ks * 8 + t;
        const float af[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
        uint32_t ah[1][4], al[1][4], bh[4][2], bl[4][2];
        split(af, ah[0], al[0]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* q = fs + (nt * 8 + g) * ld + ks * 8 + t;
          split_b(q[0], q[4], bh[nt], bl[nt]);
        }
        mma3(s, ah, al, bh, bl, 4);
      }

      // dv^T in place; db's sums.
      const Row r(rows + ((size_t)bb * J + j) * kRowVals);
      const float tz_lo = r.gz * ((float)z_lo - r.cz), tz_hi = r.gz * ((float)z_hi - r.cz);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int row = row0 + nt * 8 + 2 * t + q;
          const float tx = r.tx(row, width);
          const bool ok = row < hw;
          float* sv = s[0][nt];
          sv[q] = ok && z_lo < D ? r.dv(sv[q], bz_lo, tx + tz_lo) : 0.f;
          sv[q + 2] = ok && z_hi < D ? r.dv(sv[q + 2], bz_hi, tx + tz_hi) : 0.f;
          db_lo += sv[q];
          db_hi += sv[q + 2];
        }
      }

      // dW_j^T (16 bins x C) += dv^T F, k relabelled: slot t is row 2t.
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        float af[4];
        as_a(s[0][ks], af);
        uint32_t ah[1][4], al[1][4];
        split(af, ah[0], al[0]);
        mma3_b_rows(wacc, ah, al, fs + (ks * 8 + 2 * t) * ld + g, ld, nct);
      }
    }
    __syncthreads();  // every warp is done with pair pi's slots
  }

  if (!active) return;
  // dW_j partial [c][z]: bin z_lo / z_hi, channel nt*8 + 2t (+1).
  const int p = 2 * range + grp;
  float* out = part + ((size_t)p * J + j) * C * kBins;
#pragma unroll
  for (int q = 0; q < kMaxNt / 8; ++q) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* w = wacc[q][0][nt];
      const int c = (q * 8 + nt) * 8 + 2 * t;
      if (q * 8 + nt < nct) {
        out[(size_t)c * kBins + z_lo] = w[0];
        out[(size_t)(c + 1) * kBins + z_lo] = w[1];
        out[(size_t)c * kBins + z_hi] = w[2];
        out[(size_t)(c + 1) * kBins + z_hi] = w[3];
      }
    }
  }
  // db_j partial: the sums of the warp's 4 lanes of a bin, in order.
  db_lo += __shfl_xor_sync(0xffffffffu, db_lo, 1);
  db_lo += __shfl_xor_sync(0xffffffffu, db_lo, 2);
  db_hi += __shfl_xor_sync(0xffffffffu, db_hi, 1);
  db_hi += __shfl_xor_sync(0xffffffffu, db_hi, 2);
  if (t == 0) {
    dbpart[((size_t)p * J + j) * kBins + z_lo] = db_lo;
    dbpart[((size_t)p * J + j) * kBins + z_hi] = db_hi;
  }
}

// dW[c, j*D + z] = sum_p part[p, j, c, z] and db[j*D + z] = sum_p dbpart[p, j, z],
// in partial order.
__global__ void reduce_kernel(const float* __restrict__ part, const float* __restrict__ dbpart,
                              float* __restrict__ dw, float* __restrict__ db, int parts, int C, int J, int D) {
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
      dw[(size_t)c * J * D + j * D + z] = s;
    }
  }
  if (i < (size_t)J * kBins) {
    const int z = (int)(i % kBins), j = (int)(i / kBins);
    if (z < D) {
      float s = 0.f;
      for (int p = 0; p < parts; ++p) s += dbpart[(size_t)p * J * kBins + i];
      db[j * D + z] = s;
    }
  }
}

int sm_count() {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

}  // namespace

extern "C" {

// Largest shared memory one CTA of the backward needs for C channels.
size_t ihpr_fused_head_integral_bwd_f32_smem(int C) { return std::max(dfeat_smem(C), dw_smem(C)); }

// Channels the kernels' register accumulators hold.
int ihpr_fused_head_integral_bwd_f32_max_channels() { return kMaxC; }

// Partials of dW / db the backward should write for this shape on the
// current device: two (one per warp group) per feature-tile range of the
// dW kernel, with as many (joint, range) CTAs as the card has SMs (one
// wave), at least one range and at most one tile per range.
int ihpr_fused_head_integral_bwd_f32_partials(int batch, int hw, int J) {
  const long long tiles = (long long)batch * ((hw + kDwRows - 1) / kDwRows);
  return 2 * (int)std::max(1LL, std::min<long long>(sm_count() / J, tiles));
}

// feat (batch, hw, C), w (C, J*D), bias (J*D,): contiguous fp32, feat
// 16-byte aligned, C a multiple of 32 up to 256. rows (batch, J, 8) fp32:
// m + log s, gx, gy, gz, cx, cy, cz, 0. Scratch: wt (J*D, C), part (parts,
// J, C, 64) and dbpart (parts, J, 64) fp32, parts even and positive (as
// ihpr_fused_head_integral_bwd_f32_partials gives it). Writes dfeat (batch,
// hw, C), dw (C, J*D) and db (J*D,) in fp32. Returns 0 or the first
// cudaError_t of the four launches.
int ihpr_fused_head_integral_bwd_f32(const void* feat, const void* w, const void* bias, const float* rows,
                                     void* wt, float* part, float* dbpart, void* dfeat, void* dw, void* db,
                                     int batch, int hw, int width, int C, int J, int D, int parts,
                                     void* stream) {
  if (parts < 2 || parts % 2 || C % kZc || C > kMaxC || D < 1 || D > kBins) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int jd = J * D;
  const auto* f = static_cast<const float*>(feat);
  const auto* wt_c = static_cast<const float*>(wt);
  const auto* bias_c = static_cast<const float*>(bias);
  cudaError_t err = transpose(static_cast<const float*>(w), static_cast<float*>(wt), C, jd, st);
  if (err != cudaSuccess) return (int)err;

  const size_t smem_a = dfeat_smem(C);
  err = cudaFuncSetAttribute(dfeat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  dfeat_kernel<<<dim3((hw + kDfRows - 1) / kDfRows, batch), kCtaThreads, smem_a, st>>>(
      f, wt_c, bias_c, rows, static_cast<float*>(dfeat), hw, width, C, J, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_b = dw_smem(C);
  err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  dw_kernel<<<dim3(J, parts / 2), kCtaThreads, smem_b, st>>>(f, wt_c, bias_c, rows, part, dbpart, batch, hw,
                                                             width, C, J, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t n = (size_t)J * C * kBins;
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, dbpart, static_cast<float*>(dw),
                                                              static_cast<float*>(db), parts, C, J, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
