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
//     dvc   = dv rounded to W's dtype
//     dfeat = dvc W^T          (B, HW, C), fp32 accumulate, feat's dtype
//     dW    = sum_b feat^T dvc (C, J*D),   fp32 accumulate, W's dtype
//     db    = sum_{b,r} dv     (J*D,),     fp32, bias's dtype
// the rounding of ops/fused_head_integral.py:plain_bwd (and of the TPU
// kernel). The logits are recomputed exactly as K1 forms them (same tile
// matmul) and never written.
//
// Design: four matmuls where the TPU kernel has three. dfeat contracts
// over all J*D columns and dW over all rows of all samples, so no one
// layout of CTAs owns both sums:
//   1. transpose_kernel: W (C, J*D) -> Wt (J*D, C) scratch, so a joint's
//      columns are rows that cp.async copies in 16-byte chunks.
//   2. dfeat_kernel, one CTA per (64-row tile, sample): the feature tile
//      stays in shared memory while the CTA walks every joint (Wt_j double
//      buffered): recompute the 64x64 logits, form dv, stage it in shared
//      memory in W's dtype, and add dv Wt_j into a 64 x C fp32 accumulator
//      held in registers (C <= 256: 128 per thread). Written once.
//   3. dw_partial_kernel, one CTA per (joint, sample), laid out like K1:
//      Wt_j stays in shared memory while the CTA streams the sample's
//      feature tiles (cp.async, double buffered): recompute the logits,
//      form dv, and add feat_tile^T dv into a C x 64 fp32 accumulator in
//      registers; sum the fp32 dv per column for db. One partial per
//      (sample, joint): B*J*C*64 fp32 (151 MB at B=128, J=18, C=256, from
//      the shapes).
//   4. reduce_kernel: dW and db as the sums of the partials over samples,
//      in sample order, rounded once.
// Every sum has a fixed order, so dW, db and dfeat are bitwise the same
// from run to run; nothing is atomic. The TPU kernel instead carried dW/db
// in VMEM scratch across a grid that runs in order, which on a GPU grid
// would race.
//
// Tensor cores: bf16 operands go through ldmatrix + mma.sync m16n8k16 with
// fp32 accumulation. The three products need three operand layouts from the
// same shared-memory tiles: feat W_j (K1's tile_matmul), dv Wt_j (B read
// with ldmatrix.trans from Wt_j) and feat^T dv (both operands read with
// ldmatrix.trans, since the contraction runs over the row axis). fp32
// operands take plain FMAs in the same accumulator layouts (no TF32).
//
// Shapes: any J, D <= 64 and any HW, as K1; C a multiple of 16 and at most
// 256 (the register accumulators). Masked columns (z >= D) get a -inf logit
// so p = 0 and dv = 0 exactly; rows past HW in the last tile get dv = 0;
// neither adds anything to dfeat, dW or db.
//
// What bounds it on an H100. 4 * 2*B*HW*C*J*D flops (1.24 TFLOP at the
// flagship 128 x 4096 x 256 x 1152, from the shapes): compute bound on the
// tensor cores in bf16. Beside that: ex2 per logit twice (once per pass), Wt_j re-read from
// L2 by every dfeat CTA for every joint (18 x 32 KB), the partials' 151 MB
// written and read once, and the mma.sync operands, which this simple
// version loads from shared memory without prefetching. wgmma/TMA, a
// layout that does the three products once, and fewer Wt_j reloads are the
// next steps.

#include "fused_head_common.cuh"

namespace {

using namespace fhi;

constexpr int kMaxC = 256;             // channels the register accumulators hold
constexpr int kRowVals = 8;            // per (b, j): m + log s, gx, gy, gz, cx, cy, cz, 0

// Per-column constants of joint j for depth bin z (one thread per z):
// cb = bias - (m + log s), -inf past D (so p = 0 there); tz = gz (z - cz).
template <typename T>
__device__ __forceinline__ void joint_consts(float* cb, float* tz, const T* bias,
                                             const float* rows_b, int j, int D, int z) {
  const float* r = rows_b + j * kRowVals;
  cb[z] = z < D ? Elem<T>::to_float(bias[j * D + z]) - r[0] : neg_inf();
  tz[z] = z < D ? r[3] * ((float)z - r[6]) : 0.f;
}

// Turns this warp's logits accumulator (v - bias) into fp32 dv in place and
// stores dv in T at dv_rows (this warp's 16 rows, pitch PD). Rows past HW
// (ok_* false) get dv = 0.
template <typename T>
__device__ __forceinline__ void form_dv(float (&acc)[kCols / 8][4], T* dv_rows, int PD,
                                        const float* cb, const float* tz, float tx_lo,
                                        float tx_hi, bool ok_lo, bool ok_hi, int g, int tig) {
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt) {
    const int c = nt * 8 + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = h ? ok_hi : ok_lo;
      const float tx = h ? tx_hi : tx_lo;
      const float d0 = ok ? ex2((acc[nt][2 * h] + cb[c]) * kLog2e) * (tx + tz[c]) : 0.f;
      const float d1 = ok ? ex2((acc[nt][2 * h + 1] + cb[c + 1]) * kLog2e) * (tx + tz[c + 1]) : 0.f;
      acc[nt][2 * h] = d0;
      acc[nt][2 * h + 1] = d1;
      Elem<T>::store2(dv_rows + (g + 8 * h) * PD + c, d0, d1);
    }
  }
}

// gx (x - cx) + gy (y - cy) for feature row r of a width-wide map.
__device__ __forceinline__ float row_term(const float* r, int row, int width) {
  return r[1] * ((float)(row % width) - r[4]) + r[2] * ((float)(row / width) - r[5]);
}

template <typename T>
__global__ void transpose_kernel(const T* __restrict__ w, T* __restrict__ wt, int C, int JD) {
  __shared__ __align__(4) unsigned char raw[32 * 33 * sizeof(T)];
  T* tile = reinterpret_cast<T*>(raw);  // [32][33]
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    if (k < C && n < JD) tile[i * 33 + threadIdx.x] = w[(size_t)k * JD + n];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (n < JD && k < C) wt[(size_t)n * C + k] = tile[threadIdx.x * 33 + i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dfeat_kernel(const T* __restrict__ feat, const T* __restrict__ wt_g,
                 const T* __restrict__ bias, const float* __restrict__ rows,
                 T* __restrict__ dfeat, int hw, int width, int C, int J, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = C + Elem<T>::kPad, PD = kCols + Elem<T>::kPad;
  T* feat_s = reinterpret_cast<T*>(smem_raw);                  // [kRows][P]
  T* wt_s = feat_s + kRows * P;                                // [2][kCols][P]
  T* dv_s = wt_s + 2 * kCols * P;                              // [kRows][PD]
  float* cb_s = reinterpret_cast<float*>(dv_s + kRows * PD);   // [2][kCols]
  float* tz_s = cb_s + 2 * kCols;                              // [2][kCols]

  const int b = blockIdx.y, row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const T* feat_b = feat + (size_t)b * hw * C;
  const float* rows_b = rows + (size_t)b * J * kRowVals;

  const TileWalk walk(C, sizeof(T));
  load_tile(feat_s, feat_b, row0, hw, C, P, walk);
  load_tile(wt_s, wt_g, 0, D, C, P, walk);
  cp_async_commit();
  if (tid < kCols) joint_consts(cb_s, tz_s, bias, rows_b, 0, D, tid);

  const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;
  const bool ok_lo = r_lo < hw, ok_hi = r_hi < hw;
  const int kz = (D + 15) & ~15;
  float dacc[kMaxC / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxC / 8; ++nt) dacc[nt][0] = dacc[nt][1] = dacc[nt][2] = dacc[nt][3] = 0.f;

  for (int j = 0; j < J; ++j) {
    cp_async_wait_all();  // Wt_j has landed
    __syncthreads();      // and every warp is done with joint j - 1's buffers
    const int cur = j & 1, nxt = cur ^ 1;
    if (j + 1 < J) {
      load_tile(wt_s + nxt * kCols * P, wt_g, (j + 1) * D, (j + 2) * D, C, P, walk);
      if (tid < kCols) joint_consts(cb_s + nxt * kCols, tz_s + nxt * kCols, bias, rows_b, j + 1, D, tid);
    }
    cp_async_commit();
    const T* wt = wt_s + cur * kCols * P;

    float acc[kCols / 8][4];
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    tile_matmul(acc, feat_s + warp * 16 * P, wt, C, P, D, lane);
    const float* r = rows_b + j * kRowVals;
    T* dv_rows = dv_s + warp * 16 * PD;
    form_dv(acc, dv_rows, PD, cb_s + cur * kCols, tz_s + cur * kCols, row_term(r, r_lo, width),
            row_term(r, r_hi, width), ok_lo, ok_hi, g, tig);
    __syncwarp();  // the warp reads back only its own dv rows
    warp_mma<kMaxC / 8, false, true>(dacc, dv_rows, PD, wt, P, kz, C, lane);
  }

  T* out = dfeat + (size_t)b * hw * C;
#pragma unroll
  for (int nt = 0; nt < kMaxC / 8; ++nt) {
    if (nt * 8 < C) {
      const int c = nt * 8 + 2 * tig;
      if (ok_lo) Elem<T>::store2(out + (size_t)r_lo * C + c, dacc[nt][0], dacc[nt][1]);
      if (ok_hi) Elem<T>::store2(out + (size_t)r_hi * C + c, dacc[nt][2], dacc[nt][3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dw_partial_kernel(const T* __restrict__ feat, const T* __restrict__ wt_g,
                      const T* __restrict__ bias, const float* __restrict__ rows,
                      float* __restrict__ part, float* __restrict__ dbpart, int hw, int width,
                      int C, int J, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = C + Elem<T>::kPad, PD = kCols + Elem<T>::kPad;
  T* wt_s = reinterpret_cast<T*>(smem_raw);                    // [kCols][P]
  T* tiles = wt_s + kCols * P;                                 // [2][kRows][P]
  T* dv_s = tiles + 2 * kRows * P;                             // [kRows][PD]
  float* cb_s = reinterpret_cast<float*>(dv_s + kRows * PD);   // [kCols]
  float* tz_s = cb_s + kCols;                                  // [kCols]
  float* red = tz_s + kCols;                                   // [kWarps][kCols]

  const int j = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const T* feat_b = feat + (size_t)b * hw * C;
  const float* rows_b = rows + (size_t)b * J * kRowVals;
  const float* r = rows_b + j * kRowVals;
  const int ntiles = (hw + kRows - 1) / kRows;

  const TileWalk walk(C, sizeof(T));
  load_tile(tiles, feat_b, 0, hw, C, P, walk);
  load_tile(wt_s, wt_g, j * D, j * D + D, C, P, walk);
  cp_async_commit();
  if (tid < kCols) joint_consts(cb_s, tz_s, bias, rows_b, j, D, tid);

  // This warp's rows of dW_j: m-tiles (16 channels) warp, warp + 4, ...
  constexpr int kMt = kMaxC / 16 / kWarps;
  float dwacc[kMt][kCols / 8][4];
  float dbacc[kCols / 8][2];
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt) {
    dbacc[nt][0] = dbacc[nt][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < kMt; ++mi)
      dwacc[mi][nt][0] = dwacc[mi][nt][1] = dwacc[mi][nt][2] = dwacc[mi][nt][3] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      load_tile(tiles + ((t + 1) & 1) * kRows * P, feat_b, (t + 1) * kRows, hw, C, P, walk);
    cp_async_commit();
    cp_async_wait_1();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();
    const T* tile = tiles + (t & 1) * kRows * P;

    float acc[kCols / 8][4];
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    tile_matmul(acc, tile + warp * 16 * P, wt_s, C, P, D, lane);
    const int r_lo = t * kRows + warp * 16 + g, r_hi = r_lo + 8;
    form_dv(acc, dv_s + warp * 16 * PD, PD, cb_s, tz_s, row_term(r, r_lo, width),
            row_term(r, r_hi, width), r_lo < hw, r_hi < hw, g, tig);
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      dbacc[nt][0] += acc[nt][0] + acc[nt][2];
      dbacc[nt][1] += acc[nt][1] + acc[nt][3];
    }
    __syncthreads();  // every warp's dv rows are in dv_s

    // dW_j[c, z] += sum over the tile's rows of feat[r, c] * dv[r, z].
#pragma unroll
    for (int mi = 0; mi < kMt; ++mi) {
      const int mt = warp + kWarps * mi;
      if (mt * 16 < C)
        warp_mma<kCols / 8, true, true>(dwacc[mi], tile + mt * 16, P, dv_s, PD, kRows, D, lane);
    }
    __syncthreads();  // tile buffer t & 1 is refilled at t + 2, dv_s at t + 1
  }

  float* out = part + ((size_t)b * J + j) * C * kCols;
#pragma unroll
  for (int mi = 0; mi < kMt; ++mi) {
    const int mt = warp + kWarps * mi;
    if (mt * 16 < C) {
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        const int c = mt * 16 + g, z = nt * 8 + 2 * tig;
        Elem<float>::store2(out + (size_t)c * kCols + z, dwacc[mi][nt][0], dwacc[mi][nt][1]);
        Elem<float>::store2(out + (size_t)(c + 8) * kCols + z, dwacc[mi][nt][2], dwacc[mi][nt][3]);
      }
    }
  }
  // db: sum the column sums over the 8 row groups of the warp, then warps.
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float v = dbacc[nt][q];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[warp * kCols + nt * 8 + 2 * tig + q] = v;
    }
  }
  __syncthreads();
  if (tid < kCols) {
    float s = red[tid];
    for (int w = 1; w < kWarps; ++w) s += red[w * kCols + tid];
    dbpart[((size_t)b * J + j) * kCols + tid] = s;
  }
}

// dW[c, j*D + z] = sum_b part[b, j, c, z] and db[j*D + z] = sum_b dbpart[b, j, z],
// in sample order, rounded once to T.
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ part, const float* __restrict__ dbpart,
                              T* __restrict__ dw, T* __restrict__ db, int batch, int C, int J,
                              int D) {
  const size_t n = (size_t)J * C * kCols;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int z = (int)(i % kCols);
    const size_t jc = i / kCols;
    const int c = (int)(jc % C), j = (int)(jc / C);
    if (z < D) {
      float s = 0.f;
#pragma unroll 8
      for (int bb = 0; bb < batch; ++bb) s += part[(size_t)bb * n + i];
      dw[(size_t)c * J * D + j * D + z] = Elem<T>::from_float(s);
    }
  }
  if (i < (size_t)J * kCols) {
    const int z = (int)(i % kCols), j = (int)(i / kCols);
    if (z < D) {
      float s = 0.f;
      for (int bb = 0; bb < batch; ++bb) s += dbpart[(size_t)bb * J * kCols + i];
      db[j * D + z] = Elem<T>::from_float(s);
    }
  }
}

template <typename T>
size_t dfeat_smem(int C) {
  const size_t P = C + Elem<T>::kPad, PD = kCols + Elem<T>::kPad;
  return (kRows * P + 2 * kCols * P + kRows * PD) * sizeof(T) + 4 * kCols * sizeof(float);
}

template <typename T>
size_t dw_smem(int C) {
  const size_t P = C + Elem<T>::kPad, PD = kCols + Elem<T>::kPad;
  return (kCols * P + 2 * kRows * P + kRows * PD) * sizeof(T) +
         (2 + kWarps) * kCols * sizeof(float);
}

template <typename T>
int launch(const void* feat_v, const void* w_v, const void* bias_v, const float* rows,
           void* wt_v, float* part, float* dbpart, void* dfeat_v, void* dw_v, void* db_v,
           int batch, int hw, int width, int C, int J, int D, cudaStream_t stream) {
  const T* feat = static_cast<const T*>(feat_v);
  const T* w = static_cast<const T*>(w_v);
  const T* bias = static_cast<const T*>(bias_v);
  T* wt = static_cast<T*>(wt_v);
  const int jd = J * D;

  transpose_kernel<T><<<dim3((jd + 31) / 32, (C + 31) / 32), dim3(32, 8), 0, stream>>>(w, wt, C, jd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_a = dfeat_smem<T>(C);
  err = cudaFuncSetAttribute(dfeat_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  dfeat_kernel<T><<<dim3((hw + kRows - 1) / kRows, batch), kThreads, smem_a, stream>>>(
      feat, wt, bias, rows, static_cast<T*>(dfeat_v), hw, width, C, J, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_b = dw_smem<T>(C);
  err = cudaFuncSetAttribute(dw_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  dw_partial_kernel<T><<<dim3(J, batch), kThreads, smem_b, stream>>>(
      feat, wt, bias, rows, part, dbpart, hw, width, C, J, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t n = (size_t)J * C * kCols;
  reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, dbpart, static_cast<T*>(dw_v), static_cast<T*>(db_v), batch, C, J, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest shared memory one CTA of the backward needs for C channels.
size_t ihpr_fused_head_integral_bwd_smem(int C, int is_bf16) {
  const size_t a = is_bf16 ? dfeat_smem<__nv_bfloat16>(C) : dfeat_smem<float>(C);
  const size_t b = is_bf16 ? dw_smem<__nv_bfloat16>(C) : dw_smem<float>(C);
  return a > b ? a : b;
}

// Channels the kernels' register accumulators hold.
int ihpr_fused_head_integral_bwd_max_channels() { return kMaxC; }

// feat (batch, hw, C), w (C, J*D), bias (J*D,): contiguous, all bf16 or all
// fp32. rows (batch, J, 8) fp32: m + log s, gx, gy, gz, cx, cy, cz, 0.
// Scratch: wt (J*D, C) in feat's dtype, part (batch, J, C, 64) and dbpart
// (batch, J, 64) fp32. Writes dfeat (batch, hw, C), dw (C, J*D) and db
// (J*D,) in feat's dtype. Returns the first cudaError_t of the four
// launches (0 on success).
int ihpr_fused_head_integral_bwd(const void* feat, const void* w, const void* bias,
                                 const float* rows, void* wt, float* part, float* dbpart,
                                 void* dfeat, void* dw, void* db, int batch, int hw, int width,
                                 int C, int J, int D, int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(feat, w, bias, rows, wt, part, dbpart, dfeat, dw, db,
                                         batch, hw, width, C, J, D, st)
                 : launch<float>(feat, w, bias, rows, wt, part, dbpart, dfeat, dw, db, batch, hw,
                                 width, C, J, D, st);
}

}  // extern "C"
