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
//
// Design. One CTA per (joint, sample); blockIdx.x = joint, so the J CTAs of
// one sample run close together and share feat[b] in L2. The CTA keeps
// W[:, j*D : (j+1)*D] transposed in shared memory (D <= 64 columns, zero
// padded to 64) and streams feat[b] in tiles of 64 rows with cp.async,
// double buffered. Each of the 4 warps multiplies 16 rows by the 64
// columns: bf16 operands on the tensor cores (ldmatrix + mma.sync
// m16n8k16, fp32 accumulate, the next k-step's fragments loaded before
// this one's mma); fp32 operands as plain fp32 FMAs in the same register
// layout, so fp32 means fp32 (no TF32). Every thread keeps an online
// softmax state (max, sum e, sum e*x, sum e*y, sum e*z) over the logits it
// holds, in base 2 (ex2.approx). A shuffle + shared-memory merge of the
// 128 states ends the CTA. No state crosses CTAs, so there is no second
// pass and no atomics.
//
// What differs from the TPU kernel. The TPU walks a sample's row chunks in
// grid order and carries the running max and sums between grid steps; GPU
// CTAs run in no order, so the whole sample's rows are a loop inside one
// CTA. The TPU used one max shared by all joints of a sample; here the max
// is per joint, which is exact and cannot underflow a joint whose logits sit
// far below another's. The TPU needed J*D 128-aligned (joints padded with
// -1e30 bias); this kernel takes any J, any D <= 64 and any HW, masking
// the ragged columns (a -inf bias) and rows (last tile) itself. C must be a
// multiple of 16.
//
// What bounds it on an H100. The op is 2*B*HW*C*J*D flops (155 GFLOP at the
// flagship 64 x 4096 x 256 x 1152) against B*HW*C*2 bytes of features
// (134 MB bf16): compute bound, so the bf16 path must use the tensor cores.
// Beside the matmul, three costs remain and none is hidden completely: the
// epilogue (one ex2 per logit, B*HW*J*D of them, on the SFU), re-reading
// feat[b] once per joint CTA (J * 134 MB from L2, which holds a sample's
// 2 MB because its CTAs are adjacent in launch order), and shared-memory
// fragment traffic, since each warp reloads W's fragments for every
// 16-row slab. Fewer re-reads (several joints per CTA) and wgmma/TMA are
// the next steps. The tile loader and fragment code live in
// fused_head_common.cuh, shared with the backward (K2).

#include "fused_head_common.cuh"

namespace {

using namespace fhi;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_head_integral_fwd_kernel(const T* __restrict__ feat, const T* __restrict__ w,
                                   const T* __restrict__ bias, float* __restrict__ coords,
                                   float* __restrict__ m_out, float* __restrict__ s_out, int hw,
                                   int width, int C, int J, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = C + Elem<T>::kPad;
  T* wt = reinterpret_cast<T*>(smem_raw);                                // [kCols][P]
  T* tiles = wt + kCols * P;                                             // [2][kRows][P]
  float* bias_s = reinterpret_cast<float*>(tiles + 2 * kRows * P);       // [kCols]
  Stats* red = reinterpret_cast<Stats*>(bias_s + kCols);                 // [kWarps]

  const int j = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const T* feat_b = feat + (size_t)b * hw * C;
  const int jd = J * D;
  const int ntiles = (hw + kRows - 1) / kRows;

  const TileWalk walk(C, sizeof(T));
  load_tile(tiles, feat_b, 0, hw, C, P, walk);
  cp_async_commit();
  // W[:, j*D : j*D + D] -> wt[n][k], zero for n >= D (coalesced over n).
#pragma unroll 4
  for (int i = tid; i < kCols * C; i += kThreads) {
    const int k = i / kCols, n = i - k * kCols;
    wt[n * P + k] = n < D ? w[(size_t)k * jd + j * D + n] : Elem<T>::zero();
  }
  // Bias in base-2 units; -inf for columns past D masks their logits.
  if (tid < kCols) bias_s[tid] = tid < D ? Elem<T>::to_float(bias[j * D + tid]) * kLog2e : neg_inf();

  Stats st = {neg_inf(), 0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      load_tile(tiles + ((t + 1) & 1) * kRows * P, feat_b, (t + 1) * kRows, hw, C, P, walk);
    cp_async_commit();
    cp_async_wait_1();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();

    float acc[kCols / 8][4];
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    tile_matmul(acc, tiles + (t & 1) * kRows * P + warp * 16 * P, wt, C, P, D, lane);

    // u = v * log2(e), in place of acc; rows past hw (last tile only) -> -inf.
    const int r_lo = t * kRows + warp * 16 + g, r_hi = r_lo + 8;
    const bool ragged = (t + 1) * kRows > hw;
    float tmax = neg_inf();
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float u = fmaf(acc[nt][e], kLog2e, bias_s[nt * 8 + 2 * tig + (e & 1)]);
        if (ragged && (e < 2 ? r_lo : r_hi) >= hw) u = neg_inf();
        acc[nt][e] = u;
        tmax = fmaxf(tmax, u);
      }
    }
    if (tmax != neg_inf()) {
      const float m_new = fmaxf(st.m, tmax);
      const float c = ex2(st.m - m_new);
      st.s *= c, st.sx *= c, st.sy *= c, st.sz *= c;
      st.m = m_new;
      // x and y are per row: sum each row's probabilities first.
      float p_lo = 0.f, p_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(acc[nt][e] - m_new);  // 0 for masked entries
          (e < 2 ? p_lo : p_hi) += p;
          st.sz = fmaf(p, (float)(nt * 8 + 2 * tig + (e & 1)), st.sz);
        }
      }
      const float x_lo = (float)(r_lo % width), y_lo = (float)(r_lo / width);
      const float x_hi = (float)(r_hi % width), y_hi = (float)(r_hi / width);
      st.s += p_lo + p_hi;
      st.sx = fmaf(p_lo, x_lo, fmaf(p_hi, x_hi, st.sx));
      st.sy = fmaf(p_lo, y_lo, fmaf(p_hi, y_hi, st.sy));
    }
    __syncthreads();  // buffer t & 1 is refilled at t + 2
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
    for (int i = 1; i < kWarps; ++i) merge(st, red[i]);
    const int o = b * J + j;
    const float inv = 1.f / st.s;
    coords[o * 3 + 0] = st.sx * inv;
    coords[o * 3 + 1] = st.sy * inv;
    coords[o * 3 + 2] = st.sz * inv;
    m_out[o] = st.m * kLn2;
    s_out[o] = st.s;
  }
}

template <typename T>
size_t smem_bytes(int C) {
  const size_t P = C + Elem<T>::kPad;
  return (kCols + 2 * kRows) * P * sizeof(T) + kCols * sizeof(float) + kWarps * sizeof(Stats);
}

template <typename T>
int launch(const void* feat, const void* w, const void* bias, float* coords, float* m, float* s,
           int batch, int hw, int width, int C, int J, int D, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(C);
  cudaError_t err = cudaFuncSetAttribute(fused_head_integral_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_head_integral_fwd_kernel<T><<<dim3(J, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(w), static_cast<const T*>(bias), coords,
      m, s, hw, width, C, J, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for C channels (is_bf16: bf16, else fp32).
size_t ihpr_fused_head_integral_fwd_smem(int C, int is_bf16) {
  return is_bf16 ? smem_bytes<__nv_bfloat16>(C) : smem_bytes<float>(C);
}

// feat (batch, hw, C), w (C, J*D), bias (J*D,): contiguous, all bf16 or all
// fp32. Writes coords (batch, J, 3), m and s (batch, J), fp32. Returns the
// cudaError_t of the launch (0 on success).
int ihpr_fused_head_integral_fwd(const void* feat, const void* w, const void* bias,
                                 float* coords, float* m, float* s, int batch, int hw, int width,
                                 int C, int J, int D, int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(feat, w, bias, coords, m, s, batch, hw, width, C, J, D, st)
                 : launch<float>(feat, w, bias, coords, m, s, batch, hw, width, C, J, D, st);
}

}  // extern "C"
