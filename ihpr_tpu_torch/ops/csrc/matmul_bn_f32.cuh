// K5-fp32 and K6-fp32, the fused 1x1 conv (matmul) + BatchNorm statistics
// forward and backward for fp32 operands on Hopper (sm_90a): the kernels of
// matmul_bn_fwd.cu (replaces ihpr_tpu/ops/matmul_bn.py:_fwd_kernel) and
// matmul_bn_bwd.cu (replaces ihpr_tpu/ops/matmul_bn.py:_bwd_kernel), which
// JAX runs at Precision.HIGHEST for fp32 operands (_dot_precision). bf16
// operands take matmul_bn_hopper.cuh.
//
// What they compute. x (M, K), w (K, N), y and dy (M, N) fp32; ds = [ds1;
// ds2] (2, N) fp32; with the prologue mul, add (K,) fp32 and a =
// relu(x*mul + add) (the multiply and the add rounded apart, as the plain
// version), else a = x.
//   forward (K5-fp32): y = a @ w; s1 = colsum(y), s2 = colsum(y^2), from the
//        fp32 accumulator.
//   backward (K6-fp32): g = (dy + ds1) + (2*y)*ds2 (fp32, the saved y);
//        da = g @ w^T; with the prologue t = da * (x*mul + add > 0), dx =
//        t*mul, dmul = colsum(t*x), dadd = colsum(t); else dx = da;
//        dw = a^T @ g.
// Every product is 3xTF32 on wgmma (tf32x3.cuh's split, fused_head_f32.cuh's
// mma3): d += A_lo B_hi + A_hi B_lo + A_hi B_hi, ~2^-21 relative a product,
// fp32 accumulation. A is split in registers; B comes from shared memory as
// TF32 hi and lo planes, K-major (the only layout TF32 wgmma reads).
//
// What bounds them on an H100. K5-fp32 reads x and w and writes y once,
// 4(MK + KN + MN) bytes, and does 2MKN flops, three TF32 passes each at
// 494.7 TFLOP/s: of a fp32 fused_1x1 step's 16 launches
// (tools/f32_breakdown.py:BN_STEP) 7 are bound by bytes and 9 by
// operations, most by a hair.
// K6-fp32 moves 4(2MK + 2MN) + 8KN bytes and does twice the flops. So the
// passes have to hide under the loads. v1 (FMA kernels in the mma.sync
// layout, 67 TFLOP/s at best; gone since K7/K8-fp32 left them too) could
// not reach half of either bound even at its peak, and wrote gc (M x N)
// once and read it twice.
//
// Design. Persistent CTAs of a producer warp (TMA) and two consumer
// warpgroups, as the bf16 kernels; a ring of 32-deep k-blocks (one 128-byte
// row of fp32 a box row).
//   0. split_w_kernel (once a call): w into TF32 hi / lo planes, K-major for
//      the product that reads them, each 32-long run of the contraction in
//      perm32's order (fused_head_f32.cuh): wt (2, N, Kp) for K5's B (rows
//      n, over K), wn (2, K, Np) for K6's dx (rows c, over N); Kp, Np the
//      contraction rounded up to 32, zeros past it. Plain twin:
//      ops/matmul_bn.py:split_planes.
//   1. fwd_kernel: each CTA one chunk of NW = width(N) columns of N (64 or
//      128) and a strided set of 128-row tiles, a 64-row box per consumer
//      warpgroup. A stage is one k-block: the tile's two x boxes and the
//      chunk's wt hi and lo blocks (NW x 32 each). Each thread reads its two
//      rows' eight values of the k-block (perm32's order makes them two
//      16-byte loads a row), applies the prologue, splits them, and issues
//      4 k-steps x NW / 64 x 3 wgmma m64n64k8 with A from registers; the next
//      k-block is read and split while those run (two register buffers, one
//      group in flight behind the next), and a stage is freed once its group
//      is done. a never reaches memory. Epilogue from the accumulator: y by
//      float2 stores, s1/s2 added per (warp, column) slot in tile order
//      (hopper.cuh: stage_colsums), one partial row per CTA.
//   2. dx_kernel: each CTA KW = width(K) columns of K and a strided set of
//      128-row tiles; a stage is one 32-wide block of N: the tile's y and dy
//      boxes and the wn hi / lo blocks (KW x 32). g is formed in registers
//      from y, dy, ds1, ds2 (two 16-byte loads of each a row), split, and
//      multiplied as in 1.: g never reaches memory. Epilogue: x read at the
//      accumulator's positions, dx = t*mul (or da) by float2 stores,
//      dmul/dadd added per (warp, column) slot, one partial row per CTA.
//   3. dw_kernel: one CTA per (128 channels of K, 64 columns of N, range of
//      64-row tiles). A stage is the tile's x (four 32-channel boxes), y and
//      dy (two boxes each; two stages). All 256 consumer threads form
//      g^T's hi and lo planes in shared memory (64 columns x 64 rows,
//      K-major over rows; two buffers: the next tile's are formed while this
//      tile's products run, one barrier a tile), and each warpgroup multiplies
//      a^T (its 64 channels; A read transposed from the x boxes and split in
//      registers, the prologue recomputed, channel 2g + h of a warp's 16 as
//      m row g + 8h, as K2-fp32's dW) by them: 8 k-steps x 3 m64n64k8. dw
//      stays in registers and is flushed into the CTA's partial (fp32 adds,
//      round to nearest) every kFlush tiles: summed over ~10^5 rows in the
//      tensor cores the accumulators drift past the 1e-4 bar (as K2-fp32's
//      dW did; tests/test_torch_fused_bn.py emulates both schedules).
//   4. cbn::reduce_rows adds the partial rows in a fixed order: s1/s2;
//      dmul/dadd; dw.
// Two backward kernels at every K x N: a one-pass kernel (bf16's, where dw
// fits a warpgroup's registers) would read y and dy once instead of twice
// at the flagship's narrow shapes; it is not written.
// No atomics and a static schedule: results are bitwise the same from run
// to run on one card (the partial counts follow its SM count).
//
// Shapes: any M >= 1; K and N multiples of 8 (TMA's 16-byte pitch). Rows past
// M and columns past K or N read TMA's zeros; a and g are masked to 0 there
// (TMA's zeros would become relu(add) and ds1), and every store and column
// sum leaves them out.

#pragma once

#include "conv_bn_common.cuh"
#include "fused_head_f32.cuh"
#include "hopper.cuh"

namespace mbf {

using namespace hopper;

constexpr int kCtaThreads = 384;  // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kTileRows = 2 * kBox;  // rows of a fwd or dx tile, one box per consumer warpgroup
constexpr int kKb = f32h::kKb;       // fp32 values of a k-block (one 128-byte box row)
constexpr int kBoxF = f32h::kTile;   // bytes of one 64-row x 32-fp32 swizzled box
constexpr int kFlush = 16;           // dw: 64-row tiles summed in the accumulators between flushes
constexpr int kDwStages = 2;
constexpr int kSmemCap = 232448;     // dynamic shared memory one CTA may use (227 KB)

// Columns of N a fwd_kernel CTA covers, or of K a dx_kernel CTA covers: one
// or two m64n64 accumulators a warpgroup.
__host__ __device__ constexpr int width(int cols) { return cols <= 64 ? 64 : 128; }
__host__ __device__ constexpr int round32(int n) { return (n + 31) & ~31; }

// CTAs per chunk of width(cols) columns, each writing one partial row:
// about one CTA per SM, at least one, at most one per 128-row tile.
inline int row_groups(int M, int cols, int sms) {
  const int g = sms / cdiv(cols, width(cols)), tiles = cdiv(M, kTileRows);
  return g < 1 ? 1 : (g < tiles ? g : tiles);
}

// Ranges of 64-row tiles dw_kernel splits the rows into: about one CTA per
// SM, at least one range, at most one tile per range.
inline int dw_ranges(int M, int K, int N, int sms) {
  const int r = sms / (cdiv(K, 2 * kBox) * cdiv(N, kBox)), tiles = cdiv(M, kBox);
  return r < 1 ? 1 : (r < tiles ? r : tiles);
}

// --- 0. the split pre-pass -------------------------------------------------------------

// Each of `taps` matrices w_t = w + t K N (K, N) -> out_t = out + 2 t R Lp,
// (2, R, Lp), Lp = round32(L): out_t[h][r][p] = part h (hi, lo) of src(r,
// l), l = 32 (p / 32) + perm32(p % 32), 0 where l >= L; src(r, l) = w_t[l][r]
// (TRANS: wt, R = N, L = K) or w_t[r][l] (wn, R = K, L = N). K5-fp32 /
// K6-fp32 split one matrix, K7-fp32 / K8-fp32 (conv3_f32.cuh) the nine taps.
__global__ void split_w_kernel(const float* __restrict__ w, uint32_t* __restrict__ out, int K, int N, int trans,
                               int taps) {
  const int R = trans ? N : K, L = trans ? K : N, lp = round32(L);
  const size_t total = (size_t)R * lp;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < taps * total; i += (size_t)gridDim.x * blockDim.x) {
    const size_t tap = i / total, j = i % total;
    const int r = (int)(j / lp), p = (int)(j % lp), l = (p & ~31) + f32h::perm32(p & 31);
    const float* wt = w + tap * K * N;
    uint32_t hi = 0u, lo = 0u;
    if (l < L) tf32x3::split(trans ? __ldg(wt + (size_t)l * N + r) : __ldg(wt + (size_t)r * N + l), hi, lo);
    out[2 * tap * total + j] = hi;
    out[(2 * tap + 1) * total + j] = lo;
  }
}

inline cudaError_t split_w(const float* w, float* planes, int K, int N, int trans, cudaStream_t st, int taps = 1) {
  const size_t total = (size_t)taps * (trans ? N : K) * round32(trans ? K : N);
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  split_w_kernel<<<blocks, 256, 0, st>>>(w, reinterpret_cast<uint32_t*>(planes), K, N, trans, taps);
  return cudaGetLastError();
}

// --- shared pieces -----------------------------------------------------------------------

// Rows 16 wq + g and + 8 of a swizzled box, values 8t ... 8t + 7 of the
// k-block (two 16-byte loads a row): v[h][e].
__device__ __forceinline__ void load_rows(const unsigned char* box, int wq, int g, int t, float (&v)[2][8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wq * 16 + g + 8 * h;
    const unsigned char* row = box + r * 128;
    const float4 a = *reinterpret_cast<const float4*>(row + (((2 * t) ^ (r & 7)) << 4));
    const float4 b = *reinterpret_cast<const float4*>(row + (((2 * t + 1) ^ (r & 7)) << 4));
    v[h][0] = a.x, v[h][1] = a.y, v[h][2] = a.z, v[h][3] = a.w;
    v[h][4] = b.x, v[h][5] = b.y, v[h][6] = b.z, v[h][7] = b.w;
  }
}

// The four k-steps' A fragments of load_rows' values, split: k-step s
// takes values 2s and 2s + 1 of both rows (perm32's order, which the
// planes follow).
__device__ __forceinline__ void split_rows(const float (&v)[2][8], uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float a[4] = {v[0][2 * s], v[1][2 * s], v[0][2 * s + 1], v[1][2 * s + 1]};
    f32h::split_a(a, ah[s], al[s]);
  }
}

// The k-blocks kb = 0 ... nkb - 1 of a product: fetch(kb, ah, al) brings
// block kb's A into registers, split; issue(kb, ah, al) multiplies (wgmma
// fence, the block's wgmmas, one commit group); done(kb) runs once block
// kb's group is complete (its stage may be freed). Two register buffers:
// each block's fetch runs while the block before it is multiplied, one
// group in flight behind the next (f32h::pipelined, with the hook).
template <class Fetch, class Issue, class Done>
__device__ __forceinline__ void pipelined(int nkb, Fetch fetch, Issue issue, Done done) {
  uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];
  fetch(0, h0, l0);
  issue(0, h0, l0);
  for (int kb = 1; kb < nkb; kb += 2) {
    fetch(kb, h1, l1);
    issue(kb, h1, l1);
    wgmma_wait<1>();
    done(kb - 1);
    if (kb + 1 < nkb) {
      fetch(kb + 1, h0, l0);
      issue(kb + 1, h0, l0);
      wgmma_wait<1>();
      done(kb);
    }
  }
  wgmma_wait<0>();
  done(nkb - 1);
}

// Shared memory of fwd_kernel<NW> and dx_kernel<KW>: the ring (STAGES of
// STAGE bytes), then EXTRA bytes, then the full / empty barriers.
template <int STAGE, int EXTRA>
struct Smem {
  static constexpr int kStages = (196608 / STAGE) < 6 ? (196608 / STAGE) : 6;
  static constexpr int kRing = kStages * STAGE;
  static constexpr int kBytes = 1024 + kRing + EXTRA + 2 * kStages * 8;
};

// --- 1. the forward: y and the s1/s2 partials -----------------------------------------

template <int NW>
using FwdSmem = Smem<(2 + 2 * NW / kBox) * kBoxF, 16 * NW * 4>;

// CTA blockIdx.x = (group, chunk): columns n0 = (blockIdx.x % chunks) * NW
// of N, 128-row tiles group, group + groups, ... with groups = gridDim.x /
// chunks. xmap: (M, K) fp32 in 32 x 64 boxes; wtmap: the wt planes (2, N,
// Kp). part (groups, 2, N): the CTA's s1/s2 partial row at its columns.
template <int NW, bool APPLY>
__global__ void __launch_bounds__(kCtaThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wtmap,
               float* __restrict__ y, const float* __restrict__ mul, const float* __restrict__ add,
               float* __restrict__ part, int M, int K, int N) {
  using S = FwdSmem<NW>;
  constexpr int kWb = NW / kBox, kStageBytes = (2 + 2 * kWb) * kBoxF;
  unsigned char* ring = smem_base();
  float* red = reinterpret_cast<float*>(ring + S::kRing);  // [consumer warp][s1, s2][column]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 16 * NW);
  uint64_t* empty = full + S::kStages;

  const int chunks = cdiv(N, NW), groups = gridDim.x / chunks;
  const int group = blockIdx.x / chunks, n0 = (blockIdx.x % chunks) * NW;
  const int tiles = cdiv(M, kTileRows), nkb = cdiv(K, kKb);
  const int mine = tiles > group ? (tiles - 1 - group) / groups + 1 : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  for (int i = tid; i < 16 * NW; i += kCtaThreads) red[i] = 0.f;
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int s = 0; s < mine * nkb; ++s) {
        const int st = s % S::kStages, r0 = (group + s / nkb * groups) * kTileRows, kb = s % nkb;
        unsigned char* stage = ring + st * kStageBytes;
        mbar_wait(&empty[st], ((s / S::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], kStageBytes);
        for (int h = 0; h < 2; ++h) tma_load_2d(stage + h * kBoxF, &xmap, &full[st], kb * kKb, r0 + h * kBox);
        for (int q = 0; q < kWb; ++q)
          for (int p = 0; p < 2; ++p)  // hi, lo
            tma_load_3d(stage + (2 + p * kWb + q) * kBoxF, &wtmap, &full[st], kb * kKb, n0 + q * kBox, p);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, warp = ctid >> 5, wq = warp & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float acc[kWb][32];
  int s = 0;  // the stage counter, as the producer's
  for (int i = 0; i < mine; ++i) {
    const int r0 = (group + i * groups) * kTileRows + wg * kBox;  // this warpgroup's rows
    const bool ok[2] = {r0 + wq * 16 + g < M, r0 + wq * 16 + g + 8 < M};
#pragma unroll
    for (int q = 0; q < kWb; ++q) f32h::zero(acc[q]);
    const int s0 = s;
    auto fetch = [&](int kb, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
      const int st = (s0 + kb) % S::kStages;
      mbar_wait(&full[st], ((s0 + kb) / S::kStages) & 1);
      float v[2][8];
      load_rows(ring + st * kStageBytes + wg * kBoxF, wq, g, t, v);
      const int c = kb * kKb + 8 * t;
      float m[8], ad[8];
      if (APPLY && c < K) load8(mul + c, m), load8(add + c, ad);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float a = v[h][e];
          if (APPLY) a = c < K ? fmaxf(__fadd_rn(__fmul_rn(a, m[e]), ad[e]), 0.f) : 0.f;
          v[h][e] = ok[h] ? a : 0.f;
        }
      split_rows(v, ah, al);
    };
    auto issue = [&](int kb, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
      const unsigned char* wb = ring + ((s0 + kb) % S::kStages) * kStageBytes + 2 * kBoxF;
#pragma unroll
      for (int q = 0; q < kWb; ++q) fence_acc(acc[q]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int q = 0; q < kWb; ++q)
          f32h::mma3<64>(acc[q], ah[ks], al[ks], f32h::kdesc(wb + q * kBoxF, ks),
                         f32h::kdesc(wb + (kWb + q) * kBoxF, ks));
      wgmma_commit();
    };
    auto done = [&](int kb) {
#pragma unroll
      for (int q = 0; q < kWb; ++q) fence_acc(acc[q]);
      if (lane == 0) mbar_arrive(&empty[(s0 + kb) % S::kStages]);
    };
    pipelined(nkb, fetch, issue, done);
    s += nkb;

    // Epilogue: y (rows past M and columns past N not stored; both hold
    // exact zeros of the accumulator, so the sums need no mask).
#pragma unroll
    for (int q = 0; q < kWb; ++q) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        float sums[8];  // per chunk j, j + 1: colsum(y) at two columns, then colsum(y^2)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float* d = acc[q] + 4 * (j + jj);
          const int c = n0 + q * kBox + 8 * (j + jj) + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (ok[h] && c < N)
              *reinterpret_cast<float2*>(y + (size_t)(r0 + wq * 16 + g + 8 * h) * N + c) =
                  make_float2(d[2 * h], d[2 * h + 1]);
          sums[4 * jj] = d[0] + d[2], sums[4 * jj + 1] = d[1] + d[3];
          sums[4 * jj + 2] = d[0] * d[0] + d[2] * d[2], sums[4 * jj + 3] = d[1] * d[1] + d[3] * d[3];
        }
        stage_colsums<true>(red, NW, warp, 8 * q + j, lane, sums);
      }
    }
  }
  write_colsums(red, NW, ctid, part, group, n0, N);  // the 8 warps' sums in warp order
}

template <int NW, bool APPLY>
int launch_fwd_k(const CUtensorMap& xmap, const CUtensorMap& wtmap, float* y, const float* mul, const float* add,
                 float* part, int groups, int M, int K, int N, cudaStream_t st) {
  constexpr int smem = FwdSmem<NW>::kBytes;
  static_assert(smem <= kSmemCap, "more shared memory than a CTA may use");
  auto kern = fwd_kernel<NW, APPLY>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<groups * cdiv(N, NW), kCtaThreads, smem, st>>>(xmap, wtmap, y, mul, add, part, M, K, N);
  return (int)cudaGetLastError();
}

// x (M, K), w (K, N), y (M, N) fp32; mul, add (K,) fp32 or both null.
// Scratch: planes (2, N, round32(K)) fp32; part (parts, 2, N) fp32 with
// parts = row_groups(M, N, sms). Out: s (2, N) fp32 = [s1; s2]. Returns 0,
// a CUresult of a tensor-map encoding or the first cudaError_t of the
// launches (cudaErrorInvalidValue for a wrong parts or missing planes).
inline int launch_fwd(const void* x, const void* w, const float* mul, const float* add, void* y, float* planes,
                      float* part, int parts, float* s, int M, int K, int N, cudaStream_t st) {
  if (!planes || parts != row_groups(M, N, sm_count())) return (int)cudaErrorInvalidValue;
  cudaError_t e = split_w(static_cast<const float*>(w), planes, K, N, 1, st);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap xmap, wtmap;
  int err = tmap_matrix_f32(&xmap, x, M, K);
  if (!err) err = tmap_batched_f32(&wtmap, planes, 2, N, round32(K));
  if (err) return err;
  float* yf = static_cast<float*>(y);
  if (width(N) == 64)
    err = mul ? launch_fwd_k<64, true>(xmap, wtmap, yf, mul, add, part, parts, M, K, N, st)
              : launch_fwd_k<64, false>(xmap, wtmap, yf, mul, add, part, parts, M, K, N, st);
  else
    err = mul ? launch_fwd_k<128, true>(xmap, wtmap, yf, mul, add, part, parts, M, K, N, st)
              : launch_fwd_k<128, false>(xmap, wtmap, yf, mul, add, part, parts, M, K, N, st);
  if (err) return err;
  cbn::reduce_rows<<<cbn::ceil_div(2 * N, 32), dim3(32, 8), 0, st>>>(part, parts, 2 * N, s);
  return (int)cudaGetLastError();
}

// --- 2. dx and the dmul/dadd partials ---------------------------------------------------

template <int KW>
using DxSmem = Smem<(4 + 2 * KW / kBox) * kBoxF, 18 * KW * 4>;

// CTA blockIdx.x = (group, K range): columns c0 = (blockIdx.x % ranges) * KW
// of K, 128-row tiles group, group + groups, ... ymap, dymap: (M, N) fp32;
// wnmap: the wn planes (2, K, Np). x, dx (M, K). part (groups, 2, K): the
// dmul/dadd partial rows (with APPLY).
template <int KW, bool APPLY>
__global__ void __launch_bounds__(kCtaThreads, 1)
    dx_kernel(const __grid_constant__ CUtensorMap ymap, const __grid_constant__ CUtensorMap dymap,
              const __grid_constant__ CUtensorMap wnmap, const float* __restrict__ x, float* __restrict__ dx,
              const float* __restrict__ ds, const float* __restrict__ mul, const float* __restrict__ add,
              float* __restrict__ part, int M, int K, int N) {
  using S = DxSmem<KW>;
  constexpr int kWb = KW / kBox, kStageBytes = (4 + 2 * kWb) * kBoxF;
  unsigned char* ring = smem_base();
  float* red = reinterpret_cast<float*>(ring + S::kRing);  // [consumer warp][dmul, dadd][column]
  float* col_mul = red + 16 * KW;
  float* col_add = col_mul + KW;
  uint64_t* full = reinterpret_cast<uint64_t*>(col_add + KW);
  uint64_t* empty = full + S::kStages;

  const int ranges = cdiv(K, KW), groups = gridDim.x / ranges;
  const int group = blockIdx.x / ranges, c0 = (blockIdx.x % ranges) * KW;
  const int tiles = cdiv(M, kTileRows), nkb = cdiv(N, kKb);
  const int mine = tiles > group ? (tiles - 1 - group) / groups + 1 : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  if (APPLY) {
    for (int i = tid; i < 16 * KW; i += kCtaThreads) red[i] = 0.f;
    for (int i = tid; i < KW; i += kCtaThreads) {
      col_mul[i] = c0 + i < K ? __ldg(mul + c0 + i) : 0.f;
      col_add[i] = c0 + i < K ? __ldg(add + c0 + i) : 0.f;
    }
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int s = 0; s < mine * nkb; ++s) {
        const int st = s % S::kStages, r0 = (group + s / nkb * groups) * kTileRows, kb = s % nkb;
        unsigned char* stage = ring + st * kStageBytes;
        mbar_wait(&empty[st], ((s / S::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], kStageBytes);
        for (int h = 0; h < 2; ++h) {
          tma_load_2d(stage + h * kBoxF, &ymap, &full[st], kb * kKb, r0 + h * kBox);
          tma_load_2d(stage + (2 + h) * kBoxF, &dymap, &full[st], kb * kKb, r0 + h * kBox);
        }
        for (int q = 0; q < kWb; ++q)
          for (int p = 0; p < 2; ++p)
            tma_load_3d(stage + (4 + p * kWb + q) * kBoxF, &wnmap, &full[st], kb * kKb, c0 + q * kBox, p);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, warp = ctid >> 5, wq = warp & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* wred = red + warp * 2 * KW;
  float acc[kWb][32];
  int s = 0;
  for (int i = 0; i < mine; ++i) {
    const int r0 = (group + i * groups) * kTileRows + wg * kBox;
    const bool ok[2] = {r0 + wq * 16 + g < M, r0 + wq * 16 + g + 8 < M};
#pragma unroll
    for (int q = 0; q < kWb; ++q) f32h::zero(acc[q]);
    const int s0 = s;
    auto fetch = [&](int kb, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
      const int st = (s0 + kb) % S::kStages;
      mbar_wait(&full[st], ((s0 + kb) / S::kStages) & 1);
      const unsigned char* stage = ring + st * kStageBytes;
      float v[2][8], yv[2][8];
      load_rows(stage + (2 + wg) * kBoxF, wq, g, t, v);  // dy
      load_rows(stage + wg * kBoxF, wq, g, t, yv);
      const int n = kb * kKb + 8 * t;
      float d1[8], d2[8];
      if (n < N) load8(ds + n, d1), load8(ds + N + n, d2);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[h][e] = ok[h] && n < N ? __fadd_rn(__fadd_rn(v[h][e], d1[e]), __fmul_rn(2.f * yv[h][e], d2[e])) : 0.f;
      split_rows(v, ah, al);
    };
    auto issue = [&](int kb, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
      const unsigned char* wb = ring + ((s0 + kb) % S::kStages) * kStageBytes + 4 * kBoxF;
#pragma unroll
      for (int q = 0; q < kWb; ++q) fence_acc(acc[q]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int q = 0; q < kWb; ++q)
          f32h::mma3<64>(acc[q], ah[ks], al[ks], f32h::kdesc(wb + q * kBoxF, ks),
                         f32h::kdesc(wb + (kWb + q) * kBoxF, ks));
      wgmma_commit();
    };
    auto done = [&](int kb) {
#pragma unroll
      for (int q = 0; q < kWb; ++q) fence_acc(acc[q]);
      if (lane == 0) mbar_arrive(&empty[(s0 + kb) % S::kStages]);
    };
    pipelined(nkb, fetch, issue, done);
    s += nkb;

    // Epilogue: dx at this thread's rows and column pairs; with the
    // prologue t = da * (x*mul + add > 0), dx = t*mul and the rows' colsum(t*x),
    // colsum(t) (rows past M and columns past K left out) added, in tile
    // order, to the warp's slots.
#pragma unroll
    for (int q = 0; q < kWb; ++q) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = q * kBox + 8 * j + 2 * t, c = c0 + cl;
        const float* d = acc[q] + 4 * j;
        float u0 = 0.f, u1 = 0.f, w0 = 0.f, w1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + wq * 16 + g + 8 * h;
          if (!ok[h] || c >= K) continue;
          float v0 = d[2 * h], v1 = d[2 * h + 1];
          if (APPLY) {
            const float2 xv = *reinterpret_cast<const float2*>(x + (size_t)r * K + c);
            const float m0 = col_mul[cl], m1 = col_mul[cl + 1];
            const float t0 = __fadd_rn(__fmul_rn(xv.x, m0), col_add[cl]) > 0.f ? v0 : 0.f;
            const float t1 = __fadd_rn(__fmul_rn(xv.y, m1), col_add[cl + 1]) > 0.f ? v1 : 0.f;
            u0 += t0 * xv.x, u1 += t1 * xv.y, w0 += t0, w1 += t1;
            v0 = t0 * m0;
            v1 = t1 * m1;
          }
          *reinterpret_cast<float2*>(dx + (size_t)r * K + c) = make_float2(v0, v1);
        }
        if (APPLY) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            u0 += __shfl_xor_sync(0xffffffffu, u0, o);
            u1 += __shfl_xor_sync(0xffffffffu, u1, o);
            w0 += __shfl_xor_sync(0xffffffffu, w0, o);
            w1 += __shfl_xor_sync(0xffffffffu, w1, o);
          }
          if (lane < 4) wred[cl] += u0, wred[cl + 1] += u1, wred[KW + cl] += w0, wred[KW + cl + 1] += w1;
        }
      }
    }
  }
  if (APPLY) {  // the 8 warps' sums in warp order: this CTA's partial row
    named_barrier(1, kConsumerThreads);
    const int c = c0 + ctid;
    if (ctid < KW && c < K) {
      float u = red[ctid], v = red[KW + ctid];
      for (int w = 1; w < 8; ++w) u += red[w * 2 * KW + ctid], v += red[w * 2 * KW + KW + ctid];
      part[(size_t)group * 2 * K + c] = u;
      part[(size_t)group * 2 * K + K + c] = v;
    }
  }
}

// --- 3. dw partials -------------------------------------------------------------------

// Shared memory of dw_kernel: the ring (x: four boxes; y, dy: two each),
// g^T's planes [buffer][hi, lo][row half] (64 columns x 32 rows a box),
// the barriers.
struct DwSmem {  // 197 KB: a third stage does not fit beside the two plane buffers
  static constexpr int kStageBytes = 8 * kBoxF;
  static constexpr int kRing = kDwStages * kStageBytes;
  static constexpr int kPlanes = 2 * 4 * kBoxF;
  static constexpr int kBytes = 1024 + kRing + kPlanes + 2 * kDwStages * 8;
};

// CTA (128 channels of K, 64 columns of N) = blockIdx.x, range blockIdx.y
// of the 64-row tiles. xmap: (M, K); ymap, dymap: (M, N). Writes part[range]
// (K x N fp32) in its block.
template <bool APPLY>
__global__ void __launch_bounds__(kCtaThreads, 1)
    dw_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
              const __grid_constant__ CUtensorMap dymap, const float* __restrict__ ds,
              const float* __restrict__ mul, const float* __restrict__ add, float* __restrict__ part, int M,
              int K, int N) {
  using S = DwSmem;
  unsigned char* ring = smem_base();
  unsigned char* planes = ring + S::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + S::kPlanes);
  uint64_t* empty = full + kDwStages;

  const int nblocks = cdiv(N, kBox);
  const int n0 = (blockIdx.x % nblocks) * kBox, c0 = (blockIdx.x / nblocks) * 2 * kBox;
  const long long tiles = cdiv(M, kBox);
  const int first = (int)(tiles * blockIdx.y / gridDim.y);
  const int steps = (int)(tiles * (blockIdx.y + 1) / gridDim.y) - first;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % kDwStages, r0 = (first + s) * kBox;
        unsigned char* stage = ring + st * S::kStageBytes;
        mbar_wait(&empty[st], ((s / kDwStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], S::kStageBytes);
        for (int b = 0; b < 4; ++b) tma_load_2d(stage + b * kBoxF, &xmap, &full[st], c0 + b * kKb, r0);
        for (int b = 0; b < 2; ++b) {
          tma_load_2d(stage + (4 + b) * kBoxF, &ymap, &full[st], n0 + b * kKb, r0);
          tma_load_2d(stage + (6 + b) * kBoxF, &dymap, &full[st], n0 + b * kKb, r0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, wq = (ctid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  // This thread's channel pair of the warpgroup's 64 (m rows g and g + 8 of
  // its warp), its x box and column there, and the prologue's mul / add.
  const int cw = wg * kBox + wq * 16 + 2 * g, c = c0 + cw;
  const int xb = cw >> 5, xc = cw & 31;
  float m0 = 0.f, m1 = 0.f, a0 = 0.f, a1 = 0.f;
  if (APPLY && c < K) m0 = __ldg(mul + c), m1 = __ldg(mul + c + 1), a0 = __ldg(add + c), a1 = __ldg(add + c + 1);
  // g^T: this thread's logical 16-byte chunks (columns 4 lc ... of y box b)
  // of tile row gr.
  const int gr = ctid & 63;

  // g^T's planes of tile s, from its stage's y and dy, into buffer s & 1:
  // g (row gr, column n) -> box (gr >> 5), row n, column gr & 31.
  auto form = [&](int s) {
    const int st = s % kDwStages, r0 = (first + s) * kBox;
    const unsigned char* stage = ring + st * S::kStageBytes;
    unsigned char* ph = planes + (s & 1) * 4 * kBoxF;  // hi plane: two boxes (rows 0-31, 32-63); lo after
    mbar_wait(&full[st], (s / kDwStages) & 1);
    const bool row_ok = r0 + gr < M;
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int lc = (ctid >> 6) + 4 * j, n = n0 + b * kKb + 4 * lc;
        const int off = gr * 128 + ((lc ^ (gr & 7)) << 4);
        const float4 yv = *reinterpret_cast<const float4*>(stage + (4 + b) * kBoxF + off);
        const float4 dv = *reinterpret_cast<const float4*>(stage + (6 + b) * kBoxF + off);
        float4 d1 = make_float4(0.f, 0.f, 0.f, 0.f), d2 = d1;
        if (n < N) d1 = __ldg(reinterpret_cast<const float4*>(ds + n)), d2 = __ldg(reinterpret_cast<const float4*>(ds + N + n));
        const float yy[4] = {yv.x, yv.y, yv.z, yv.w}, dd[4] = {dv.x, dv.y, dv.z, dv.w};
        const float s1[4] = {d1.x, d1.y, d1.z, d1.w}, s2[4] = {d2.x, d2.y, d2.z, d2.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float gv = row_ok && n < N ? __fadd_rn(__fadd_rn(dd[e], s1[e]), __fmul_rn(2.f * yy[e], s2[e])) : 0.f;
          uint32_t hi, lo;
          f32h::split_v(gv, hi, lo);
          const int po = (gr >> 5) * kBoxF + f32h::swz(b * kKb + 4 * lc + e, gr & 31);
          *reinterpret_cast<uint32_t*>(ph + po) = hi;
          *reinterpret_cast<uint32_t*>(ph + 2 * kBoxF + po) = lo;
        }
      }
    fence_proxy_async();
  };

  float acc[32];
  f32h::zero(acc);
  form(0);
  named_barrier(1, kConsumerThreads);  // tile 0's planes are complete
  for (int s = 0; s < steps; ++s) {
    const int st = s % kDwStages;
    const unsigned char* stage = ring + st * S::kStageBytes;
    const unsigned char* ph = planes + (s & 1) * 4 * kBoxF;
    // dw (64 channels x 64 columns) += a^T g over the tile's 64 rows: A m row
    // 16 wq + g (+ 8) is channel cw (+ 1), k-slot t (+ 4) of k-step ks is
    // tile row 8 ks + t (+ 4); B the planes, k-step ks in box ks >> 2. A
    // warpgroup whose channels all lie past K multiplies zeros (TMA's zeros,
    // mul = add = 0): a branch around the wgmmas would serialize them (ptxas
    // C7520).
    uint32_t ah[8][4], al[8][4];  // k-step ks's own registers: no wgmma waits on another's
    fence_acc(acc);
    const unsigned char* blk = stage + xb * kBoxF;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      float2 x0 = *reinterpret_cast<const float2*>(blk + f32h::swz(8 * ks + t, xc));
      float2 x1 = *reinterpret_cast<const float2*>(blk + f32h::swz(8 * ks + t + 4, xc));
      if (APPLY) {
        x0.x = fmaxf(__fadd_rn(__fmul_rn(x0.x, m0), a0), 0.f), x0.y = fmaxf(__fadd_rn(__fmul_rn(x0.y, m1), a1), 0.f);
        x1.x = fmaxf(__fadd_rn(__fmul_rn(x1.x, m0), a0), 0.f), x1.y = fmaxf(__fadd_rn(__fmul_rn(x1.y, m1), a1), 0.f);
      }
      const float a[4] = {x0.x, x0.y, x1.x, x1.y};
      f32h::split_a(a, ah[ks], al[ks]);
      wgmma_fence();
      f32h::mma3<64>(acc, ah[ks], al[ks], f32h::kdesc(ph + (ks >> 2) * kBoxF, ks & 3),
                     f32h::kdesc(ph + (2 + (ks >> 2)) * kBoxF, ks & 3));
    }
    wgmma_commit();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // x is in registers, y and dy in the planes: the stage is free
    // The next tile's planes while these products run: its buffer was read
    // by tile s - 1's, which both warpgroups finished before the last barrier.
    if (s + 1 < steps) form(s + 1);
    wgmma_wait<0>();
    fence_acc(acc);
    named_barrier(1, kConsumerThreads);  // tile s + 1's planes complete; tile s's products done
    // Every kFlush tiles (and at the end) the accumulators are added to the
    // partial with round to nearest and start again from 0.
    if ((s + 1) % kFlush == 0 || s + 1 == steps) {
      float* out = part + (size_t)blockIdx.y * K * N;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + 8 * i + 2 * t;
        if (c < K && n < N) {
          float* w = acc + 4 * i;
          float2* o0 = reinterpret_cast<float2*>(out + (size_t)c * N + n);
          float2* o1 = reinterpret_cast<float2*>(out + (size_t)(c + 1) * N + n);
          const float2 p0 = s < kFlush ? make_float2(0.f, 0.f) : *o0, p1 = s < kFlush ? make_float2(0.f, 0.f) : *o1;
          *o0 = make_float2(p0.x + w[0], p0.y + w[1]);
          *o1 = make_float2(p1.x + w[2], p1.y + w[3]);
        }
        acc[4 * i] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.f;
      }
    }
  }
}

// --- launchers -----------------------------------------------------------------------

template <int KW, bool APPLY>
int launch_dx_k(const CUtensorMap& ymap, const CUtensorMap& dymap, const CUtensorMap& wnmap, const float* x,
                float* dx, const float* ds, const float* mul, const float* add, float* part, int groups, int M,
                int K, int N, cudaStream_t st) {
  constexpr int smem = DxSmem<KW>::kBytes;
  static_assert(smem <= kSmemCap, "more shared memory than a CTA may use");
  auto kern = dx_kernel<KW, APPLY>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<groups * cdiv(K, KW), kCtaThreads, smem, st>>>(ymap, dymap, wnmap, x, dx, ds, mul, add, part, M, K, N);
  return (int)cudaGetLastError();
}

template <bool APPLY>
int launch_dw_k(const CUtensorMap& xmap, const CUtensorMap& ymap, const CUtensorMap& dymap, const float* ds,
                const float* mul, const float* add, float* part, int ranges, int M, int K, int N,
                cudaStream_t st) {
  constexpr int smem = DwSmem::kBytes;
  static_assert(smem <= kSmemCap, "more shared memory than a CTA may use");
  auto kern = dw_kernel<APPLY>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(cdiv(K, 2 * kBox) * cdiv(N, kBox), ranges), kCtaThreads, smem, st>>>(xmap, ymap, dymap, ds, mul,
                                                                                    add, part, M, K, N);
  return (int)cudaGetLastError();
}

// Partial rows of one backward call on a card of `sms` SMs: dmul/dadd
// (parts_x) and dw (parts_w).
inline int dx_partials(int M, int K, int sms) { return row_groups(M, K, sms); }
inline int dw_partials(int M, int K, int N, int sms) { return dw_ranges(M, K, N, sms); }

// x (M, K), w (K, N), y, dy (M, N) fp32; mul, add (K,) fp32 or both null; ds
// (2, N) fp32. Scratch: planes (2, K, round32(N)) fp32, part_x (parts_x, 2,
// K) fp32 (written with mul only), part_w (parts_w, K, N) fp32, with the
// counts above. Out: dx (M, K), dw (K, N), dmd (2, K) = [dmul; dadd] (with
// mul), all fp32. Returns 0, a CUresult of a tensor-map encoding or the
// first cudaError_t of the launches (cudaErrorInvalidValue for wrong
// partial counts or missing planes).
inline int launch_bwd(const void* x, const void* w, const float* mul, const float* add, const void* y,
                      const void* dy, const float* ds, float* planes, void* dx, float* dw, float* dmd,
                      float* part_x, int parts_x, float* part_w, int parts_w, int M, int K, int N,
                      cudaStream_t st) {
  const int sms = sm_count();
  if (!planes || parts_x != dx_partials(M, K, sms) || parts_w != dw_partials(M, K, N, sms))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = split_w(static_cast<const float*>(w), planes, K, N, 0, st);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap xmap, wnmap, ymap, dymap;
  int err = tmap_matrix_f32(&xmap, x, M, K);
  if (!err) err = tmap_batched_f32(&wnmap, planes, 2, K, round32(N));
  if (!err) err = tmap_matrix_f32(&ymap, y, M, N);
  if (!err) err = tmap_matrix_f32(&dymap, dy, M, N);
  if (err) return err;
  const float* xf = static_cast<const float*>(x);
  float* dxf = static_cast<float*>(dx);
  if (width(K) == 64)
    err = mul ? launch_dx_k<64, true>(ymap, dymap, wnmap, xf, dxf, ds, mul, add, part_x, parts_x, M, K, N, st)
              : launch_dx_k<64, false>(ymap, dymap, wnmap, xf, dxf, ds, mul, add, part_x, parts_x, M, K, N, st);
  else
    err = mul ? launch_dx_k<128, true>(ymap, dymap, wnmap, xf, dxf, ds, mul, add, part_x, parts_x, M, K, N, st)
              : launch_dx_k<128, false>(ymap, dymap, wnmap, xf, dxf, ds, mul, add, part_x, parts_x, M, K, N, st);
  if (err) return err;
  err = mul ? launch_dw_k<true>(xmap, ymap, dymap, ds, mul, add, part_w, parts_w, M, K, N, st)
            : launch_dw_k<false>(xmap, ymap, dymap, ds, mul, add, part_w, parts_w, M, K, N, st);
  if (err) return err;
  if (mul) {
    cbn::reduce_rows<<<cbn::ceil_div(2 * K, 32), dim3(32, 8), 0, st>>>(part_x, parts_x, 2 * K, dmd);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  cbn::reduce_rows<<<cbn::ceil_div(K * N, 32), dim3(32, 8), 0, st>>>(part_w, parts_w, K * N, dw);
  return (int)cudaGetLastError();
}

}  // namespace mbf
