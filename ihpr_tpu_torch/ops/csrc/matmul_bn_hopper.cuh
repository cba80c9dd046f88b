// K5 and K6, the fused 1x1 conv (matmul) + BatchNorm statistics forward and
// backward, in bf16 for Hopper (sm_90a): the kernels of matmul_bn_fwd.cu
// (replaces ihpr_tpu/ops/matmul_bn.py:_fwd_kernel) and matmul_bn_bwd.cu
// (replaces ihpr_tpu/ops/matmul_bn.py:_bwd_kernel) for bf16 operands. fp32
// operands take matmul_bn_f32.cuh (K5-fp32 / K6-fp32: 3xTF32 on wgmma).
//
// What they compute. x (M, K), w (K, N), y and dy (M, N) bf16; ds = [ds1;
// ds2] (2, N) fp32; with the prologue mul, add (K,) fp32 and a =
// bf16(relu(x*mul + add)) (fp32, the multiply and the add rounded apart, as
// the plain version), else a = x.
//   forward (K5): y = bf16(a @ w) (fp32 accumulation); s1 = colsum(yf),
//        s2 = colsum(yf^2), from the fp32 accumulator before the cast.
//   backward (K6):
//   gc = bf16((dy + ds1) + (2*y)*ds2)  (fp32 from the saved, rounded y);
//   da = gc @ w^T (fp32); with the prologue t = da * (x*mul + add > 0),
//        dx = bf16(t*mul), dmul = colsum(t*x), dadd = colsum(t); else dx = bf16(da);
//   dw = a^T @ gc (fp32).
//
// K5. What bounds it on an H100: bytes. Each input read once and each output
// written once is 2(MK + MN) + 2KN bytes; the product is 2MKN flops. At the
// flagship fused step's shapes the bytes take 1.095 ms per step at 3.35
// TB/s, the flops at most 35 us a call at 989 TFLOP/s. v1 (conv_bn_common.cuh:
// mma.sync from a cp.async ring, 64 x 64 CTA tiles) read x once per 64
// columns of N, applied the prologue as often, stored y 4 bytes at a time
// and ran at 0.23 of the bound per step.
//
// Design (v2), 0. fwd_kernel: persistent CTAs, about one per SM, each one
// chunk of NW = width(N) columns of N (256-wide chunks where N > 256) and a
// strided set of 128-row tiles; a producer warp issues TMA and each of two
// consumer warpgroups takes one 64-row box of a tile. A stage is one 64-wide
// k-block: the tile's two x boxes and, where w's chunk does not stay
// resident in shared memory, its NW-wide block of w (fwd_plan: w stays
// where K x NW bf16 fits beside the staging tiles, the sums and two stages).
// With the prologue each warpgroup rewrites its x box in place into a (rows
// past M and columns past K zeroed: TMA's zeros would become relu(add)),
// fences, and runs wgmma m64nNWk16 with a K-major and w MN-major; a stage's
// products stay in flight while the next stage is waited for and
// rewritten, then the stage is freed. The ring runs across tiles, so one
// tile's epilogue overlaps the next tile's loads. Epilogue from the fp32
// accumulator: y in bf16 through a swizzled 64 x NW staging tile per
// warpgroup and TMA stores, which clip rows past M and columns past N;
// s1/s2 added per (warp, column) slot in tile order (hopper.cuh:
// stage_colsums, a reduce-scatter over the warp's rows); one partial row
// per CTA, which cbn::reduce_rows adds in a fixed order. HBM bytes: x is
// read once where N <= 256 (N / 256 times above, the repeats mostly from
// L2: the CTAs of one tile's chunks run side by side) and y written once,
// the bound's; a streamed w is re-read from L2, K x NW x 2 bytes per 128
// rows.
//
// K6. What bounds it on an H100: bytes. Each input read once and each output
// written once is 2(MK + MN) bf16 + 6KN bytes; the products are 4MKN flops.
// At the flagship fused step's shapes (M = 32768 ... 524288, K, N = 64 ...
// 1024) the bytes take 2.195 ms per step at 3.35 TB/s, the flops 0.60 ms at
// 989 TFLOP/s. v1 (conv_bn_common.cuh) wrote gc (M x N) and read it twice, read
// gc's rows once per 64 columns of K and x once per 64 columns of N with
// mma.sync, and ran at 0.09-0.31 of the bound.
//
// Design (v2): TMA + wgmma kernels that form gc (and a) in shared memory
// from the tiles they load, so neither reaches device memory. Where K and N
// are at most 256 and dw (K x N fp32, K and N rounded up to 64, 128 or 256)
// fits one warpgroup's registers, K x N <= 128 x 128, one kernel reads each
// tile once (3.); otherwise two kernels split the work (1., 2.).
//   1. da_kernel (dx, dmul/dadd): persistent CTAs, each a fixed range of NW
//      columns of K (NW = width(K): 64, 128 or 256) and a strided set of 128-row
//      tiles. A producer warp issues TMA for one 64-column step of N at a
//      time: y and dy for the tile's 128 rows (two 64-row boxes each) and the
//      NW x 64 block of w (rows c, columns n: wgmma's K-major B). Each of the
//      two consumer warpgroups rewrites its 64-row dy box in place into gc
//      (the column of a swizzled 16-byte chunk is undone from its row;
//      columns past N are zeroed), fences the writes to the async proxy, runs
//      wgmma m64nNWk16 with gc as the K-major A, and frees the stage as soon
//      as the (short) products are done. The ring (2-4 stages) continues
//      across tiles, so one tile's epilogue overlaps the next tile's loads.
//      Epilogue in a 64 x NW staging tile per warpgroup: x comes in by TMA
//      (with the prologue), dx is written over it from the fp32 accumulator
//      (the prologue's backward), and goes out by TMA store, which clips
//      rows past M and columns past K; dmul/dadd are added per (warp,
//      column) slot in shared memory in tile order; one partial row per CTA.
//   2. dw_kernel (dw partials): one CTA per (128 channels of K, NW =
//      width(N) columns of N, range of 64-row tiles), one range per SM's share. A
//      stage is the tile's x (two 64-channel boxes), y and dy (NW / 64 boxes
//      each). All 256 consumer threads rewrite dy into gc (rows past M and
//      columns past N zeroed) and, with the prologue, x into a (columns past
//      K zeroed), fence, and each warpgroup runs wgmma m64nNWk16 with its a
//      box as the M-major A and the gc boxes as the MN-major B: dw (64 x NW
//      per warpgroup) stays in registers over the range, and each CTA writes
//      its partial block.
//   3. one_pass_kernel: one CTA per SM's range of 64-row tiles, w resident
//      in shared memory. A stage is the tile's x, y, dy and an aux slot; all
//      256 consumer threads form gc (and a, into aux), then warpgroup 0 runs
//      da and the dx epilogue (dx written over x, or into aux without the
//      prologue, and out by TMA store) while warpgroup 1 adds a^T gc to dw
//      in its registers; each frees the stage when done.
//   4. cbn::reduce_rows adds the partial rows in a fixed order: dmul/dadd, dw.
// No atomics and a static schedule (K5 and K6): results are bitwise the same
// from run to run on one card (the partial counts follow its SM count).
//
// HBM bytes per call: one_pass_kernel 2MN + 2MK, the bound's; with two
// kernels, and the rows that CTAs of other column ranges re-read found in
// L2, da_kernel 2MN + MK (y, dy, dx) and MK more for x with the prologue,
// dw_kernel 2MN + MK (y, dy, x): 4MN + 2MK or 4MN + 3MK bf16, so at full
// bandwidth 0.67 (K = N, no prologue) down to 0.53 (N = 4K, prologue) of
// the bound. Both add the partials (ranges x K x N fp32, written and read
// once).
//
// Shapes (both): any M >= 1; K and N multiples of 8 (TMA's 16-byte pitch).
// Rows past M and columns past K or N read TMA's zeros and are masked out of
// every store and every column sum.

#pragma once

#include "conv_bn_common.cuh"
#include "hopper.cuh"

namespace mbh {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kCtaThreads = 384;       // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kTileRows = 2 * kBox;    // rows of a fwd or da tile, one box per consumer warpgroup
constexpr int kRingCap = 192 * 1024;   // shared memory for the TMA ring

// The wgmma width that covers `cols` output columns, at most 256: the
// columns of N a fwd_kernel or dw_kernel CTA covers, and of K a da_kernel
// CTA covers.
// (At most 128 where N > 128, for 48 KB stages in place of 64 or 80 KB, was
// slower on the card: twice the CTAs re-read their rows from L2.)
__host__ __device__ constexpr int width(int cols) { return cols <= 64 ? 64 : cols <= 128 ? 128 : 256; }

// A ring of 64 x 64 boxes: stages of BOXES boxes, at most 4 stages in CAP
// bytes, and its full / empty barriers.
template <int BOXES, int CAP = kRingCap>
struct Ring {
  static constexpr int kStageBytes = BOXES * kBoxBytes;
  static constexpr int kStages = CAP / kStageBytes < 4 ? CAP / kStageBytes : 4;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kBars = 2 * kStages * 8;
};

// CTAs per chunk of width(cols) columns (of N in fwd_kernel, of K in
// da_kernel), each writing one partial row: about one CTA per SM in all, at
// least one, at most one per 128-row tile.
inline int row_groups(int M, int cols, int sms) {
  const int g = sms / cdiv(cols, width(cols)), tiles = cdiv(M, kTileRows);
  return g < 1 ? 1 : (g < tiles ? g : tiles);
}

// Ranges of 64-row tiles dw_kernel splits the rows into: about one CTA per
// SM, at least one range, at most one tile per range.
inline int dw_ranges(int M, int K, int N, int sms) {
  const int r = sms / (cdiv(K, 2 * kBox) * cdiv(N, width(N))), tiles = cdiv(M, kBox);
  return r < 1 ? 1 : (r < tiles ? r : tiles);
}

// Column of the 16-byte chunk pc of row r of a swizzled box, in elements.
__device__ __forceinline__ int chunk_col(int r, int pc) { return 8 * (pc ^ (r & 7)); }

// Eight gc values from eight y and dy values and their columns' ds1, ds2.
__device__ __forceinline__ uint4 gc8(uint4 y_raw, uint4 d_raw, const float (&d1)[8], const float (&d2)[8]) {
  const bf16* yv = reinterpret_cast<const bf16*>(&y_raw);
  bf16* d = reinterpret_cast<bf16*>(&d_raw);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    d[q] = __float2bfloat16(__fadd_rn(__fadd_rn(__bfloat162float(d[q]), d1[q]),
                                      __fmul_rn(2.f * __bfloat162float(yv[q]), d2[q])));
  return d_raw;
}

// Eight values of a = bf16(relu(x*mul + add)) from eight x values and their
// columns' mul, add.
__device__ __forceinline__ uint4 prologue8(uint4 x_raw, const float (&m)[8], const float (&ad)[8]) {
  bf16* e = reinterpret_cast<bf16*>(&x_raw);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    e[q] = __float2bfloat16(fmaxf(__fadd_rn(__fmul_rn(__bfloat162float(e[q]), m[q]), ad[q]), 0.f));
  return x_raw;
}

// gc over NB dy boxes, in place (columns n0 + 64 q ..., from the y boxes at
// yb; rows past M and columns past N zeroed: a row past M has a =
// relu(add), not 0), and with APPLY a over KB x boxes (columns c0 + 64 h
// ..., into ab, which may be xb itself; columns past K zeroed), by all 256
// consumer threads: rows rr and rr + 32 of chunk pc of every box, so one
// column block per box. Then the writes are fenced to the async proxy for
// the wgmma that reads them.
template <int NB, int KB, bool APPLY>
__device__ __forceinline__ void form_gc_a(const unsigned char* yb, unsigned char* gb, int n0,
                                          const unsigned char* xb, unsigned char* ab, int c0, int r0,
                                          int ctid, const float* __restrict__ ds, const float* __restrict__ mul,
                                          const float* __restrict__ add, int M, int K, int N) {
  const int pc = ctid & 7, rr = (ctid >> 3) & 31, col = chunk_col(rr, pc);
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int n = n0 + q * kBox + col;
    float d1[8], d2[8];
    if (n < N) load8(ds + n, d1), load8(ds + N + n, d2);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = rr + 32 * e, off = q * kBoxBytes + r * 128 + pc * 16;
      uint4* g = reinterpret_cast<uint4*>(gb + off);
      *g = n < N && r0 + r < M ? gc8(*reinterpret_cast<const uint4*>(yb + off), *g, d1, d2)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (APPLY) {
#pragma unroll
    for (int h = 0; h < KB; ++h) {
      const int c = c0 + h * kBox + col;
      float m[8], ad[8];
      if (c < K) load8(mul + c, m), load8(add + c, ad);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int off = h * kBoxBytes + (rr + 32 * e) * 128 + pc * 16;
        *reinterpret_cast<uint4*>(ab + off) =
            c < K ? prologue8(*reinterpret_cast<const uint4*>(xb + off), m, ad) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  fence_proxy_async();
  named_barrier(1, kConsumerThreads);
}

// The dx epilogue of one consumer warpgroup's 64 rows from r0 and W columns
// from c0, from its da accumulator (wgmma m64nWk16 layout) into `tile`, W /
// 64 swizzled boxes: element (r, c) of a thread's rows r = 16 wq + gq (+8)
// and column pairs c = 8 ci + 2 tig. Without APPLY dx = bf16(da). With
// APPLY the tile holds x, dx = bf16(t*mul) with t = da * (x*mul + add > 0)
// is written over it, and the rows' colsum(t*x) and colsum(t) (rows past M
// and columns past K left out) are added, in tile order, to the warp's
// slots red[0, W) and red[W, 2W). col_mul, col_add: mul and add of the W
// columns.
template <int W, bool APPLY>
__device__ __forceinline__ void dx_epilogue(unsigned char* tile, const float (&acc)[W / 2],
                                            const float* col_mul, const float* col_add, float* red,
                                            int r0, int c0, int M, int K) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tig = lane & 3, wq = (threadIdx.x >> 5) & 3;
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) ok[h] = r0 + wq * 16 + gq + 8 * h < M;
#pragma unroll
  for (int ci = 0; ci < W / 8; ++ci) {
    const int cl = 8 * ci + 2 * tig, c = c0 + cl;
    float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wq * 16 + gq + 8 * h;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(
          tile + (ci >> 3) * kBoxBytes + r * 128 + (((ci & 7) ^ (r & 7)) << 4) + 4 * tig);
      float d0 = acc[4 * ci + 2 * h], d1 = acc[4 * ci + 2 * h + 1];
      if (APPLY) {
        const float2 xv = __bfloat1622float2(*e);
        const float m0 = col_mul[cl], m1 = col_mul[cl + 1];
        const float t0 = __fadd_rn(__fmul_rn(xv.x, m0), col_add[cl]) > 0.f ? d0 : 0.f;
        const float t1 = __fadd_rn(__fmul_rn(xv.y, m1), col_add[cl + 1]) > 0.f ? d1 : 0.f;
        if (ok[h] && c < K) u0 += t0 * xv.x, u1 += t1 * xv.y, v0 += t0, v1 += t1;
        d0 = t0 * m0;
        d1 = t1 * m1;
      }
      *e = __floats2bfloat162_rn(d0, d1);
    }
    if (APPLY) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        u0 += __shfl_xor_sync(0xffffffffu, u0, o);
        u1 += __shfl_xor_sync(0xffffffffu, u1, o);
        v0 += __shfl_xor_sync(0xffffffffu, v0, o);
        v1 += __shfl_xor_sync(0xffffffffu, v1, o);
      }
      if (lane < 4) red[cl] += u0, red[cl + 1] += u1, red[W + cl] += v0, red[W + cl + 1] += v1;
    }
  }
}

// --- 0. the forward: y and the s1/s2 partials ---------------------------------------

constexpr int kSmemCap = 227 * 1024;  // dynamic shared memory one CTA may use
constexpr int kFwdMaxStages = 8;

// How fwd_kernel lays out its shared memory for (K, N): NW = width(N);
// whether w's K x NW chunk stays resident (beside a ring of two stages at
// least); the ring's stages (as many as fit, at most kFwdMaxStages) of
// stage_bytes each; the bytes to ask for. Besides the ring and w: a 64 x NW
// y staging tile per consumer warpgroup, the sums [consumer warp][s1,
// s2][NW] fp32, the barriers, and 1024 bytes of alignment.
struct FwdPlan {
  int nw, resident, stages, stage_bytes, smem;
};

inline FwdPlan fwd_plan(int K, int N) {
  FwdPlan p;
  p.nw = width(N);
  const int fixed = 1024 + 2 * p.nw / kBox * kBoxBytes + 16 * p.nw * 4 + (2 * kFwdMaxStages + 1) * 8;
  const int x_bytes = 2 * kBoxBytes, wblock = p.nw / kBox * kBoxBytes, w_bytes = cdiv(K, kBox) * wblock;
  p.resident = fixed + w_bytes + 2 * x_bytes <= kSmemCap;
  p.stage_bytes = x_bytes + (p.resident ? 0 : wblock);
  const int room = kSmemCap - fixed - (p.resident ? w_bytes : 0);
  p.stages = room / p.stage_bytes < kFwdMaxStages ? room / p.stage_bytes : kFwdMaxStages;
  p.smem = fixed + (p.resident ? w_bytes : 0) + p.stages * p.stage_bytes;
  return p;
}

// CTA blockIdx.x = (group, chunk): columns n0 = (blockIdx.x % chunks) * NW
// of N, 128-row tiles group, group + groups, ... with groups = gridDim.x /
// chunks. xmap: (M, K); wmap: (K, N); ymap: (M, N); 64 x 64 boxes. A stage
// holds the tile's two x boxes and, unless RES, the k-block's NW / 64 w
// boxes; with RES all of w's chunk is loaded once. part (groups, 2, N): the
// CTA's s1/s2 partial row at its columns.
template <int NW, bool APPLY, bool RES>
__global__ void __launch_bounds__(kCtaThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap ymap, const float* __restrict__ mul,
               const float* __restrict__ add, float* __restrict__ part, int M, int K, int N, int stages) {
  constexpr int kWb = NW / kBox;  // w boxes of a k-block: 64 rows of K x 64 columns of N each
  const int nkb = cdiv(K, kBox), stage_bytes = (RES ? 2 : 2 + kWb) * kBoxBytes;
  unsigned char* ring = smem_base();
  unsigned char* w_s = ring + stages * stage_bytes;  // resident w: k-block kb at kb * kWb boxes
  unsigned char* staging = w_s + (RES ? nkb * kWb * kBoxBytes : 0);  // a y tile per consumer warpgroup
  float* red = reinterpret_cast<float*>(staging + 2 * kWb * kBoxBytes);  // [consumer warp][s1, s2][column]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 16 * NW);
  uint64_t* empty = full + stages;
  uint64_t* wbar = empty + stages;

  const int chunks = cdiv(N, NW), groups = gridDim.x / chunks;
  const int group = blockIdx.x / chunks, n0 = (blockIdx.x % chunks) * NW;
  const int tiles = cdiv(M, kTileRows);
  const int mine = tiles > group ? (tiles - 1 - group) / groups + 1 : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(wbar, 1);
    fence_barrier_init();
  }
  for (int i = tid; i < 16 * NW; i += kCtaThreads) red[i] = 0.f;
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == 0) {
      if (RES) {
        mbar_arrive_expect_tx(wbar, nkb * kWb * kBoxBytes);
        for (int kb = 0; kb < nkb; ++kb)
          for (int q = 0; q < kWb; ++q)  // rows k, 64 columns n: MN-major B
            tma_load_2d(w_s + (kb * kWb + q) * kBoxBytes, &wmap, wbar, n0 + q * kBox, kb * kBox);
      }
      int st = 0, phase = 0;
      for (int i = 0; i < mine; ++i) {
        const int r0 = (group + i * groups) * kTileRows;
        for (int kb = 0; kb < nkb; ++kb) {
          unsigned char* stage = ring + st * stage_bytes;
          mbar_wait(&empty[st], phase ^ 1);
          mbar_arrive_expect_tx(&full[st], stage_bytes);
          for (int h = 0; h < 2; ++h)
            tma_load_2d(stage + h * kBoxBytes, &xmap, &full[st], kb * kBox, r0 + h * kBox);
          if (!RES)
            for (int q = 0; q < kWb; ++q)
              tma_load_2d(stage + (2 + q) * kBoxBytes, &wmap, &full[st], n0 + q * kBox, kb * kBox);
          if (++st == stages) st = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, wtid = ctid & 127, warp = ctid >> 5, wq = warp & 3;
  const int lane = tid & 31, gq = lane >> 2, tig = lane & 3;
  unsigned char* ytile = staging + wg * kWb * kBoxBytes;
  // This thread's share of the prologue: chunk pc of rows prow + 16 e of its
  // warpgroup's x box, all in one column block.
  const int pc = wtid & 7, prow = wtid >> 3, pcol = chunk_col(prow, pc);
  float acc[NW / 2];
  int st = 0, phase = 0, prev = 0;
  if (RES) mbar_wait(wbar, 0);
  for (int i = 0; i < mine; ++i) {
    const int r0 = (group + i * groups) * kTileRows + wg * kBox;  // this warpgroup's rows
#pragma unroll
    for (int q = 0; q < NW / 2; ++q) acc[q] = 0.f;
    for (int kb = 0; kb < nkb; ++kb) {
      unsigned char* stage = ring + st * stage_bytes;
      unsigned char* xb = stage + wg * kBoxBytes;
      const unsigned char* wb = RES ? w_s + kb * kWb * kBoxBytes : stage + 2 * kBoxBytes;
      mbar_wait(&full[st], phase);
      if (APPLY) {  // a in place over the x box
        const int c = kb * kBox + pcol;
        float m[8], ad[8];
        if (c < K) load8(mul + c, m), load8(add + c, ad);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = prow + 16 * e;
          uint4* v = reinterpret_cast<uint4*>(xb + r * 128 + pc * 16);
          *v = c < K && r0 + r < M ? prologue8(*v, m, ad) : make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        named_barrier(2 + wg, 128);
      }
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_ss<NW, 0, 1>(acc, desc_sw128(xb + ks * 32, 16, 1024), desc_sw128(wb + ks * 2048, kBoxBytes, 1024));
      wgmma_commit();
      // Keep this stage's products in flight while the next stage is
      // waited for and rewritten; the previous stage's are done: free it.
      wgmma_wait<1>();
      fence_acc(acc);
      if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = st;
      if (++st == stages) st = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // Epilogue: y = bf16(acc) into the staging tile (once the last tile's
    // stores are done reading it) and out by TMA stores, which clip rows
    // past M and columns past N, one 64-column box at a time; s1/s2 of the
    // box's columns added to the warp's slots. Rows past M and columns past
    // N hold exact zeros (a's rows, w's columns), so they add nothing.
    if (wtid == 0) bulk_wait_read<0>();
    named_barrier(2 + wg, 128);
#pragma unroll
    for (int q = 0; q < kWb; ++q) {
      unsigned char* box = ytile + q * kBoxBytes;
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        float sums[8];  // per chunk j, j + 1: colsum(y) at two columns, then colsum(y^2)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int ci = 8 * q + j + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wq * 16 + gq + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(box + r * 128 + (((j + jj) ^ (r & 7)) << 4) + 4 * tig) =
                __floats2bfloat162_rn(acc[4 * ci + 2 * h], acc[4 * ci + 2 * h + 1]);
          }
          const float d0 = acc[4 * ci], d1 = acc[4 * ci + 1], d2 = acc[4 * ci + 2], d3 = acc[4 * ci + 3];
          sums[4 * jj] = d0 + d2, sums[4 * jj + 1] = d1 + d3;
          sums[4 * jj + 2] = d0 * d0 + d2 * d2, sums[4 * jj + 3] = d1 * d1 + d3 * d3;
        }
        stage_colsums<true>(red, NW, warp, 8 * q + j, lane, sums);
      }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (wtid == 0) tma_store_2d(&ymap, box, n0 + q * kBox, r0);
    }
    if (wtid == 0) bulk_commit();
  }
  if (wtid == 0) bulk_wait<0>();
  write_colsums(red, NW, ctid, part, group, n0, N);  // the 8 warps' sums in warp order
}

template <int NW, bool APPLY, bool RES>
int launch_fwd_k(const FwdPlan& p, const CUtensorMap& xmap, const CUtensorMap& wmap, const CUtensorMap& ymap,
                 const float* mul, const float* add, float* part, int groups, int M, int K, int N,
                 cudaStream_t st) {
  auto kern = fwd_kernel<NW, APPLY, RES>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<groups * cdiv(N, NW), kCtaThreads, p.smem, st>>>(xmap, wmap, ymap, mul, add, part, M, K, N, p.stages);
  return (int)cudaGetLastError();
}

template <bool APPLY, bool RES>
int launch_fwd_w(const FwdPlan& p, const CUtensorMap& xmap, const CUtensorMap& wmap, const CUtensorMap& ymap,
                 const float* mul, const float* add, float* part, int groups, int M, int K, int N,
                 cudaStream_t st) {
  if (p.nw == 64) return launch_fwd_k<64, APPLY, RES>(p, xmap, wmap, ymap, mul, add, part, groups, M, K, N, st);
  if (p.nw == 128) return launch_fwd_k<128, APPLY, RES>(p, xmap, wmap, ymap, mul, add, part, groups, M, K, N, st);
  return launch_fwd_k<256, APPLY, RES>(p, xmap, wmap, ymap, mul, add, part, groups, M, K, N, st);
}

template <bool APPLY>
int launch_fwd_r(const FwdPlan& p, const CUtensorMap& xmap, const CUtensorMap& wmap, const CUtensorMap& ymap,
                 const float* mul, const float* add, float* part, int groups, int M, int K, int N,
                 cudaStream_t st) {
  return p.resident ? launch_fwd_w<APPLY, true>(p, xmap, wmap, ymap, mul, add, part, groups, M, K, N, st)
                    : launch_fwd_w<APPLY, false>(p, xmap, wmap, ymap, mul, add, part, groups, M, K, N, st);
}

// x (M, K), w (K, N), y (M, N) bf16; mul, add (K,) fp32 or both null.
// Scratch: part (parts, 2, N) fp32 with parts = row_groups(M, N, sms). Out:
// s (2, N) fp32 = [s1; s2]. Returns 0, a CUresult of a tensor-map encoding
// or the first cudaError_t of the launches (cudaErrorInvalidValue for a
// wrong parts).
inline int launch_fwd(const void* x, const void* w, const float* mul, const float* add, void* y, float* part,
                      int parts, float* s, int M, int K, int N, cudaStream_t st) {
  if (parts != row_groups(M, N, sm_count())) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap, ymap;
  int err = tmap_matrix(&xmap, x, M, K);
  if (!err) err = tmap_matrix(&wmap, w, K, N);
  if (!err) err = tmap_matrix(&ymap, y, M, N);
  if (err) return err;
  const FwdPlan p = fwd_plan(K, N);
  err = mul ? launch_fwd_r<true>(p, xmap, wmap, ymap, mul, add, part, parts, M, K, N, st)
            : launch_fwd_r<false>(p, xmap, wmap, ymap, mul, add, part, parts, M, K, N, st);
  if (err) return err;
  cbn::reduce_rows<<<cbn::ceil_div(2 * N, 32), dim3(32, 8), 0, st>>>(part, parts, 2 * N, s);
  return (int)cudaGetLastError();
}

// --- 1. dx and the dmul/dadd partials ------------------------------------------

// Shared memory of da_kernel<NW>: the ring, each consumer warpgroup's 64 x NW
// staging tile (x in, dx out), the barriers, and the column sums and
// mul/add of the CTA's columns.
template <int NW>
struct DaSmem {
  static constexpr int kStage = NW / kBox * kBoxBytes;  // one warpgroup's staging tile
  using R = Ring<4 + NW / kBox, kRingCap - 2 * kStage>;  // y, dy (two boxes each), the w block
  static constexpr int kBytes = 1024 + R::kRing + 2 * kStage + R::kBars + 2 * 8 + 18 * NW * 4;
};

// CTA blockIdx.x = (group, K range): K range blockIdx.x % ranges of NW
// columns, 128-row tiles group, group + groups, ... with groups = gridDim.x /
// ranges. ymap, dymap: (M, N); wmap: (K, N); xmap, dxmap: (M, K); 64 x 64
// boxes. part (groups, 2, K): the dmul/dadd partial rows (with APPLY).
template <int NW, bool APPLY>
__global__ void __launch_bounds__(kCtaThreads, 1)
    da_kernel(const __grid_constant__ CUtensorMap ymap, const __grid_constant__ CUtensorMap dymap,
              const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap dxmap, const float* __restrict__ ds,
              const float* __restrict__ mul, const float* __restrict__ add, float* __restrict__ part,
              int M, int K, int N) {
  using S = DaSmem<NW>;
  using R = typename S::R;
  unsigned char* ring = smem_base();
  unsigned char* staging = ring + R::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * S::kStage);
  uint64_t* empty = full + R::kStages;
  uint64_t* xbar = empty + R::kStages;  // per consumer warpgroup: its x tile has landed
  float* red = reinterpret_cast<float*>(xbar + 2);  // [consumer warp][dmul, dadd][column]
  float* col_mul = red + 16 * NW;
  float* col_add = col_mul + NW;

  const int ranges = cdiv(K, NW), groups = gridDim.x / ranges;
  const int group = blockIdx.x / ranges, c0 = (blockIdx.x % ranges) * NW;
  const int tiles = cdiv(M, kTileRows), nsteps = cdiv(N, kBox);
  const int mine = tiles > group ? (tiles - 1 - group) / groups + 1 : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(&xbar[0], 1);
    mbar_init(&xbar[1], 1);
    fence_barrier_init();
  }
  if (APPLY) {
    for (int i = tid; i < 16 * NW; i += kCtaThreads) red[i] = 0.f;
    for (int i = tid; i < NW; i += kCtaThreads) {
      col_mul[i] = c0 + i < K ? __ldg(mul + c0 + i) : 0.f;
      col_add[i] = c0 + i < K ? __ldg(add + c0 + i) : 0.f;
    }
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load of the ring
    setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int s = 0; s < mine * nsteps; ++s) {
        const int st = s % R::kStages, r0 = (group + s / nsteps * groups) * kTileRows;
        const int n0 = s % nsteps * kBox;
        unsigned char* stage = ring + st * R::kStageBytes;
        mbar_wait(&empty[st], ((s / R::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], R::kStageBytes);
        for (int h = 0; h < 2; ++h) {
          tma_load_2d(stage + h * kBoxBytes, &ymap, &full[st], n0, r0 + h * kBox);
          tma_load_2d(stage + (2 + h) * kBoxBytes, &dymap, &full[st], n0, r0 + h * kBox);
        }
        for (int q = 0; q < NW / kBox; ++q)  // rows c of w, 64 columns n: K-major B
          tma_load_2d(stage + (4 + q) * kBoxBytes, &wmap, &full[st], n0, c0 + q * kBox);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, wtid = ctid & 127, warp = ctid >> 5, lane = tid & 31;
  unsigned char* mine_st = staging + wg * S::kStage;  // this warpgroup's 64 rows x NW columns
  float acc[NW / 2];
  int s = 0;
  for (int i = 0; i < mine; ++i) {
    const int r0 = (group + i * groups) * kTileRows + wg * kBox;  // this warpgroup's rows
    if (wtid == 0) {  // the staging tile is free once the last tile's dx store has read it
      bulk_wait_read<0>();
      if (APPLY) {
        mbar_arrive_expect_tx(&xbar[wg], S::kStage);
        for (int q = 0; q < NW / kBox; ++q)
          tma_load_2d(mine_st + q * kBoxBytes, &xmap, &xbar[wg], c0 + q * kBox, r0);
      }
    }
    for (int j = 0; j < nsteps; ++j, ++s) {
      const int st = s % R::kStages;
      unsigned char* stage = ring + st * R::kStageBytes;
      const unsigned char* yb = stage + wg * kBoxBytes;
      unsigned char* gb = stage + (2 + wg) * kBoxBytes;
      mbar_wait(&full[st], (s / R::kStages) & 1);
      // gc over this warpgroup's dy box, in place: 512 chunks of 8, 4 a
      // thread, rows wtid / 8 + 16 e of chunk wtid % 8, so one column block.
      {
        const int pc = wtid & 7, n = j * kBox + chunk_col(wtid >> 3, pc);
        float d1[8], d2[8];
        if (n < N) load8(ds + n, d1), load8(ds + N + n, d2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = ((wtid >> 3) + 16 * e) * 128 + pc * 16;
          uint4* g = reinterpret_cast<uint4*>(gb + off);
          *g = n < N ? gc8(*reinterpret_cast<const uint4*>(yb + off), *g, d1, d2) : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (j == 0) {
#pragma unroll
        for (int q = 0; q < NW / 2; ++q) acc[q] = 0.f;
      }
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_ss<NW, 0, 0>(acc, desc_sw128(gb + ks * 32, 16, 1024),
                         desc_sw128(stage + 4 * kBoxBytes + ks * 32, 16, 1024));
      wgmma_commit();
      // The products are short beside the stage's bytes: wait for them and
      // free the slot at once, so the producer refills it while this
      // warpgroup forms the next stage's gc.
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // Epilogue in the staging tile (x in, dx out in place). Without the
    // prologue the tile is free already: thread 0 saw the last dx store read
    // it before the step barriers above.
    if (APPLY) mbar_wait(&xbar[wg], i & 1);
    dx_epilogue<NW, APPLY>(mine_st, acc, col_mul, col_add, red + warp * 2 * NW, r0, c0, M, K);
    // dx by TMA: rows past M and columns past K are not written.
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if (wtid == 0) {
      for (int q = 0; q < NW / kBox; ++q) tma_store_2d(&dxmap, mine_st + q * kBoxBytes, c0 + q * kBox, r0);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait<0>();
  if (APPLY) {  // the 8 warps' sums in warp order: this CTA's partial row
    named_barrier(1, kConsumerThreads);
    const int c = c0 + ctid;
    if (ctid < NW && c < K) {
      float u = red[ctid], v = red[NW + ctid];
      for (int w = 1; w < 8; ++w) u += red[w * 2 * NW + ctid], v += red[w * 2 * NW + NW + ctid];
      part[(size_t)group * 2 * K + c] = u;
      part[(size_t)group * 2 * K + K + c] = v;
    }
  }
}

// --- 2. dw partials ----------------------------------------------------------------

// CTA (128 channels of K, NW columns of N) = blockIdx.x, range blockIdx.y of
// the 64-row tiles. xmap: (M, K); ymap, dymap: (M, N). Writes part[range]
// (K x N fp32) in its block.
template <int NW, bool APPLY>
__global__ void __launch_bounds__(kCtaThreads, 1)
    dw_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
              const __grid_constant__ CUtensorMap dymap, const float* __restrict__ ds,
              const float* __restrict__ mul, const float* __restrict__ add, float* __restrict__ part,
              int M, int K, int N) {
  constexpr int kNb = NW / kBox;  // y (and dy) boxes per stage
  using R = Ring<2 + 2 * kNb>;    // x (two boxes), y, dy
  unsigned char* ring = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::kStages * R::kStageBytes);
  uint64_t* empty = full + R::kStages;

  const int nblocks = cdiv(N, NW);
  const int n0 = (blockIdx.x % nblocks) * NW, c0 = (blockIdx.x / nblocks) * 2 * kBox;
  const long long tiles = cdiv(M, kBox);
  const int first = (int)(tiles * blockIdx.y / gridDim.y);
  const int steps = (int)(tiles * (blockIdx.y + 1) / gridDim.y) - first;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
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
        const int st = s % R::kStages, r0 = (first + s) * kBox;
        unsigned char* stage = ring + st * R::kStageBytes;
        mbar_wait(&empty[st], ((s / R::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], R::kStageBytes);
        for (int h = 0; h < 2; ++h)
          tma_load_2d(stage + h * kBoxBytes, &xmap, &full[st], c0 + h * kBox, r0);
        for (int q = 0; q < kNb; ++q) {
          tma_load_2d(stage + (2 + q) * kBoxBytes, &ymap, &full[st], n0 + q * kBox, r0);
          tma_load_2d(stage + (2 + kNb + q) * kBoxBytes, &dymap, &full[st], n0 + q * kBox, r0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, wq = (ctid >> 5) & 3;
  const int lane = tid & 31, gq = lane >> 2, tig = lane & 3;
  float acc[NW / 2];
#pragma unroll
  for (int q = 0; q < NW / 2; ++q) acc[q] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int st = s % R::kStages, r0 = (first + s) * kBox;
    unsigned char* stage = ring + st * R::kStageBytes;
    unsigned char* gb = stage + (2 + kNb) * kBoxBytes;
    mbar_wait(&full[st], (s / R::kStages) & 1);
    // gc over the dy boxes and, with the prologue, a over the x boxes in place.
    form_gc_a<kNb, 2, APPLY>(stage + 2 * kBoxBytes, gb, n0, stage, stage, c0, r0, ctid, ds, mul, add, M, K, N);
    fence_acc(acc);
    wgmma_fence();
    // dw[c, n] += sum over the tile's rows p of a[p, c] gc[p, n]: A is this
    // warpgroup's a box read M-major, B the gc boxes MN-major.
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      mma_ss<NW, 1, 1>(acc, desc_sw128(stage + wg * kBoxBytes + ks * 2048, kBoxBytes, 1024),
                       desc_sw128(gb + ks * 2048, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();  // short beside the stage's bytes: free the slot at once
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  float* out = part + (size_t)blockIdx.y * K * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + wg * kBox + wq * 16 + gq + 8 * h;
    if (c >= K) continue;
#pragma unroll
    for (int i = 0; i < NW / 8; ++i) {
      const int n = n0 + 8 * i + 2 * tig;
      if (n < N)
        *reinterpret_cast<float2*>(out + (size_t)c * N + n) = make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

// --- 3. one pass, where dw fits one warpgroup's registers -------------------------

// Whether one_pass_kernel takes (K, N): it covers all of K and N (each at
// most 256, width() stops there) and dw, width(K) x width(N) fp32, fits one
// consumer warpgroup's registers (at most 128 a thread).
__host__ __device__ constexpr bool one_pass(int K, int N) {
  return K <= 256 && N <= 256 && width(K) * width(N) <= 128 * 128;
}

// Ranges of 64-row tiles of one_pass_kernel: one CTA per SM, at most one
// per tile.
inline int one_pass_ranges(int M, int sms) {
  const int tiles = cdiv(M, kBox);
  return sms < tiles ? sms : tiles;
}

// Shared memory of one_pass_kernel<KW, NW>: the ring, w (resident), the
// barriers, and the column sums and mul/add of WG 0. A stage is the 64-row
// tile's x (KW / 64 boxes), y and dy (NW / 64 boxes each), and an aux slot
// of KW / 64 boxes: a with the prologue (dx is then written over x), else
// dx (a is x itself).
template <int KW, int NW>
struct OneSmem {
  static constexpr int kKb = KW / kBox, kNb = NW / kBox;
  static constexpr int kW = kKb * kNb * kBoxBytes;
  using R = Ring<2 * kKb + 2 * kNb, 200 * 1024 - kW>;
  static constexpr int kBytes = 1024 + R::kRing + kW + R::kBars + 8 + 10 * KW * 4;
};

// One CTA per range blockIdx.x of the 64-row tiles. Per tile, consumer
// warpgroup 0 runs da = gc @ w^T (wgmma m64nKWk16, gc K-major, w resident
// K-major) and the dx epilogue (dx out by TMA store from the stage), and
// warpgroup 1 adds a^T gc to dw (KW / 64 wgmma m64nNWk16, a M-major, gc
// MN-major) in its registers. xmap, dxmap: (M, K); ymap, dymap: (M, N);
// wmap: (K, N). part_x (ranges, 2, K): dmul/dadd partial rows (with APPLY);
// part_w (ranges, K, N): dw partials.
template <int KW, int NW, bool APPLY>
__global__ void __launch_bounds__(kCtaThreads, 1)
    one_pass_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
                    const __grid_constant__ CUtensorMap dymap, const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap dxmap, const float* __restrict__ ds,
                    const float* __restrict__ mul, const float* __restrict__ add, float* __restrict__ part_x,
                    float* __restrict__ part_w, int M, int K, int N) {
  using S = OneSmem<KW, NW>;
  using R = typename S::R;
  constexpr int kKb = S::kKb, kNb = S::kNb;
  unsigned char* ring = smem_base();
  unsigned char* w_s = ring + R::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(w_s + S::kW);
  uint64_t* empty = full + R::kStages;
  uint64_t* wbar = empty + R::kStages;
  float* red = reinterpret_cast<float*>(wbar + 1);  // [warp of WG 0][dmul, dadd][column]
  float* col_mul = red + 8 * KW;
  float* col_add = col_mul + KW;

  const long long tiles = cdiv(M, kBox);
  const int first = (int)(tiles * blockIdx.x / gridDim.x);
  const int steps = (int)(tiles * (blockIdx.x + 1) / gridDim.x) - first;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(wbar, 1);
    fence_barrier_init();
  }
  if (APPLY) {
    for (int i = tid; i < 8 * KW; i += kCtaThreads) red[i] = 0.f;
    for (int i = tid; i < KW; i += kCtaThreads) {
      col_mul[i] = i < K ? __ldg(mul + i) : 0.f;
      col_add[i] = i < K ? __ldg(add + i) : 0.f;
    }
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(wbar, S::kW);
      for (int q = 0; q < kNb; ++q)  // rows c, 64 columns n: K-major B of da
        for (int cb = 0; cb < kKb; ++cb)
          tma_load_2d(w_s + (q * kKb + cb) * kBoxBytes, &wmap, wbar, q * kBox, cb * kBox);
      for (int s = 0; s < steps; ++s) {
        const int st = s % R::kStages, r0 = (first + s) * kBox;
        unsigned char* stage = ring + st * R::kStageBytes;
        mbar_wait(&empty[st], ((s / R::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], (kKb + 2 * kNb) * kBoxBytes);
        for (int cb = 0; cb < kKb; ++cb)
          tma_load_2d(stage + cb * kBoxBytes, &xmap, &full[st], cb * kBox, r0);
        for (int q = 0; q < kNb; ++q) {
          tma_load_2d(stage + (kKb + q) * kBoxBytes, &ymap, &full[st], q * kBox, r0);
          tma_load_2d(stage + (kKb + kNb + q) * kBoxBytes, &dymap, &full[st], q * kBox, r0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wtid = ctid & 127, warp = ctid >> 5, wq = warp & 3;
  const int lane = tid & 31, gq = lane >> 2, tig = lane & 3;
  if (ctid < 128) {  // warpgroup 0: da and dx
    mbar_wait(wbar, 0);
    for (int s = 0; s < steps; ++s) {
      const int st = s % R::kStages, r0 = (first + s) * kBox;
      unsigned char* stage = ring + st * R::kStageBytes;
      mbar_wait(&full[st], (s / R::kStages) & 1);
      form_gc_a<kNb, kKb, APPLY>(stage + kKb * kBoxBytes, stage + (kKb + kNb) * kBoxBytes, 0, stage,
                                 stage + (kKb + 2 * kNb) * kBoxBytes, 0, r0, ctid, ds, mul, add, M, K, N);
      const unsigned char* gb = stage + (kKb + kNb) * kBoxBytes;
      float acc[KW / 2];
#pragma unroll
      for (int q = 0; q < KW / 2; ++q) acc[q] = 0.f;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < kNb; ++q)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          mma_ss<KW, 0, 0>(acc, desc_sw128(gb + q * kBoxBytes + ks * 32, 16, 1024),
                           desc_sw128(w_s + q * kKb * kBoxBytes + ks * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);

      // dx over x with the prologue, else into aux.
      unsigned char* dxb = APPLY ? stage : stage + (kKb + 2 * kNb) * kBoxBytes;
      dx_epilogue<KW, APPLY>(dxb, acc, col_mul, col_add, red + warp * 2 * KW, r0, 0, M, K);
      fence_proxy_async();
      named_barrier(2, 128);
      if (wtid == 0) {  // dx by TMA (rows past M, columns past K not written); then the slot is free
        for (int cb = 0; cb < kKb; ++cb) tma_store_2d(&dxmap, dxb + cb * kBoxBytes, cb * kBox, r0);
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(&empty[st]);
      }
    }
    if (wtid == 0) bulk_wait<0>();
    if (APPLY) {  // the 4 warps' sums in warp order: this CTA's partial row
      named_barrier(2, 128);
      for (int c = wtid; c < KW && c < K; c += 128) {
        float u = red[c], v = red[KW + c];
        for (int w = 1; w < 4; ++w) u += red[w * 2 * KW + c], v += red[w * 2 * KW + KW + c];
        part_x[(size_t)blockIdx.x * 2 * K + c] = u;
        part_x[(size_t)blockIdx.x * 2 * K + K + c] = v;
      }
    }
  } else {  // warpgroup 1: dw
    float acc[kKb][NW / 2];
#pragma unroll
    for (int mb = 0; mb < kKb; ++mb)
#pragma unroll
      for (int q = 0; q < NW / 2; ++q) acc[mb][q] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const int st = s % R::kStages, r0 = (first + s) * kBox;
      unsigned char* stage = ring + st * R::kStageBytes;
      mbar_wait(&full[st], (s / R::kStages) & 1);
      form_gc_a<kNb, kKb, APPLY>(stage + kKb * kBoxBytes, stage + (kKb + kNb) * kBoxBytes, 0, stage,
                                 stage + (kKb + 2 * kNb) * kBoxBytes, 0, r0, ctid, ds, mul, add, M, K, N);
      const unsigned char* ab = APPLY ? stage + (kKb + 2 * kNb) * kBoxBytes : stage;
      const unsigned char* gb = stage + (kKb + kNb) * kBoxBytes;
#pragma unroll
      for (int mb = 0; mb < kKb; ++mb) fence_acc(acc[mb]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int mb = 0; mb < kKb; ++mb)
          mma_ss<NW, 1, 1>(acc[mb], desc_sw128(ab + mb * kBoxBytes + ks * 2048, kBoxBytes, 1024),
                           desc_sw128(gb + ks * 2048, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < kKb; ++mb) fence_acc(acc[mb]);
      if (wtid == 0) mbar_arrive(&empty[st]);
    }
    float* out = part_w + (size_t)blockIdx.x * K * N;
#pragma unroll
    for (int mb = 0; mb < kKb; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = mb * kBox + wq * 16 + gq + 8 * h;
        if (c >= K) continue;
#pragma unroll
        for (int i = 0; i < NW / 8; ++i) {
          const int n = 8 * i + 2 * tig;
          if (n < N)
            *reinterpret_cast<float2*>(out + (size_t)c * N + n) =
                make_float2(acc[mb][4 * i + 2 * h], acc[mb][4 * i + 2 * h + 1]);
        }
      }
  }
}

// --- launchers -----------------------------------------------------------------------

template <int NW, bool APPLY>
int launch_da(const CUtensorMap& ymap, const CUtensorMap& dymap, const CUtensorMap& wmap,
              const CUtensorMap& xmap, const CUtensorMap& dxmap, const float* ds, const float* mul,
              const float* add, float* part, int groups, int M, int K, int N, cudaStream_t st) {
  constexpr int smem = DaSmem<NW>::kBytes;
  auto kern = da_kernel<NW, APPLY>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<groups * cdiv(K, NW), kCtaThreads, smem, st>>>(ymap, dymap, wmap, xmap, dxmap, ds, mul, add, part,
                                                      M, K, N);
  return (int)cudaGetLastError();
}

template <int NW, bool APPLY>
int launch_dw(const CUtensorMap& xmap, const CUtensorMap& ymap, const CUtensorMap& dymap,
              const float* ds, const float* mul, const float* add, float* part, int ranges, int M,
              int K, int N, cudaStream_t st) {
  using R = Ring<2 + 2 * NW / kBox>;
  constexpr int smem = 1024 + R::kRing + R::kBars;
  auto kern = dw_kernel<NW, APPLY>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(cdiv(K, 2 * kBox) * cdiv(N, NW), ranges), kCtaThreads, smem, st>>>(xmap, ymap, dymap, ds, mul,
                                                                              add, part, M, K, N);
  return (int)cudaGetLastError();
}

template <bool APPLY>
int launch_da_w(int nw, const CUtensorMap& ymap, const CUtensorMap& dymap, const CUtensorMap& wmap,
                const CUtensorMap& xmap, const CUtensorMap& dxmap, const float* ds, const float* mul,
                const float* add, float* part, int groups, int M, int K, int N, cudaStream_t st) {
  if (nw == 64)
    return launch_da<64, APPLY>(ymap, dymap, wmap, xmap, dxmap, ds, mul, add, part, groups, M, K, N, st);
  if (nw == 128)
    return launch_da<128, APPLY>(ymap, dymap, wmap, xmap, dxmap, ds, mul, add, part, groups, M, K, N, st);
  return launch_da<256, APPLY>(ymap, dymap, wmap, xmap, dxmap, ds, mul, add, part, groups, M, K, N, st);
}

template <bool APPLY>
int launch_dw_w(int nw, const CUtensorMap& xmap, const CUtensorMap& ymap, const CUtensorMap& dymap,
                const float* ds, const float* mul, const float* add, float* part, int ranges, int M,
                int K, int N, cudaStream_t st) {
  if (nw == 64) return launch_dw<64, APPLY>(xmap, ymap, dymap, ds, mul, add, part, ranges, M, K, N, st);
  if (nw == 128) return launch_dw<128, APPLY>(xmap, ymap, dymap, ds, mul, add, part, ranges, M, K, N, st);
  return launch_dw<256, APPLY>(xmap, ymap, dymap, ds, mul, add, part, ranges, M, K, N, st);
}

template <int KW, int NW, bool APPLY>
int launch_one(const CUtensorMap& xmap, const CUtensorMap& ymap, const CUtensorMap& dymap,
               const CUtensorMap& wmap, const CUtensorMap& dxmap, const float* ds, const float* mul,
               const float* add, float* part_x, float* part_w, int ranges, int M, int K, int N,
               cudaStream_t st) {
  constexpr int smem = OneSmem<KW, NW>::kBytes;
  auto kern = one_pass_kernel<KW, NW, APPLY>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<ranges, kCtaThreads, smem, st>>>(xmap, ymap, dymap, wmap, dxmap, ds, mul, add, part_x, part_w, M, K, N);
  return (int)cudaGetLastError();
}

template <bool APPLY>
int launch_one_w(int kw, int nw, const CUtensorMap& xmap, const CUtensorMap& ymap,
                 const CUtensorMap& dymap, const CUtensorMap& wmap, const CUtensorMap& dxmap,
                 const float* ds, const float* mul, const float* add, float* part_x, float* part_w,
                 int ranges, int M, int K, int N, cudaStream_t st) {
#define MBH_ONE(KW, NW)                                                                                  \
  if (kw == KW && nw == NW)                                                                              \
    return launch_one<KW, NW, APPLY>(xmap, ymap, dymap, wmap, dxmap, ds, mul, add, part_x, part_w, ranges, \
                                     M, K, N, st);
  MBH_ONE(64, 64) MBH_ONE(64, 128) MBH_ONE(128, 64) MBH_ONE(128, 128) MBH_ONE(64, 256) MBH_ONE(256, 64)
#undef MBH_ONE
  return (int)cudaErrorInvalidValue;
}

// Partial rows of one backward call on a card of `sms` SMs: dmul/dadd
// (parts_x) and dw (parts_w).
inline int dx_partials(int M, int K, int N, int sms) {
  return one_pass(K, N) ? one_pass_ranges(M, sms) : row_groups(M, K, sms);
}
inline int dw_partials(int M, int K, int N, int sms) {
  return one_pass(K, N) ? one_pass_ranges(M, sms) : dw_ranges(M, K, N, sms);
}

// x (M, K), w (K, N), y, dy (M, N) bf16; mul, add (K,) fp32 or both null; ds
// (2, N) fp32. Scratch: part_x (parts_x, 2, K) fp32 with parts_x =
// dx_partials(M, K, N, sms) (written with mul only), part_w (parts_w, K, N)
// fp32 with parts_w = dw_partials(M, K, N, sms). Out: dx (M, K) bf16, dw (K, N)
// fp32, dmd (2, K) fp32 = [dmul; dadd] (with mul). Returns 0, a CUresult of
// a tensor-map encoding or the first cudaError_t of the launches
// (cudaErrorInvalidValue for wrong partial counts).
inline int launch_bwd(const void* x, const void* w, const float* mul, const float* add, const void* y,
                      const void* dy, const float* ds, void* dx, float* dw, float* dmd, float* part_x,
                      int parts_x, float* part_w, int parts_w, int M, int K, int N, cudaStream_t st) {
  const int sms = sm_count();
  if (parts_x != dx_partials(M, K, N, sms) || parts_w != dw_partials(M, K, N, sms))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, dxmap, wmap, ymap, dymap;
  int err = tmap_matrix(&xmap, x, M, K);
  if (!err) err = tmap_matrix(&dxmap, dx, M, K);
  if (!err) err = tmap_matrix(&wmap, w, K, N);
  if (!err) err = tmap_matrix(&ymap, y, M, N);
  if (!err) err = tmap_matrix(&dymap, dy, M, N);
  if (err) return err;
  if (one_pass(K, N)) {
    err = mul ? launch_one_w<true>(width(K), width(N), xmap, ymap, dymap, wmap, dxmap, ds, mul, add, part_x,
                                   part_w, parts_w, M, K, N, st)
              : launch_one_w<false>(width(K), width(N), xmap, ymap, dymap, wmap, dxmap, ds, mul, add, part_x,
                                    part_w, parts_w, M, K, N, st);
  } else {
    err = mul ? launch_da_w<true>(width(K), ymap, dymap, wmap, xmap, dxmap, ds, mul, add, part_x, parts_x, M, K, N, st)
            : launch_da_w<false>(width(K), ymap, dymap, wmap, xmap, dxmap, ds, mul, add, part_x, parts_x, M, K, N,
                                 st);
    if (err) return err;
    err = mul ? launch_dw_w<true>(width(N), xmap, ymap, dymap, ds, mul, add, part_w, parts_w, M, K, N, st)
              : launch_dw_w<false>(width(N), xmap, ymap, dymap, ds, mul, add, part_w, parts_w, M, K, N, st);
  }
  if (err) return err;
  if (mul) {
    cbn::reduce_rows<<<cbn::ceil_div(2 * K, 32), dim3(32, 8), 0, st>>>(part_x, parts_x, 2 * K, dmd);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  cbn::reduce_rows<<<cbn::ceil_div(K * N, 32), dim3(32, 8), 0, st>>>(part_w, parts_w, K * N, dw);
  return (int)cudaGetLastError();
}

}  // namespace mbh
