// K7-fp32 and K8-fp32, the fused stride-1 SAME 3x3 conv + BatchNorm
// statistics forward and backward for fp32 operands on Hopper (sm_90a): the
// kernels of conv_bn_fwd.cu (replaces ihpr_tpu/ops/conv_bn.py:_fwd_kernel)
// and conv_bn_bwd.cu (replaces ihpr_tpu/ops/conv_bn.py:_bwd_kernel), which
// JAX runs at Precision.HIGHEST for fp32 operands. bf16 operands take
// conv3_hopper.cuh.
//
// What they compute. x (B, H, W, C) NHWC, w (9, C, N) in HWIO tap order t =
// (dy+1)*3 + (dx+1), y and dy (B, H, W, N), all fp32; ds = [ds1; ds2] (2,
// N) fp32; shift_t(a)[i, j] = a[i+dy, j+dx], 0 outside the image (the SAME
// padding). With the prologue mul, add (C,) fp32 and a = relu(x*mul + add)
// (the multiply and the add rounded apart, as the plain version), else a = x.
//   forward (K7-fp32): y = sum_t shift_t(a) @ w_t; s1 = colsum(y), s2 =
//        colsum(y^2), from the fp32 accumulator.
//   backward (K8-fp32): g = (dy + ds1) + (2*y)*ds2 (fp32, the saved y);
//        da = sum_t shift_{-t}(g) @ w_t^T; with the prologue t = da *
//        (x*mul + add > 0), dx = t*mul, dmul = colsum(t*x), dadd =
//        colsum(t); else dx = da; dw_t = shift_t(a)^T @ g.
// Every product is 3xTF32 on wgmma m64n64k8, as K5-fp32 / K6-fp32
// (matmul_bn_f32.cuh): A split in registers (tf32x3.cuh), B from TF32 hi
// and lo planes in shared memory, K-major; ~2^-21 relative a product, fp32
// accumulation.
//
// What bounds them on an H100. The forward reads x and w and writes y once,
// 4(MC + 9CN + MN) bytes, against 18 MCN flops in three TF32 passes at
// 494.7 TFLOP/s: at the conv3 route's fp32 shape, (32, 8, 8, 256) x (9, 256,
// 256), 2.42 GFLOP against 6.6 MB, 0.0147 ms by operations; the backward
// twice the flops (0.0293 ms). v1 (FMA kernels in the mma.sync layout,
// since removed) ran at the FMA units' rate, a third of 3xTF32's, and
// wrote gc (M x N) once to read it twice.
//
// Design. The pixel tiling of conv3_hopper.cuh (c3::Geo): a 4-D TMA box of
// 32 channels x bw columns x bh rows of one image (bw * bh = 64) lands as
// one 64-row x 128-byte swizzled tile (hopper.cuh: tmap_nhwc_f32), exactly
// the layout load_rows reads A from; a tap is the box moved by (dx, dy), and
// pixels outside the image read TMA's zeros.
//   0. split_w_kernel (matmul_bn_f32.cuh, over the nine taps in one launch):
//      w into TF32 hi / lo planes, K-major over each product's contraction,
//      in perm32's order: wt (9, 2, N, Cp) for y (rows n, over C), wn (9, 2,
//      C, Np) for da (rows c, over N). Plain twin: ops/conv_bn.py:split_planes.
//   1. gemm_kernel<true> (y): CTAs of a producer warp (TMA) and two consumer
//      warpgroups over 128-pixel tiles (two boxes, one a warpgroup: box
//      tiles 2i and 2i + 1 of conv3_hopper.cuh's image-major order, so an
//      8 x 8 image is one box and no box runs past H) x 64 columns of N,
//      each CTA a strided set of tiles, as K5-fp32. A stage is one
//      (tap, 32-channel block): the two shifted x boxes and the tap's wt hi /
//      lo blocks; 9 x ceil(C/32) stages a tile in a 6-deep ring. Each thread
//      applies the prologue to its rows' values in registers and zeroes
//      every pixel whose shifted source lies outside the image (TMA's zeros
//      there would become relu(add)), splits them and issues 4 k-steps x 3
//      wgmmas; a never reaches memory. Epilogue: y by float2 stores and the
//      s1/s2 sums from the accumulator, box rows outside the image masked
//      from both (their 3x3 halo reaches valid pixels, so they are not
//      zero); one partial row per CTA (hopper.cuh: stage_colsums).
//   2. g_kernel: g = (dy + ds1) + (2*y)*ds2 once into an (M, N) scratch, read
//      nine times by da (TMA's zeros outside the image are g's padding) and
//      once by dw.
//   3. gemm_kernel<false> (dx): as 1. over 64 columns of C, A = g's box at the
//      opposite shift, B = the tap's wn blocks; the epilogue reads x at the
//      accumulator's positions for the prologue's backward, stores dx and
//      adds dmul/dadd per (warp, column), one partial row per CTA.
//   4. dw_kernel: one CTA per (tap, 128 channels of C, 64 columns of N,
//      range of box tiles), as K6-fp32's dw_kernel: a stage is the four
//      shifted 32-channel x boxes and the two unshifted g boxes of one box
//      tile; the consumers form g^T's hi and lo planes in shared memory from
//      the g boxes (two buffers, the next tile's formed while this tile's
//      products run), and each warpgroup multiplies a^T (64 channels, read
//      transposed from the x boxes, the prologue recomputed and pixels
//      outside the image zeroed, split in registers) by them. dw stays in
//      registers and is flushed into the CTA's fp32 partial every kFlush
//      tiles (tests/test_torch_fused_bn.py emulates the schedule).
//   5. cbn::reduce_rows adds the partial rows in a fixed order: s1/s2;
//      dmul/dadd; dw.
// Filling the card. At the route's shape (M = 2048) there are 16 pixel
// tiles: 64 CTAs of 128 pixels x 64 columns, about half the SMs, each a
// whole tile's 72 stages; dw 72 CTAs (9 taps x 2 x 4). A 32-wide chunk
// would double the CTAs but also the A reads and splits a flop; splitting
// the nine taps over CTAs would need y partials summed in a pass of their
// own. Neither is done: one TF32 pass in three still takes most of each
// kernel's time (tools/f32_breakdown.py --kernels conv), so the loads and
// the pipeline, not the tensor cores, are what to change first.
// No atomics and a static schedule: results are bitwise the same from run
// to run on one card (the partial counts follow its SM count).
//
// Shapes: any B, H, W; C and N multiples of 8 (TMA's 16-byte pitch).
// Channels past C or N read TMA's zeros; their columns are masked.

#pragma once

#include "conv3_hopper.cuh"
#include "matmul_bn_f32.cuh"

namespace c3f {

using namespace hopper;
using c3::Geo;
using mbf::kBoxF;
using mbf::kConsumerThreads;
using mbf::kCtaThreads;
using mbf::kFlush;
using mbf::kKb;
using mbf::kSmemCap;
using mbf::round32;

constexpr int kCols = kBox;  // output columns of a y / dx CTA: one m64n64 accumulator a warpgroup
constexpr int kDwStages = 3;

// Box tiles of the pixels: conv3_hopper.cuh's image-major tiles of bh rows.
__host__ __device__ inline int boxes(const Geo& g) { return g.tiles(g.bh); }

// Origin of box tile q; one past the batch (all of its pixels read 0 and
// are masked) where q is past the last box.
__device__ __forceinline__ void box_origin(const Geo& g, int q, int& b, int& i0, int& j0) {
  if (q < boxes(g)) {
    g.origin(q, g.bh, b, i0, j0);
  } else {
    b = g.B, i0 = 0, j0 = 0;
  }
}

// Whether pixel (i, j) of image b lies in the tensor.
__device__ __forceinline__ bool inside(const Geo& g, int b, int i, int j) {
  return b < g.B && i >= 0 && i < g.H && j >= 0 && j < g.W;
}

// Row groups (CTAs per chunk of 64 output columns, each writing one partial
// row) of gemm_kernel: about one CTA per SM, at least one, at most one per
// 128-pixel tile.
inline int gemm_groups(const Geo& g, int cols, int sms) {
  const int r = sms / cdiv(cols, kCols), tiles = cdiv(boxes(g), 2);
  return r < 1 ? 1 : (r < tiles ? r : tiles);
}

// Ranges of box tiles dw_kernel splits the pixels into: about one CTA per
// SM, at least one range, at most one tile per range.
inline int dw_ranges(const Geo& g, int C, int N, int sms) {
  const int r = sms / (9 * cdiv(C, 2 * kBox) * cdiv(N, kBox)), tiles = boxes(g);
  return r < 1 ? 1 : (r < tiles ? r : tiles);
}

// --- 2. g ---------------------------------------------------------------------------

// g = (dy + ds1) + (2*y)*ds2 over vecs vectors of 4 (rows of N), each
// multiply and add rounded apart, as the plain version.
__global__ void g_kernel(const float* __restrict__ dy, const float* __restrict__ y, const float* __restrict__ ds,
                         float* __restrict__ g, size_t vecs, int N) {
  for (size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x; v < vecs; v += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(v * 4 % N);
    const float4 d = __ldg(reinterpret_cast<const float4*>(dy) + v), yv = __ldg(reinterpret_cast<const float4*>(y) + v);
    const float4 d1 = __ldg(reinterpret_cast<const float4*>(ds + c)), d2 = __ldg(reinterpret_cast<const float4*>(ds + N + c));
    float4 o;
    o.x = __fadd_rn(__fadd_rn(d.x, d1.x), __fmul_rn(2.f * yv.x, d2.x));
    o.y = __fadd_rn(__fadd_rn(d.y, d1.y), __fmul_rn(2.f * yv.y, d2.y));
    o.z = __fadd_rn(__fadd_rn(d.z, d1.z), __fmul_rn(2.f * yv.z, d2.z));
    o.w = __fadd_rn(__fadd_rn(d.w, d1.w), __fmul_rn(2.f * yv.w, d2.w));
    reinterpret_cast<float4*>(g)[v] = o;
  }
}

// --- 1. / 3. y (FWD) or dx (!FWD) ---------------------------------------------------

using GemmSmem = mbf::Smem<4 * kBoxF, 18 * kCols * 4>;

// CTA blockIdx.x = (group, chunk): output columns col0 = (blockIdx.x %
// chunks) * 64, 128-pixel tiles group, group + groups, ... amap: the NHWC
// map of x (FWD, kc = C) or g (!FWD, kc = N); bmap: the planes (9 x 2,
// ncols, kc rounded up to 32). FWD: out = y (ncols = N), part = s1/s2
// partial rows. !FWD: out = dx (ncols = C); with APPLY the prologue's
// backward from x, mul, add, and part = dmul/dadd partial rows.
template <bool FWD, bool APPLY>
__global__ void __launch_bounds__(kCtaThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap, Geo g, int kc,
                int ncols, float* __restrict__ out, float* __restrict__ part, const float* __restrict__ x,
                const float* __restrict__ mul, const float* __restrict__ add) {
  using S = GemmSmem;
  constexpr int kStageBytes = 4 * kBoxF;
  unsigned char* ring = smem_base();
  float* red = reinterpret_cast<float*>(ring + S::kRing);  // [consumer warp][2][column]
  float* col_mul = red + 16 * kCols;
  float* col_add = col_mul + kCols;
  uint64_t* full = reinterpret_cast<uint64_t*>(col_add + kCols);
  uint64_t* empty = full + S::kStages;

  const int chunks = cdiv(ncols, kCols), groups = gridDim.x / chunks;
  const int group = blockIdx.x / chunks, col0 = (blockIdx.x % chunks) * kCols;
  const int tiles = cdiv(boxes(g), 2), ncb = cdiv(kc, kKb), nkb = 9 * ncb;
  const int mine = tiles > group ? (tiles - 1 - group) / groups + 1 : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  for (int i = tid; i < 16 * kCols; i += kCtaThreads) red[i] = 0.f;
  if (!FWD && APPLY)
    for (int i = tid; i < kCols; i += kCtaThreads) {
      col_mul[i] = col0 + i < ncols ? __ldg(mul + col0 + i) : 0.f;
      col_add[i] = col0 + i < ncols ? __ldg(add + col0 + i) : 0.f;
    }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int s = 0; s < mine * nkb; ++s) {
        const int st = s % S::kStages, tile = group + s / nkb * groups, kb = s % nkb;
        const int t = kb / ncb, k0 = (kb - t * ncb) * kKb;
        const int sy = FWD ? t / 3 - 1 : 1 - t / 3, sx = FWD ? t % 3 - 1 : 1 - t % 3;
        unsigned char* stage = ring + st * kStageBytes;
        mbar_wait(&empty[st], ((s / S::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], kStageBytes);
        for (int h = 0; h < 2; ++h) {
          int b, i0, j0;
          box_origin(g, 2 * tile + h, b, i0, j0);
          tma_load_4d(stage + h * kBoxF, &amap, &full[st], k0, j0 + sx, i0 + sy, b);
        }
        for (int p = 0; p < 2; ++p)  // hi, lo
          tma_load_3d(stage + (2 + p) * kBoxF, &bmap, &full[st], k0, col0, 2 * t + p);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, warp = ctid >> 5, wq = warp & 3;
  const int lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  float acc[32];
  int s = 0;  // the stage counter, as the producer's
  for (int i = 0; i < mine; ++i) {
    // This warpgroup's box and this thread's two rows of it, 16 wq + gq (+ 8):
    // pixel (pi, pj) of image b.
    int b, i0, j0;
    box_origin(g, 2 * (group + i * groups) + wg, b, i0, j0);
    int pi[2], pj[2];
    bool ok[2];
    size_t p[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wq * 16 + gq + 8 * h;
      pi[h] = i0 + r / g.bw, pj[h] = j0 + r % g.bw;
      ok[h] = inside(g, b, pi[h], pj[h]);
      p[h] = ((size_t)b * g.H + pi[h]) * g.W + pj[h];
    }
    f32h::zero(acc);
    const int s0 = s;
    auto fetch = [&](int kb, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
      const int st = (s0 + kb) % S::kStages;
      mbar_wait(&full[st], ((s0 + kb) / S::kStages) & 1);
      float v[2][8];
      mbf::load_rows(ring + st * kStageBytes + wg * kBoxF, wq, gq, t4, v);
      if (FWD) {
        const int t = kb / ncb, c = (kb - t * ncb) * kKb + 8 * t4, dy = t / 3 - 1, dx = t % 3 - 1;
        const bool in[2] = {inside(g, b, pi[0] + dy, pj[0] + dx), inside(g, b, pi[1] + dy, pj[1] + dx)};
        float m[8], ad[8];
        if (APPLY && c < kc) load8(mul + c, m), load8(add + c, ad);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float a = v[h][e];
            if (APPLY) a = c < kc ? fmaxf(__fadd_rn(__fmul_rn(a, m[e]), ad[e]), 0.f) : 0.f;
            v[h][e] = in[h] ? a : 0.f;
          }
      }
      mbf::split_rows(v, ah, al);
    };
    auto issue = [&](int kb, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
      const unsigned char* wb = ring + ((s0 + kb) % S::kStages) * kStageBytes + 2 * kBoxF;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) f32h::mma3<64>(acc, ah[ks], al[ks], f32h::kdesc(wb, ks), f32h::kdesc(wb + kBoxF, ks));
      wgmma_commit();
    };
    auto done = [&](int kb) {
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[(s0 + kb) % S::kStages]);
    };
    mbf::pipelined(nkb, fetch, issue, done);
    s += nkb;

    if (FWD) {
      // y and the sums, box rows outside the image left out of both;
      // columns past N hold exact zeros and are not stored.
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        float sums[8];  // per chunk j, j + 1: colsum(y) at two columns, then colsum(y^2)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float* d = acc + 4 * (j + jj);
          const int c = col0 + 8 * (j + jj) + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (ok[h] && c < ncols)
              *reinterpret_cast<float2*>(out + p[h] * ncols + c) = make_float2(d[2 * h], d[2 * h + 1]);
          const float d0 = ok[0] ? d[0] : 0.f, d1 = ok[0] ? d[1] : 0.f;
          const float d2 = ok[1] ? d[2] : 0.f, d3 = ok[1] ? d[3] : 0.f;
          sums[4 * jj] = d0 + d2, sums[4 * jj + 1] = d1 + d3;
          sums[4 * jj + 2] = d0 * d0 + d2 * d2, sums[4 * jj + 3] = d1 * d1 + d3 * d3;
        }
        stage_colsums<true>(red, kCols, warp, j, lane, sums);
      }
    } else {
      // dx at this thread's rows and column pairs; with the prologue t = da *
      // (x*mul + add > 0), dx = t*mul and the rows' colsum(t*x), colsum(t)
      // added, in tile order, to the warp's slots.
      float* wred = red + warp * 2 * kCols;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 8 * j + 2 * t4, c = col0 + cl;
        const float* d = acc + 4 * j;
        float u0 = 0.f, u1 = 0.f, w0 = 0.f, w1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!ok[h] || c >= ncols) continue;
          float v0 = d[2 * h], v1 = d[2 * h + 1];
          if (APPLY) {
            const float2 xv = *reinterpret_cast<const float2*>(x + p[h] * ncols + c);
            const float m0 = col_mul[cl], m1 = col_mul[cl + 1];
            const float t0 = __fadd_rn(__fmul_rn(xv.x, m0), col_add[cl]) > 0.f ? v0 : 0.f;
            const float t1 = __fadd_rn(__fmul_rn(xv.y, m1), col_add[cl + 1]) > 0.f ? v1 : 0.f;
            u0 += t0 * xv.x, u1 += t1 * xv.y, w0 += t0, w1 += t1;
            v0 = t0 * m0;
            v1 = t1 * m1;
          }
          *reinterpret_cast<float2*>(out + p[h] * ncols + c) = make_float2(v0, v1);
        }
        if (APPLY) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            u0 += __shfl_xor_sync(0xffffffffu, u0, o);
            u1 += __shfl_xor_sync(0xffffffffu, u1, o);
            w0 += __shfl_xor_sync(0xffffffffu, w0, o);
            w1 += __shfl_xor_sync(0xffffffffu, w1, o);
          }
          if (lane < 4) wred[cl] += u0, wred[cl + 1] += u1, wred[kCols + cl] += w0, wred[kCols + cl + 1] += w1;
        }
      }
    }
  }
  if (FWD || APPLY) write_colsums(red, kCols, ctid, part, group, col0, ncols);  // the 8 warps' sums in warp order
}

// --- 4. dw partials -------------------------------------------------------------------

// Shared memory of dw_kernel: the ring (x: four shifted boxes; g: two),
// g^T's planes [buffer][hi, lo][pixel half] (64 columns x 32 pixels a box),
// the barriers.
struct DwSmem {
  static constexpr int kStageBytes = 6 * kBoxF;
  static constexpr int kRing = kDwStages * kStageBytes;
  static constexpr int kPlanes = 2 * 4 * kBoxF;
  static constexpr int kBytes = 1024 + kRing + kPlanes + 2 * kDwStages * 8;
};

// CTA (tap t, 128 channels of C, 64 columns of N) = blockIdx.x, range
// blockIdx.y of the box tiles. xmap: x's NHWC map (C channels); gmap: g's
// (N). Writes part[range][t] (C x N fp32) in its block.
template <bool APPLY>
__global__ void __launch_bounds__(kCtaThreads, 1)
    dw_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap, Geo g,
              const float* __restrict__ mul, const float* __restrict__ add, float* __restrict__ part, int C, int N) {
  using S = DwSmem;
  unsigned char* ring = smem_base();
  unsigned char* planes = ring + S::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + S::kPlanes);
  uint64_t* empty = full + kDwStages;

  const int nblocks = cdiv(N, kBox), cblocks = cdiv(C, 2 * kBox);
  const int n0 = (blockIdx.x % nblocks) * kBox, q = blockIdx.x / nblocks;
  const int c0 = (q % cblocks) * 2 * kBox, tap = q / cblocks, dy = tap / 3 - 1, dx = tap % 3 - 1;
  const long long total = boxes(g);
  const int first = (int)(total * blockIdx.y / gridDim.y);
  const int steps = (int)(total * (blockIdx.y + 1) / gridDim.y) - first;
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
        const int st = s % kDwStages;
        int b, i0, j0;
        box_origin(g, first + s, b, i0, j0);
        unsigned char* stage = ring + st * S::kStageBytes;
        mbar_wait(&empty[st], ((s / kDwStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], S::kStageBytes);
        for (int k = 0; k < 4; ++k) tma_load_4d(stage + k * kBoxF, &xmap, &full[st], c0 + k * kKb, j0 + dx, i0 + dy, b);
        for (int k = 0; k < 2; ++k) tma_load_4d(stage + (4 + k) * kBoxF, &gmap, &full[st], n0 + k * kKb, j0, i0, b);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, wq = (ctid >> 5) & 3;
  const int lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  // This thread's channel pair of the warpgroup's 64 (m rows gq and gq + 8
  // of its warp), its x box and column there, and the prologue's mul / add.
  const int cw = wg * kBox + wq * 16 + 2 * gq, c = c0 + cw;
  const int xb = cw >> 5, xc = cw & 31;
  float m0 = 0.f, m1 = 0.f, a0 = 0.f, a1 = 0.f;
  if (APPLY && c < C) m0 = __ldg(mul + c), m1 = __ldg(mul + c + 1), a0 = __ldg(add + c), a1 = __ldg(add + c + 1);
  const int gr = ctid & 63;  // the box row whose g values this thread puts into g^T's planes

  // g^T's planes of tile s, from its stage's g boxes, into buffer s & 1:
  // g (box row gr, column n) -> plane box (gr >> 5), row n, column gr & 31.
  // Box rows outside the image hold TMA's zeros.
  auto form = [&](int s) {
    const int st = s % kDwStages;
    const unsigned char* stage = ring + st * S::kStageBytes;
    unsigned char* ph = planes + (s & 1) * 4 * kBoxF;  // hi plane: two boxes (pixels 0-31, 32-63); lo after
    mbar_wait(&full[st], (s / kDwStages) & 1);
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int lc = (ctid >> 6) + 4 * j;
        const float4 gv = *reinterpret_cast<const float4*>(stage + (4 + k) * kBoxF + gr * 128 + ((lc ^ (gr & 7)) << 4));
        const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t hi, lo;
          f32h::split_v(gg[e], hi, lo);
          const int po = (gr >> 5) * kBoxF + f32h::swz(k * kKb + 4 * lc + e, gr & 31);
          *reinterpret_cast<uint32_t*>(ph + po) = hi;
          *reinterpret_cast<uint32_t*>(ph + 2 * kBoxF + po) = lo;
        }
      }
    fence_proxy_async();
  };

  float acc[32];
  f32h::zero(acc);
  const int lbw = __ffs(g.bw) - 1;  // bw is a power of two: box row r is pixel (r >> lbw, r & (bw - 1))
  form(0);
  named_barrier(1, kConsumerThreads);  // tile 0's planes are complete
  for (int s = 0; s < steps; ++s) {
    const int st = s % kDwStages;
    const unsigned char* stage = ring + st * S::kStageBytes;
    const unsigned char* ph = planes + (s & 1) * 4 * kBoxF;
    int b, i0, j0;
    box_origin(g, first + s, b, i0, j0);
    // dw_t (64 channels x 64 columns) += shift_t(a)^T g over the tile's 64
    // pixels: A m row 16 wq + gq (+ 8) is channel cw (+ 1), k-slot t4 (+ 4)
    // of k-step ks is box row 8 ks + t4 (+ 4), zero where that row's shifted
    // pixel lies outside the image; B the planes, k-step ks in box ks >> 2.
    // A warpgroup whose channels all lie past C multiplies zeros (TMA's
    // zeros, mul = add = 0): a branch around the wgmmas would serialize them
    // (ptxas C7520).
    uint32_t ah[8][4], al[8][4];
    fence_acc(acc);
    const unsigned char* blk = stage + xb * kBoxF;
    const int ti = i0 + dy, tj = j0 + dx;  // the box's origin at the tap's shift
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int r0 = 8 * ks + t4, r1 = r0 + 4;
      const bool in0 = inside(g, b, ti + (r0 >> lbw), tj + (r0 & (g.bw - 1)));
      const bool in1 = inside(g, b, ti + (r1 >> lbw), tj + (r1 & (g.bw - 1)));
      float2 x0 = *reinterpret_cast<const float2*>(blk + f32h::swz(r0, xc));
      float2 x1 = *reinterpret_cast<const float2*>(blk + f32h::swz(r1, xc));
      if (APPLY) {
        x0.x = fmaxf(__fadd_rn(__fmul_rn(x0.x, m0), a0), 0.f), x0.y = fmaxf(__fadd_rn(__fmul_rn(x0.y, m1), a1), 0.f);
        x1.x = fmaxf(__fadd_rn(__fmul_rn(x1.x, m0), a0), 0.f), x1.y = fmaxf(__fadd_rn(__fmul_rn(x1.y, m1), a1), 0.f);
      }
      const float a[4] = {in0 ? x0.x : 0.f, in0 ? x0.y : 0.f, in1 ? x1.x : 0.f, in1 ? x1.y : 0.f};
      f32h::split_a(a, ah[ks], al[ks]);
      wgmma_fence();
      f32h::mma3<64>(acc, ah[ks], al[ks], f32h::kdesc(ph + (ks >> 2) * kBoxF, ks & 3),
                     f32h::kdesc(ph + (2 + (ks >> 2)) * kBoxF, ks & 3));
    }
    wgmma_commit();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // x is in registers, g in the planes: the stage is free
    // The next tile's planes while these products run: its buffer was read
    // by tile s - 1's, which both warpgroups finished before the last barrier.
    if (s + 1 < steps) form(s + 1);
    wgmma_wait<0>();
    fence_acc(acc);
    named_barrier(1, kConsumerThreads);  // tile s + 1's planes complete; tile s's products done
    // Every kFlush tiles (and at the end) the accumulators are added to the
    // partial with round to nearest and start again from 0.
    if ((s + 1) % kFlush == 0 || s + 1 == steps) {
      float* out = part + ((size_t)blockIdx.y * 9 + tap) * C * N;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + 8 * i + 2 * t4;
        if (c < C && n < N) {
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

// --- launchers ---------------------------------------------------------------------------

template <bool FWD, bool APPLY>
int launch_gemm(const CUtensorMap& amap, const CUtensorMap& bmap, const Geo& g, int kc, int ncols, float* out,
                float* part, int groups, const float* x, const float* mul, const float* add, cudaStream_t st) {
  constexpr int smem = GemmSmem::kBytes;
  static_assert(smem <= kSmemCap, "more shared memory than a CTA may use");
  auto kern = gemm_kernel<FWD, APPLY>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<groups * cdiv(ncols, kCols), kCtaThreads, smem, st>>>(amap, bmap, g, kc, ncols, out, part, x, mul, add);
  return (int)cudaGetLastError();
}

template <bool APPLY>
int launch_dw(const CUtensorMap& xmap, const CUtensorMap& gmap, const Geo& g, const float* mul, const float* add,
              float* part, int ranges, int C, int N, cudaStream_t st) {
  constexpr int smem = DwSmem::kBytes;
  static_assert(smem <= kSmemCap, "more shared memory than a CTA may use");
  auto kern = dw_kernel<APPLY>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(9 * cdiv(C, 2 * kBox) * cdiv(N, kBox), ranges), kCtaThreads, smem, st>>>(xmap, gmap, g, mul, add, part,
                                                                                       C, N);
  return (int)cudaGetLastError();
}

// Partial rows of one call on a card of `sms` SMs: s1/s2 (forward),
// dmul/dadd and dw (backward).
inline int fwd_partials(const Geo& g, int N, int sms) { return gemm_groups(g, N, sms); }
inline int dx_partials(const Geo& g, int C, int sms) { return gemm_groups(g, C, sms); }

// Forward. x (B, H, W, C), w (9, C, N), y (B, H, W, N) fp32; mul, add (C,)
// fp32 or both null. Scratch: planes (9, 2, N, round32(C)) fp32; part
// (parts, 2, N) fp32 with parts = fwd_partials. Out: s (2, N) = [s1; s2].
// Returns 0, a CUresult of a tensor-map encoding or the first cudaError_t
// of the launches (cudaErrorInvalidValue for a wrong parts or missing
// planes).
inline int launch_fwd(const void* x, const void* w, const float* mul, const float* add, void* y, float* planes,
                      float* part, int parts, float* s, int B, int H, int W, int C, int N, cudaStream_t st) {
  const Geo g(B, H, W);
  if (!planes || parts != fwd_partials(g, N, sm_count())) return (int)cudaErrorInvalidValue;
  cudaError_t e = mbf::split_w(static_cast<const float*>(w), planes, C, N, 1, st, 9);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap xmap, wtmap;
  int err = tmap_nhwc_f32(&xmap, x, B, H, W, C, g.bw, g.bh);
  if (!err) err = tmap_batched_f32(&wtmap, planes, 18, N, round32(C));
  if (err) return err;
  float* yf = static_cast<float*>(y);
  err = mul ? launch_gemm<true, true>(xmap, wtmap, g, C, N, yf, part, parts, nullptr, mul, add, st)
            : launch_gemm<true, false>(xmap, wtmap, g, C, N, yf, part, parts, nullptr, mul, add, st);
  if (err) return err;
  cbn::reduce_rows<<<cbn::ceil_div(2 * N, 32), dim3(32, 8), 0, st>>>(part, parts, 2 * N, s);
  return (int)cudaGetLastError();
}

// Backward. x (B, H, W, C), w (9, C, N), y, dy (B, H, W, N) fp32; mul, add
// (C,) fp32 or both null; ds (2, N) fp32. Scratch: planes (9, 2, C,
// round32(N)) fp32, gs (B*H*W, N) fp32 (g), part_x (parts_x, 2, C) fp32
// (written with mul only) and part_w (parts_w, 9, C, N) fp32 with the counts
// above. Out: dx (B, H, W, C), dw (9, C, N), dmd (2, C) = [dmul; dadd]
// (with mul), all fp32. Returns as launch_fwd.
inline int launch_bwd(const void* x, const void* w, const float* mul, const float* add, const void* y,
                      const void* dy, const float* ds, float* planes, float* gs, void* dx, float* dw, float* dmd,
                      float* part_x, int parts_x, float* part_w, int parts_w, int B, int H, int W, int C, int N,
                      cudaStream_t st) {
  const Geo g(B, H, W);
  const int sms = sm_count();
  if (!planes || !gs || parts_x != dx_partials(g, C, sms) || parts_w != c3f::dw_ranges(g, C, N, sms))
    return (int)cudaErrorInvalidValue;
  const size_t vecs = (size_t)B * H * W * N / 4;
  const int blocks = (int)((vecs + 255) / 256 < 8192 ? (vecs + 255) / 256 : 8192);
  g_kernel<<<blocks > 0 ? blocks : 1, 256, 0, st>>>(static_cast<const float*>(dy), static_cast<const float*>(y), ds,
                                                    gs, vecs, N);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = mbf::split_w(static_cast<const float*>(w), planes, C, N, 0, st, 9);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap xmap, gmap, wnmap;
  int err = tmap_nhwc_f32(&xmap, x, B, H, W, C, g.bw, g.bh);
  if (!err) err = tmap_nhwc_f32(&gmap, gs, B, H, W, N, g.bw, g.bh);
  if (!err) err = tmap_batched_f32(&wnmap, planes, 18, C, round32(N));
  if (err) return err;
  const float* xf = static_cast<const float*>(x);
  float* dxf = static_cast<float*>(dx);
  err = mul ? launch_gemm<false, true>(gmap, wnmap, g, N, C, dxf, part_x, parts_x, xf, mul, add, st)
            : launch_gemm<false, false>(gmap, wnmap, g, N, C, dxf, part_x, parts_x, xf, mul, add, st);
  if (err) return err;
  err = mul ? launch_dw<true>(xmap, gmap, g, mul, add, part_w, parts_w, C, N, st)
            : launch_dw<false>(xmap, gmap, g, mul, add, part_w, parts_w, C, N, st);
  if (err) return err;
  if (mul) {
    cbn::reduce_rows<<<cbn::ceil_div(2 * C, 32), dim3(32, 8), 0, st>>>(part_x, parts_x, 2 * C, dmd);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int cols = 9 * C * N;
  cbn::reduce_rows<<<cbn::ceil_div(cols, 32), dim3(32, 8), 0, st>>>(part_w, parts_w, cols, dw);
  return (int)cudaGetLastError();
}

}  // namespace c3f
