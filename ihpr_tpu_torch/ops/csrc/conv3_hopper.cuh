// Fused stride-1 SAME 3x3 conv + BatchNorm statistics in bf16 for Hopper
// (sm_90a): the kernels of
//   K7 conv_bn_fwd.cu (replaces ihpr_tpu/ops/conv_bn.py:_fwd_kernel)
//   K8 conv_bn_bwd.cu (replaces ihpr_tpu/ops/conv_bn.py:_bwd_kernel)
// for bf16 operands. fp32 operands keep the FMA kernels of
// conv_bn_common.cuh (K7/K8-fp32, on no full-width path; fp32 K5/K6 run
// 3xTF32 on wgmma, matmul_bn_f32.cuh).
//
// What they compute. x (B, H, W, C) NHWC bf16, w (9, C, N) in HWIO tap order
// t = (dy+1)*3 + (dx+1); shift_t(a)[i, j] = a[i+dy, j+dx], 0 outside the
// image (the SAME padding). With the prologue a = bf16(relu(x*mul + add))
// (fp32, the multiply and the add rounded apart, as the plain version), else
// a = x.
//   forward:  y = sum_t shift_t(a) @ w_t (fp32 accumulation, stored bf16);
//             s1, s2 = column sums of the fp32 accumulator and its square;
//   backward: gc = bf16(dy + ds1 + 2*y*ds2) (fp32, the saved rounded y);
//             da = sum_t shift_{-t}(gc) @ w_t^T (fp32); with the prologue
//             t = da * (x*mul + add > 0), dx = t*mul, dmul = sum t*x,
//             dadd = sum t; else dx = da;
//             dw_t = shift_t(a)^T @ gc (fp32).
//
// What bounds them on an H100. At the flagship plane (128, 16, 16, 256) x
// (9, 256, 256) the forward is 38.7 GFLOP against 34 MB (39 us at 989
// TFLOP/s), the backward twice that: tensor-core bound. v1 (mma.sync fed by
// ldmatrix, 64 x 64 CTA tiles, a row gather with two integer divisions per
// 16-byte chunk, the prologue once per tap) ran at 42 / 58 TFLOP/s.
//
// Design.
//   1. prep_kernel, one elementwise pass: a = bf16(relu(x*mul + add)) into an
//      (M, C) scratch (with the prologue only) and, in the backward, gc into
//      an (M, N) scratch. So a now reaches device memory once per call (the
//      TPU kernel kept it in VMEM; v1 recomputed it per tap), and the
//      prologue runs once per element instead of nine times. TMA's zero fill
//      outside the tensor is then exactly the SAME padding of a: a box of raw
//      x would fill zeros of x, which the prologue turns into relu(add).
//   2. Implicit GEMM from shifted boxes. A 4-D tensor map over an NHWC tensor
//      (hopper.cuh: tmap_nhwc) reads 64 channels x bw columns x bh rows of one
//      image, bw * bh = 64, as one 64-row K-major tile with the 128-byte
//      swizzle: exactly a wgmma A operand. A tap is the box moved by (dx, dy);
//      coordinates may be negative, and pixels outside the image read 0. The
//      consumers do no address arithmetic at all.
//   3. gemm_kernel (K7's y, K8's da): one CTA per (128-pixel tile = two boxes
//      stacked along H, 256 output columns). A producer warpgroup (one thread
//      issues TMA) fills a ring of kStages stages, each the two A boxes and
//      four 64-wide boxes of w_t (3-D map (N, C, 9), so a k-block past C
//      reads zeros, not the next tap); two consumer warpgroups each run
//      wgmma m64n256k16 on their box (64 pixels) and all four B boxes, one
//      stage's products in flight while the next is issued. For y, B = w_t
//      MN-major (rows c, columns n); for da, A = gc's box at the opposite
//      shift and B = the same w_t boxes read K-major (rows c, 64 n). 9 taps x
//      ceil(K/64) stages per tile. Epilogue from the fp32 accumulator: y (or
//      the prologue's backward and dx) in bf16; the column sums (s1/s2 or
//      dmul/dadd) over the tile's pixels, reduced over the 8 warps in a fixed
//      order into one partial row per tile.
//      Box rows outside the image are not zero here (their 3x3 halo reaches
//      valid pixels), so they are masked out of every store and every sum.
//   4. dw_kernel: one CTA per (tap, 128 channels of C, 256 columns of N,
//      range of 64-pixel tiles), one range per SM's share so that one wave
//      fills the card. Per tile: A = a's box at the tap's shift read M-major
//      (two 64-channel boxes, one per consumer warpgroup), B = gc's unshifted
//      box MN-major (four 64-column boxes); dw_t (64 x 256 per warpgroup,
//      fp32 registers) += A^T B. Each CTA writes its partial dw_t block.
//   5. reduce_rows (conv_bn_common.cuh) sums the partial rows in a fixed
//      order: s1/s2, dmul/dadd, dw.
// No atomics and a static schedule, so every result is bitwise the same
// from run to run (on one card: dw's ranges follow its SM count).
//
// Shapes: any B, H, W; C and N multiples of 8 (TMA's 16-byte pitch). bw is
// the smallest power of two >= W, at most 16 (16 x 4 boxes at W = 16). C and
// N past a multiple of 64 or 256 read TMA's zeros, and their columns are
// masked.

#pragma once

#include "conv_bn_common.cuh"
#include "hopper.cuh"

namespace c3 {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kStages = 4;                             // ring depth
constexpr int kCols = 256;                             // output columns of a CTA (wgmma n256)
constexpr int kColBoxes = kCols / kBox;                // B boxes per stage
constexpr int kStageBytes = (2 + kColBoxes) * kBoxBytes;  // two A boxes + four B boxes: 48 KB
constexpr int kCtaThreads = 384;                       // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr size_t kRingBytes = (size_t)kStages * kStageBytes;
constexpr size_t kBarBytes = 2 * kStages * sizeof(uint64_t);
constexpr size_t kRedBytes = 8 * 2 * kCols * sizeof(float);  // [consumer warp][2][column]
constexpr size_t kColBytes = 2 * kCols * sizeof(float);      // mul, add of the CTA's columns
constexpr size_t kGemmSmem = 1024 + kRingBytes + kBarBytes + kRedBytes + kColBytes;
constexpr size_t kDwSmem = 1024 + kRingBytes + kBarBytes;

// Pixel tiling of B images of H x W: boxes of bw columns x bh rows.
struct Geo {
  int B, H, W, bw, bh, tw;
  __host__ __device__ Geo(int b, int h, int w) : B(b), H(h), W(w), bw(16) {
    while (bw > 1 && bw / 2 >= W) bw >>= 1;
    bh = kBox / bw;
    tw = (W + bw - 1) / bw;
  }
  // Tiles of `rows` image rows (2 bh for the GEMMs, bh for dw), image-major.
  __host__ __device__ int tiles_h(int rows) const { return (H + rows - 1) / rows; }
  __host__ __device__ int tiles(int rows) const { return B * tiles_h(rows) * tw; }
  // Origin (b, i0, j0) of tile `tile` of `rows` image rows.
  __device__ void origin(int tile, int rows, int& b, int& i0, int& j0) const {
    const int th = tiles_h(rows), q = tile / tw;
    j0 = (tile - q * tw) * bw;
    b = q / th;
    i0 = (q - b * th) * rows;
  }
};

// Ranges of 64-pixel tiles the dw kernel splits the pixels into: about one
// CTA per SM of `sms`, at least one range, at most one tile per range.
inline int dw_ranges(const Geo& g, int K, int N, int sms) {
  const int cols = 9 * cdiv(K, 2 * kBox) * cdiv(N, kCols);
  const int r = sms / cols, tiles = g.tiles(g.bh);
  return r < 1 ? 1 : (r < tiles ? r : tiles);
}

// --- the ring ------------------------------------------------------------------

// Producer (one thread): fills stage s % kStages with load(stage, bar, s)
// once every consumer warp has freed it.
template <typename Load>
__device__ __forceinline__ void produce(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        int steps, Load load) {
  for (int s = 0; s < steps; ++s) {
    const int st = s % kStages;
    mbar_wait(&empty[st], ((s / kStages) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[st], kStageBytes);
    load(ring + st * kStageBytes, &full[st], s);
  }
}

// Consumer warpgroup: per stage, wait for it, issue mma(acc, stage) (wgmma
// on the stage's tiles), keep those products in flight while waiting for
// the previous stage's, then free the previous stage.
template <typename Mma>
__device__ __forceinline__ void consume(float (&acc)[128], unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int steps, int lane, Mma mma) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int st = s % kStages;
    mbar_wait(&full[st], (s / kStages) & 1);
    fence_acc(acc);
    wgmma_fence();
    mma(acc, ring + st * kStageBytes);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// --- 1. the elementwise pass ------------------------------------------------------

// a = bf16(relu(x*mul + add)) over a_vecs vectors of 8 (rows of C), and
// gc = bf16((dy + ds1) + (2*y)*ds2) over g_vecs vectors (rows of N), ds =
// [ds1; ds2]. fp32 with each multiply and add rounded apart, as the plain
// versions (no contraction into FMAs). Each thread walks its vectors with
// a fixed stride, carrying its channel index instead of dividing.
__global__ void prep_kernel(const bf16* __restrict__ x, const float* __restrict__ mul,
                            const float* __restrict__ add, bf16* __restrict__ a, size_t a_vecs,
                            int C, const bf16* __restrict__ dy, const bf16* __restrict__ y,
                            const float* __restrict__ ds, bf16* __restrict__ gc, size_t g_vecs,
                            int N) {
  const size_t first = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  if (a_vecs) {
    const int per_row = C / 8, step = (int)(stride % per_row);
    int cv = (int)(first % per_row);
    for (size_t v = first; v < a_vecs; v += stride) {
      float m[8], ad[8];
      load8(mul + 8 * cv, m);
      load8(add + 8 * cv, ad);
      uint4 raw = *reinterpret_cast<const uint4*>(x + v * 8);
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        e[q] = __float2bfloat16(fmaxf(__fadd_rn(__fmul_rn(__bfloat162float(e[q]), m[q]), ad[q]), 0.f));
      *reinterpret_cast<uint4*>(a + v * 8) = raw;
      cv += step;
      if (cv >= per_row) cv -= per_row;
    }
  }
  if (g_vecs) {
    const int per_row = N / 8, step = (int)(stride % per_row);
    int cv = (int)(first % per_row);
    for (size_t v = first; v < g_vecs; v += stride) {
      float d1[8], d2[8];
      load8(ds + 8 * cv, d1);
      load8(ds + N + 8 * cv, d2);
      const uint4 d_raw = *reinterpret_cast<const uint4*>(dy + v * 8);
      const uint4 y_raw = *reinterpret_cast<const uint4*>(y + v * 8);
      const bf16* d = reinterpret_cast<const bf16*>(&d_raw);
      const bf16* yv = reinterpret_cast<const bf16*>(&y_raw);
      uint4 out;
      bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        o[q] = __float2bfloat16(__fadd_rn(__fadd_rn(__bfloat162float(d[q]), d1[q]),
                                          __fmul_rn(2.f * __bfloat162float(yv[q]), d2[q])));
      *reinterpret_cast<uint4*>(gc + v * 8) = out;
      cv += step;
      if (cv >= per_row) cv -= per_row;
    }
  }
}

inline cudaError_t prep(const void* x, const float* mul, const float* add, void* a, size_t a_elems,
                        int C, const void* dy, const void* y, const float* ds, void* gc,
                        size_t g_elems, int N, cudaStream_t st) {
  const size_t vecs = (a_elems > g_elems ? a_elems : g_elems) / 8;
  const int blocks = (int)((vecs + 255) / 256 < 16384 ? (vecs + 255) / 256 : 16384);
  prep_kernel<<<blocks > 0 ? blocks : 1, 256, 0, st>>>(
      static_cast<const bf16*>(x), mul, add, static_cast<bf16*>(a), a_elems / 8, C,
      static_cast<const bf16*>(dy), static_cast<const bf16*>(y), ds, static_cast<bf16*>(gc),
      g_elems / 8, N);
  return cudaGetLastError();
}

// --- 3. y (FWD) or da (!FWD) ---------------------------------------------------------

// CTA (128-pixel tile blockIdx.x, 256 output columns blockIdx.y). amap: the
// NHWC map of a (FWD, K = C) or gc (!FWD, K = N); wmap: w as (N, C, 9).
// FWD: out = y (pixels x ncols = N), part = s1/s2 partial rows.
// !FWD: out = dx (pixels x ncols = C); with APPLY the prologue's backward
// from x, mul, add, and part = dmul/dadd partial rows.
template <bool FWD, bool APPLY>
__global__ void __launch_bounds__(kCtaThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
                Geo g, int K, int ncols, bf16* __restrict__ out, float* __restrict__ part,
                const bf16* __restrict__ x, const float* __restrict__ mul,
                const float* __restrict__ add) {
  unsigned char* base = smem_base();
  unsigned char* ring = base;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kRingBytes);
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(base + kRingBytes + kBarBytes);
  float* col_mul = red + 8 * 2 * kCols;  // mul, add of the columns col0 ... (da with APPLY)
  float* col_add = col_mul + kCols;

  const int tile = blockIdx.x, col0 = blockIdx.y * kCols;
  int b, i0, j0;
  g.origin(tile, 2 * g.bh, b, i0, j0);
  const int nkb = cdiv(K, kBox), steps = 9 * nkb;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    const CUtensorMap *am = &amap, *wm = &wmap;
    const int bh = g.bh;
    if (tid == 0)
      produce(ring, full, empty, steps, [=](unsigned char* st, uint64_t* bar, int s) {
        const int t = s / nkb, k0 = (s - t * nkb) * kBox;
        const int sy = FWD ? t / 3 - 1 : 1 - t / 3, sx = FWD ? t % 3 - 1 : 1 - t % 3;
        for (int h = 0; h < 2; ++h)
          tma_load_4d(st + h * kBoxBytes, am, bar, k0, j0 + sx, i0 + h * bh + sy, b);
        for (int q = 0; q < kColBoxes; ++q) {
          if (FWD)  // rows c (K), 64 columns n: MN-major
            tma_load_3d(st + (2 + q) * kBoxBytes, wm, bar, col0 + q * kBox, k0, t);
          else  // rows c (output columns), 64 n (K): K-major
            tma_load_3d(st + (2 + q) * kBoxBytes, wm, bar, k0, col0 + q * kBox, t);
        }
      });
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, warp = ctid >> 5, wq = warp & 3;
  const int lane = tid & 31, gq = lane >> 2, tig = lane & 3;
  if (!FWD && APPLY) {  // for the epilogue, behind the barrier before it
    const int c = col0 + ctid;
    col_mul[ctid] = c < ncols ? __ldg(mul + c) : 0.f;
    col_add[ctid] = c < ncols ? __ldg(add + c) : 0.f;
  }
  float acc[128];
  consume(acc, ring, full, empty, steps, lane, [wg](float (&d)[128], const unsigned char* st) {
    const unsigned char* a = st + wg * kBoxBytes;
    const unsigned char* w = st + 2 * kBoxBytes;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (FWD)
        mma_ss_n256<0, 1>(d, desc_sw128(a + ks * 32, 16, 1024), desc_sw128(w + ks * 2048, kBoxBytes, 1024));
      else
        mma_ss_n256<0, 0>(d, desc_sw128(a + ks * 32, 16, 1024), desc_sw128(w + ks * 32, 16, 1024));
    }
  });

  // This thread's two rows: box row r = 16 wq + gq (+8) of its warpgroup's box.
  size_t p[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wq * 16 + gq + 8 * h, i = i0 + wg * g.bh + r / g.bw, j = j0 + r % g.bw;
    ok[h] = i < g.H && j < g.W;
    p[h] = ((size_t)b * g.H + i) * g.W + j;
  }
  if (!FWD && APPLY) named_barrier(1, kConsumerThreads);  // col_mul / col_add are in place
  // Eight 8-column chunks at a time; da first loads their x pairs, so its
  // global loads overlap instead of waiting one by one.
#pragma unroll
  for (int i8 = 0; i8 < 32; i8 += 8) {
    uint32_t xr[8][2];
    if (!FWD && APPLY) {
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int c = col0 + 8 * (i8 + ii) + 2 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xr[ii][h] = ok[h] && c < ncols ? __ldg(reinterpret_cast<const unsigned int*>(x + p[h] * ncols + c)) : 0u;
      }
    }
    float sums[8];  // two chunks' u, v for stage_colsums
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const int i = i8 + ii, cl = 8 * i + 2 * tig, c = col0 + cl;
      float u[2] = {0.f, 0.f}, v[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h] || c >= ncols) continue;
        float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        if (FWD) {
          u[0] += v0, u[1] += v1;
          v[0] += v0 * v0, v[1] += v1 * v1;
        } else if (APPLY) {
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[ii][h]));
          const float m0 = col_mul[cl], m1 = col_mul[cl + 1];
          const float t0 = __fadd_rn(__fmul_rn(xv.x, m0), col_add[cl]) > 0.f ? v0 : 0.f;
          const float t1 = __fadd_rn(__fmul_rn(xv.y, m1), col_add[cl + 1]) > 0.f ? v1 : 0.f;
          u[0] += t0 * xv.x, u[1] += t1 * xv.y;
          v[0] += t0, v[1] += t1;
          v0 = t0 * m0;
          v1 = t1 * m1;
        }
        fhi::Elem<bf16>::store2(out + p[h] * ncols + c, v0, v1);
      }
      if (FWD || APPLY) {
        const int o = 4 * (ii & 1);
        sums[o] = u[0], sums[o + 1] = u[1], sums[o + 2] = v[0], sums[o + 3] = v[1];
        if (ii & 1) stage_colsums(red, kCols, warp, i - 1, lane, sums);
      }
    }
  }
  if (FWD || APPLY) write_colsums(red, kCols, ctid, part, tile, col0, ncols);
}

// --- 4. dw partials -------------------------------------------------------------------

// CTA (tap t, 128 channels of C, 256 columns of N) = blockIdx.x, range
// blockIdx.y of the 64-pixel tiles. amap: a's NHWC map (C channels); gmap:
// gc's (N channels). Writes part[range][t] (C x N fp32) in its block.
__global__ void __launch_bounds__(kCtaThreads, 1)
    dw_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap gmap,
              Geo g, int C, int N, float* __restrict__ part) {
  unsigned char* base = smem_base();
  unsigned char* ring = base;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kRingBytes);
  uint64_t* empty = full + kStages;

  const int ntiles = cdiv(N, kCols), ctiles = cdiv(C, 2 * kBox);
  const int nt = blockIdx.x % ntiles, q = blockIdx.x / ntiles, ct = q % ctiles, t = q / ctiles;
  const int c0 = ct * 2 * kBox, n0 = nt * kCols, dy = t / 3 - 1, dx = t % 3 - 1;
  const long long total = g.tiles(g.bh);
  const int first = (int)(total * blockIdx.y / gridDim.y);
  const int steps = (int)(total * (blockIdx.y + 1) / gridDim.y) - first;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    const CUtensorMap *am = &amap, *gm = &gmap;
    if (tid == 0)
      produce(ring, full, empty, steps, [=](unsigned char* st, uint64_t* bar, int s) {
        int b, i0, j0;
        g.origin(first + s, g.bh, b, i0, j0);
        for (int h = 0; h < 2; ++h)  // 64 pixels x 64 channels of a, shifted
          tma_load_4d(st + h * kBoxBytes, am, bar, c0 + h * kBox, j0 + dx, i0 + dy, b);
        for (int k = 0; k < kColBoxes; ++k)  // the same 64 pixels x 64 columns of gc
          tma_load_4d(st + (2 + k) * kBoxBytes, gm, bar, n0 + k * kBox, j0, i0, b);
      });
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, wg = ctid >> 7, wq = (ctid >> 5) & 3;
  const int lane = tid & 31, gq = lane >> 2, tig = lane & 3;
  float acc[128];
  // dw_t[c, n] += sum over the tile's pixels of a[p + d_t, c] gc[p, n]: A is
  // the a box read M-major (rows pixels, columns c), B the gc boxes MN-major.
  consume(acc, ring, full, empty, steps, lane, [wg](float (&d)[128], const unsigned char* st) {
    const unsigned char* a = st + wg * kBoxBytes;
    const unsigned char* gcb = st + 2 * kBoxBytes;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      mma_ss_n256<1, 1>(d, desc_sw128(a + ks * 2048, kBoxBytes, 1024),
                        desc_sw128(gcb + ks * 2048, kBoxBytes, 1024));
  });

  float* out = part + ((size_t)blockIdx.y * 9 + t) * C * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + wg * kBox + wq * 16 + gq + 8 * h;
    if (c >= C) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = n0 + 8 * i + 2 * tig;
      if (n < N)
        *reinterpret_cast<float2*>(out + (size_t)c * N + n) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

// --- launchers ---------------------------------------------------------------------------

template <bool FWD, bool APPLY>
int launch_gemm(const CUtensorMap& amap, const CUtensorMap& wmap, const Geo& g, int K, int ncols,
                void* out, float* part, const void* x, const float* mul, const float* add,
                cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<FWD, APPLY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  gemm_kernel<FWD, APPLY><<<dim3(g.tiles(2 * g.bh), cdiv(ncols, kCols)), kCtaThreads, kGemmSmem, st>>>(
      amap, wmap, g, K, ncols, static_cast<bf16*>(out), part, static_cast<const bf16*>(x), mul, add);
  return (int)cudaGetLastError();
}

// Forward. x (B, H, W, K), w (9, K, N), y (B, H, W, N) bf16; mul, add (K,)
// fp32 or both null. Scratch: a (B*H*W, K) bf16 (with mul only), part
// (parts, 2, N) fp32 with parts = Geo(B, H, W).tiles(2 bh). Out: s (2, N).
inline int launch_fwd(const void* x, const void* w, const float* mul, const float* add, void* a,
                      void* y, float* part, int parts, float* s, int B, int H, int W, int K, int N,
                      cudaStream_t st) {
  const Geo g(B, H, W);
  if (parts != g.tiles(2 * g.bh) || (mul && !a)) return (int)cudaErrorInvalidValue;
  const size_t M = (size_t)B * H * W;
  if (mul) {
    const cudaError_t err = prep(x, mul, add, a, M * K, K, nullptr, nullptr, nullptr, nullptr, 0, N, st);
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap amap, wmap;
  int terr = tmap_nhwc(&amap, mul ? a : x, B, H, W, K, g.bw, g.bh);
  if (!terr) terr = tmap_batched(&wmap, w, 9, K, N);
  if (terr) return terr;
  const int err = launch_gemm<true, false>(amap, wmap, g, K, N, y, part, nullptr, nullptr, nullptr, st);
  if (err) return err;
  cbn::reduce_rows<<<cbn::ceil_div(2 * N, 32), dim3(32, 8), 0, st>>>(part, parts, 2 * N, s);
  return (int)cudaGetLastError();
}

// Backward. x (B, H, W, K), w (9, K, N), y, dy (B, H, W, N) bf16; mul, add
// (K,) fp32 or both null; ds (2, N) fp32. Scratch: a (B*H*W, K) bf16 (with
// mul only), gc (B*H*W, N) bf16, part_x (parts_x, 2, K) fp32 with parts_x =
// Geo.tiles(2 bh), part_w (parts_w, 9, K, N) fp32 with parts_w = dw_ranges.
// Out: dx (B, H, W, K) bf16, dw (9, K, N) fp32, dmd (2, K) fp32 (with mul).
inline int launch_bwd(const void* x, const void* w, const float* mul, const float* add,
                      const void* y, const void* dy, const float* ds, void* a, void* gc, void* dx,
                      float* dw, float* dmd, float* part_x, int parts_x, float* part_w, int parts_w,
                      int B, int H, int W, int K, int N, cudaStream_t st) {
  const Geo g(B, H, W);
  if (parts_x != g.tiles(2 * g.bh) || parts_w != dw_ranges(g, K, N, sm_count()) || (mul && !a))
    return (int)cudaErrorInvalidValue;
  const size_t M = (size_t)B * H * W;
  cudaError_t err = prep(x, mul, add, a, mul ? M * K : 0, K, dy, y, ds, gc, M * N, N, st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap amap, gmap, wmap;
  int terr = tmap_nhwc(&amap, mul ? a : x, B, H, W, K, g.bw, g.bh);
  if (!terr) terr = tmap_nhwc(&gmap, gc, B, H, W, N, g.bw, g.bh);
  if (!terr) terr = tmap_batched(&wmap, w, 9, K, N);
  if (terr) return terr;

  int e = mul ? launch_gemm<false, true>(gmap, wmap, g, N, K, dx, part_x, x, mul, add, st)
              : launch_gemm<false, false>(gmap, wmap, g, N, K, dx, part_x, x, mul, add, st);
  if (e) return e;

  err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem);
  if (err != cudaSuccess) return (int)err;
  dw_kernel<<<dim3(9 * cdiv(K, 2 * kBox) * cdiv(N, kCols), parts_w), kCtaThreads, kDwSmem, st>>>(
      amap, gmap, g, K, N, part_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (mul) {
    cbn::reduce_rows<<<cbn::ceil_div(2 * K, 32), dim3(32, 8), 0, st>>>(part_x, parts_x, 2 * K, dmd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int cols = 9 * K * N;
  cbn::reduce_rows<<<cbn::ceil_div(cols, 32), dim3(32, 8), 0, st>>>(part_w, parts_w, cols, dw);
  return (int)cudaGetLastError();
}

}  // namespace c3
