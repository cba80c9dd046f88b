// Conv + BatchNorm-statistics kernels (FMA) for Hopper (sm_90a), fp32 operands, used by
//   K7 conv_bn_fwd.cu     (replaces ihpr_tpu/ops/conv_bn.py:_fwd_kernel)
//   K8 conv_bn_bwd.cu     (replaces ihpr_tpu/ops/conv_bn.py:_bwd_kernel)
// for fp32 operands (K7/K8-fp32), which no full-width path runs (JAX's conv3
// route takes no fp32 ResNet-50 block). bf16 K7/K8 run the TMA + wgmma
// kernels of conv3_hopper.cuh, and K5/K6 those of matmul_bn_hopper.cuh
// (bf16) and matmul_bn_f32.cuh (fp32, 3xTF32 on wgmma); all of them take
// reduce_rows from here.
//
// What they compute. Rows are pixels: x (M, K) row-major, the NHWC
// activation of B images of H x W (M = B*H*W). A stride-1 SAME 3x3 conv
// (TAPS = 9, the only instance built) is y = sum_t shift_t(a) @ w_t with w
// (9, K, N) in HWIO tap order t = (dy+1)*3 + (dx+1), where shift_t(a)[p] is
// a at pixel (i+dy, j+dx) of p's image and 0 outside it (the SAME padding);
// TAPS = 1 would be a 1x1 conv. With the prologue, a = relu(x*mul + add) in
// fp32, else a = x.
//   forward:  y = conv(a, w), fp32 accumulation;
//             s1, s2 = column sums of the fp32 accumulator and its square.
//   backward: g  = dy + ds1 + 2*y*ds2 in fp32 with the saved y (gc_kernel);
//             da = sum_t shift_{-t}(gc) @ w_t^T (fp32); with the prologue
//             t = da * (x*mul + add > 0), dx = t*mul, dmul = sum t*x,
//             dadd = sum t; else dx = da (dx_kernel);
//             dw_t = shift_t(a)^T @ gc (fp32, dw_kernel), a recomputed from x.
// a never reaches device memory, in either direction.
//
// Design. The TPU kernels walk an ordered grid and carry s1/s2 and dw in
// VMEM from one step to the next. Here CTAs run in no order, so every sum
// over rows is a two-pass reduction: each CTA walks a fixed set of row
// tiles (tile = blockIdx.y + i*gridDim.y), keeps its column sums in
// registers and writes one partial row; reduce_rows adds the partial rows
// in a fixed order. Nothing is atomic, and every result is bitwise the
// same from run to run. The partials are bounded at ~17 MB (the row-group
// counts below).
//
// Each product is an implicit GEMM: a CTA of 4 warps owns a 64-row x 64-column
// output tile and steps over (tap, 32-deep chunk of the contraction). A step
// copies the A chunk (rows gathered at the tap's shift, zero-filled outside
// the image and past the edges) and the B chunk into shared memory with
// cp.async, in a ring of stages<T>() buffers (the copies of the next
// stages - 1 steps stay in flight; one barrier per step), applies the
// prologue in place (each thread to the chunks it copied), and runs
// plain FMAs in the mma.sync m16n8k16 layout (fhi::warp_mma).
//
// What bounds them on an H100: the FMA units (67 TFLOP/s peak), where
// 3xTF32 on the tensor cores would have 165 (PERF.md §6: at (32, 16, 16,
// 256) x (9, 256, 256) they are slower than cuDNN fp32). The backward also
// writes gc (M x N) once and reads it twice where the TPU kernel forms g in
// VMEM. Not redesigned: they run on no full-width path (ROADMAP Queue 2).

#pragma once

#include "fused_head_common.cuh"

namespace cbn {

using fhi::Elem;
using fhi::kThreads;
using fhi::kWarps;

constexpr int kTile = 64;   // output rows and columns of a CTA tile (4 warps x 16 rows)
constexpr int kChunk = 32;  // contraction depth of one pipeline step
constexpr int kNt = kTile / 8;

// Pipeline depth: steps whose copies are in flight at once, in a ring of
// shared-memory buffers (bf16: 4, within the 48 KB of static shared memory;
// fp32, whose tiles are twice the bytes: 2).
template <typename T>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 2 ? 4 : 2;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Pixel geometry: M rows; with TAPS = 9 they are B images of H x W.
struct Geom {
  int M, H, W;
};

// Source row of row p at shift (dy, dx), or -1 where it is past M or
// outside p's image.
template <int TAPS>
__device__ __forceinline__ int src_row(int p, const Geom& g, int dy, int dx) {
  if (p >= g.M) return -1;
  if (TAPS == 1) return p;
  const int q = p / g.W, j = p - q * g.W, i = q % g.H;
  const int ii = i + dy, jj = j + dx;
  return (ii >= 0 && ii < g.H && jj >= 0 && jj < g.W) ? p + dy * g.W + dx : -1;
}

__device__ __forceinline__ void tap_shift(int t, int taps, int sign, int& dy, int& dx) {
  dy = taps == 9 ? sign * (t / 3 - 1) : 0;
  dx = taps == 9 ? sign * (t % 3 - 1) : 0;
}

// Copy a ROWS x COLS tile into shared memory (row pitch `pitch`): tile row r
// is row src_row(r0 + r) of src (row length ld), columns [c0, c0 + COLS).
// Rows with no source and columns at or past cl are zero. cl and c0 are
// multiples of 16 bytes' worth of elements, so a 16-byte chunk is all in or
// all out. Each thread copies chunks tid, tid + kThreads, ...
template <typename T, int ROWS, int COLS, int TAPS>
__device__ __forceinline__ void load_tile(T* dst, int pitch, const T* __restrict__ src, int ld,
                                          int r0, const Geom& g, int dy, int dx, int c0, int cl) {
  constexpr int kVec = 16 / sizeof(T), kPer = COLS / kVec;
  for (int i = threadIdx.x; i < ROWS * kPer; i += kThreads) {
    const int r = i / kPer, c = (i - r * kPer) * kVec;
    T* d = dst + r * pitch + c;
    const int s = src_row<TAPS>(r0 + r, g, dy, dx);
    if (s >= 0 && c0 + c < cl)
      fhi::cp_async16(d, src + (size_t)s * ld + c0 + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The prologue a = relu(x*mul + add) (fp32, two roundings as the plain
// version has them, then rounded to T), in place on the chunks this thread
// copied with the same arguments to load_tile. Zero-filled chunks stay 0:
// the SAME padding and the rows past M are zeros of a, not of x.
template <typename T, int ROWS, int COLS, int TAPS>
__device__ __forceinline__ void prologue_tile(T* dst, int pitch, int r0, const Geom& g, int dy,
                                              int dx, int c0, int cl,
                                              const float* __restrict__ mul,
                                              const float* __restrict__ add) {
  constexpr int kVec = 16 / sizeof(T), kPer = COLS / kVec;
  for (int i = threadIdx.x; i < ROWS * kPer; i += kThreads) {
    const int r = i / kPer, c = (i - r * kPer) * kVec;
    if (src_row<TAPS>(r0 + r, g, dy, dx) < 0 || c0 + c >= cl) continue;
    uint4* d = reinterpret_cast<uint4*>(dst + r * pitch + c);
    uint4 raw = *d;
    T* v = reinterpret_cast<T*>(&raw);
    const float4* m4 = reinterpret_cast<const float4*>(mul + c0 + c);
    const float4* a4 = reinterpret_cast<const float4*>(add + c0 + c);
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const float4 m = __ldg(m4 + q), a = __ldg(a4 + q);
      const float ms[4] = {m.x, m.y, m.z, m.w}, as[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float t = __fadd_rn(__fmul_rn(Elem<T>::to_float(v[4 * q + e]), ms[e]), as[e]);
        v[4 * q + e] = Elem<T>::from_float(fmaxf(t, 0.f));
      }
    }
    *d = raw;
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void zero(float (&acc)[kNt][4]) {
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// Per-column sums held by each thread (columns nt*8 + 2*tig + q, summed over
// the rows g and g + 8 of its warp's tiles) -> one partial row per CTA:
// part[row * 2*ncols + col] = sum of a[.], part[... + ncols + col] = sum of
// b[.], over the 4 warps in order. Columns at or past ncols are dropped.
__device__ __forceinline__ void write_partials(float (&a)[kNt][2], float (&b)[kNt][2],
                                               float* __restrict__ part, int row, int col0,
                                               int ncols) {
  __shared__ float red[2][kWarps][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float u = a[nt][q], v = b[nt][q];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        u += __shfl_xor_sync(0xffffffffu, u, o);
        v += __shfl_xor_sync(0xffffffffu, v, o);
      }
      if (lane < 4) {
        red[0][warp][nt * 8 + 2 * tig + q] = u;
        red[1][warp][nt * 8 + 2 * tig + q] = v;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kTile && col0 + threadIdx.x < ncols) {
    float* out = part + (size_t)row * 2 * ncols + col0 + threadIdx.x;
    float u = red[0][0][threadIdx.x], v = red[1][0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) u += red[0][w][threadIdx.x], v += red[1][w][threadIdx.x];
    out[0] = u;
    out[ncols] = v;
  }
}

// out[c] = sum over r of part[r * ncols + c], r in a fixed order: 8 strided
// partial sums per column, then added in order.
__global__ void reduce_rows(const float* __restrict__ part, int rows, int ncols,
                            float* __restrict__ out) {
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < ncols)
    for (int r = threadIdx.y; r < rows; r += 8) s += part[(size_t)r * ncols + c];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < ncols) {
    float t = red[0][threadIdx.x];
    for (int j = 1; j < 8; ++j) t += red[j][threadIdx.x];
    out[c] = t;
  }
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Row groups (CTAs along the rows) of the forward and dx kernels: about 2048
// CTAs in all, never more than the row tiles. Partials: groups x 2 x cols.
inline int tile_groups(int M, int cols) {
  const int tiles = ceil_div(M, kTile);
  const int want = ceil_div(2048, ceil_div(cols, kTile));
  return tiles < want ? tiles : want;
}

// Row groups of the dw kernel: about 1024 CTAs over (N tile, tap x K tile).
// Partials: groups x TAPS*K*N fp32, about 17 MB at any shape.
inline int dw_groups(int M, int K, int N, int taps) {
  const int steps = ceil_div(M, kChunk);
  const int want = ceil_div(1024, (long long)ceil_div(N, kTile) * taps * ceil_div(K, kTile));
  return steps < want ? steps : want;
}

// ---- forward: y = conv(a, w), s1/s2 partials -------------------------------

template <typename T, int TAPS, bool APPLY>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ mul,
               const float* __restrict__ add, T* __restrict__ y, float* __restrict__ part,
               Geom g, int K, int N) {
  constexpr int PA = kChunk + Elem<T>::kPad, PB = kTile + Elem<T>::kPad, S = stages<T>();
  __shared__ __align__(16) T As[S][kTile * PA];
  __shared__ __align__(16) T Bs[S][kChunk * PB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kTile, n_lim = min(kTile, N - n0);
  const int k_steps = (K + kChunk - 1) / kChunk, per_tile = TAPS * k_steps;
  const int tiles = (g.M + kTile - 1) / kTile;
  const int mine = tiles > (int)blockIdx.y ? (tiles - 1 - blockIdx.y) / gridDim.y + 1 : 0;
  const int total = mine * per_tile;
  const Geom wg{K, 1, 1};

  auto step_args = [&](int s, int& r0, int& t, int& k0) {
    r0 = (blockIdx.y + (s / per_tile) * gridDim.y) * kTile;
    const int st = s % per_tile;
    t = st / k_steps;
    k0 = (st - t * k_steps) * kChunk;
  };
  auto issue = [&](int s, int buf) {
    int r0, t, k0, dy, dx;
    step_args(s, r0, t, k0);
    tap_shift(t, TAPS, 1, dy, dx);
    load_tile<T, kTile, kChunk, TAPS>(As[buf], PA, x, K, r0, g, dy, dx, k0, K);
    load_tile<T, kChunk, kTile, 1>(Bs[buf], PB, w + (size_t)t * K * N, N, k0, wg, 0, 0, n0, N);
  };

  float acc[kNt][4], s1[kNt][2], s2[kNt][2];
  zero(acc);
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < total) issue(i, i);
    fhi::cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    const int buf = s % S;
    cp_async_wait<S - 2>();  // step s has landed; up to S - 2 later ones in flight
    if (APPLY) {
      int r0, t, k0, dy, dx;
      step_args(s, r0, t, k0);
      tap_shift(t, TAPS, 1, dy, dx);
      prologue_tile<T, kTile, kChunk, TAPS>(As[buf], PA, r0, g, dy, dx, k0, K, mul, add);
    }
    __syncthreads();  // step s is in place; every warp is done with step s - 1's buffer
    if (s + S - 1 < total) issue(s + S - 1, (s + S - 1) % S);
    fhi::cp_async_commit();
    fhi::warp_mma<kNt, false, true>(acc, As[buf] + warp * 16 * PA, PA, Bs[buf], PB, kChunk, n_lim,
                                    lane);
    if ((s + 1) % per_tile == 0) {
      // Epilogue: y in T; the statistics from the fp32 accumulator. Rows past
      // M hold exact zeros (their A rows are zero), so they add nothing.
      const int r0 = (blockIdx.y + (s / per_tile) * gridDim.y) * kTile + warp * 16 + gq;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int c = n0 + nt * 8 + 2 * tig;
        if (c < N) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            if (r < g.M) Elem<T>::store2(y + (size_t)r * N + c, acc[nt][2 * h], acc[nt][2 * h + 1]);
          }
          s1[nt][0] += acc[nt][0] + acc[nt][2];
          s1[nt][1] += acc[nt][1] + acc[nt][3];
          s2[nt][0] += acc[nt][0] * acc[nt][0] + acc[nt][2] * acc[nt][2];
          s2[nt][1] += acc[nt][1] * acc[nt][1] + acc[nt][3] * acc[nt][3];
        }
      }
      zero(acc);
    }
  }
  write_partials(s1, s2, part, blockIdx.y, n0, N);
}

// ---- backward ----------------------------------------------------------------

// gc = (dy + ds1) + (2*y)*ds2 in fp32, rounded to T; ds = [ds1; ds2] (2, N).
template <typename T>
__global__ void gc_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                          const float* __restrict__ ds, T* __restrict__ gc, size_t pairs, int N) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)((2 * i) % N);
    const float2 d = load2(dy + 2 * i), v = load2(y + 2 * i);
    const float g0 = __fadd_rn(__fadd_rn(d.x, __ldg(ds + c)), __fmul_rn(2.f * v.x, __ldg(ds + N + c)));
    const float g1 =
        __fadd_rn(__fadd_rn(d.y, __ldg(ds + c + 1)), __fmul_rn(2.f * v.y, __ldg(ds + N + c + 1)));
    Elem<T>::store2(gc + 2 * i, g0, g1);
  }
}

// dx rows: da = sum_t shift_{-t}(gc) @ w_t^T for a 64-row x 64-column (of K)
// tile, then the prologue's backward; dmul/dadd partial rows.
template <typename T, int TAPS, bool APPLY>
__global__ void __launch_bounds__(kThreads)
    dx_kernel(const T* __restrict__ gc, const T* __restrict__ w, const T* __restrict__ x,
              const float* __restrict__ mul, const float* __restrict__ add, T* __restrict__ dx,
              float* __restrict__ part, Geom g, int K, int N) {
  constexpr int PA = kChunk + Elem<T>::kPad, S = stages<T>();
  __shared__ __align__(16) T As[S][kTile * PA];
  __shared__ __align__(16) T Bs[S][kTile * PA];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.x * kTile, c_lim = min(kTile, K - c0);
  const int n_steps = (N + kChunk - 1) / kChunk, per_tile = TAPS * n_steps;
  const int tiles = (g.M + kTile - 1) / kTile;
  const int mine = tiles > (int)blockIdx.y ? (tiles - 1 - blockIdx.y) / gridDim.y + 1 : 0;
  const int total = mine * per_tile;
  const Geom wg{K, 1, 1};

  auto issue = [&](int s, int buf) {
    const int r0 = (blockIdx.y + (s / per_tile) * gridDim.y) * kTile, st = s % per_tile;
    const int t = st / n_steps, k0 = (st - t * n_steps) * kChunk;
    int dy, dx_;
    tap_shift(t, TAPS, -1, dy, dx_);
    load_tile<T, kTile, kChunk, TAPS>(As[buf], PA, gc, N, r0, g, dy, dx_, k0, N);
    // B(k = n, col = c) = w_t[c, n]: rows c of w_t, a chunk of its n.
    load_tile<T, kTile, kChunk, 1>(Bs[buf], PA, w + (size_t)t * K * N, N, c0, wg, 0, 0, k0, N);
  };

  float acc[kNt][4], dm[kNt][2], da[kNt][2];
  zero(acc);
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) dm[nt][0] = dm[nt][1] = da[nt][0] = da[nt][1] = 0.f;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < total) issue(i, i);
    fhi::cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    const int buf = s % S;
    cp_async_wait<S - 2>();
    __syncthreads();
    if (s + S - 1 < total) issue(s + S - 1, (s + S - 1) % S);
    fhi::cp_async_commit();
    fhi::warp_mma<kNt, false, false>(acc, As[buf] + warp * 16 * PA, PA, Bs[buf], PA, kChunk, c_lim,
                                     lane);
    if ((s + 1) % per_tile == 0) {
      const int r0 = (blockIdx.y + (s / per_tile) * gridDim.y) * kTile + warp * 16 + gq;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int c = c0 + nt * 8 + 2 * tig;
        if (c >= K) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= g.M) continue;
          float v0 = acc[nt][2 * h], v1 = acc[nt][2 * h + 1];
          if (APPLY) {
            const float2 xv = load2(x + (size_t)r * K + c);
            const float m0 = __ldg(mul + c), m1 = __ldg(mul + c + 1);
            const float p0 = __fadd_rn(__fmul_rn(xv.x, m0), __ldg(add + c));
            const float p1 = __fadd_rn(__fmul_rn(xv.y, m1), __ldg(add + c + 1));
            const float t0 = p0 > 0.f ? v0 : 0.f, t1 = p1 > 0.f ? v1 : 0.f;
            dm[nt][0] += t0 * xv.x;
            dm[nt][1] += t1 * xv.y;
            da[nt][0] += t0;
            da[nt][1] += t1;
            v0 = t0 * m0;
            v1 = t1 * m1;
          }
          Elem<T>::store2(dx + (size_t)r * K + c, v0, v1);
        }
      }
      zero(acc);
    }
  }
  if (APPLY) write_partials(dm, da, part, blockIdx.y, c0, K);
}

// dw partials: CTA (N tile, tap x K tile, row group) adds shift_t(a)^T gc over
// its 32-row steps, a recomputed from x with the prologue.
template <typename T, int TAPS, bool APPLY>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const T* __restrict__ x, const float* __restrict__ mul,
              const float* __restrict__ add, const T* __restrict__ gc, float* __restrict__ part,
              Geom g, int K, int N) {
  constexpr int P = kTile + Elem<T>::kPad, S = stages<T>();
  __shared__ __align__(16) T As[S][kChunk * P];
  __shared__ __align__(16) T Gs[S][kChunk * P];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tig = lane & 3;
  const int k_tiles = (K + kTile - 1) / kTile;
  const int t = blockIdx.y / k_tiles, c0 = (blockIdx.y - t * k_tiles) * kTile;
  const int n0 = blockIdx.x * kTile, n_lim = min(kTile, N - n0);
  const int steps = (g.M + kChunk - 1) / kChunk;
  const int total = steps > (int)blockIdx.z ? (steps - 1 - blockIdx.z) / gridDim.z + 1 : 0;
  const Geom rows{g.M, 1, 1};
  int dy, dx;
  tap_shift(t, TAPS, 1, dy, dx);

  auto issue = [&](int s, int buf) {
    const int r0 = (blockIdx.z + s * gridDim.z) * kChunk;
    load_tile<T, kChunk, kTile, TAPS>(As[buf], P, x, K, r0, g, dy, dx, c0, K);
    load_tile<T, kChunk, kTile, 1>(Gs[buf], P, gc, N, r0, rows, 0, 0, n0, N);
  };

  float acc[kNt][4];
  zero(acc);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < total) issue(i, i);
    fhi::cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    const int buf = s % S;
    cp_async_wait<S - 2>();
    if (APPLY)
      prologue_tile<T, kChunk, kTile, TAPS>(As[buf], P, (blockIdx.z + s * gridDim.z) * kChunk, g,
                                            dy, dx, c0, K, mul, add);
    __syncthreads();
    if (s + S - 1 < total) issue(s + S - 1, (s + S - 1) % S);
    fhi::cp_async_commit();
    // dw[c, n] += sum over the step's rows p of a[p, c] gc[p, n].
    if (warp * 16 < K - c0)
      fhi::warp_mma<kNt, true, true>(acc, As[buf] + warp * 16, P, Gs[buf], P, kChunk, n_lim, lane);
  }
  float* out = part + ((size_t)blockIdx.z * TAPS + t) * K * N;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    const int n = n0 + nt * 8 + 2 * tig;
    if (n >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + warp * 16 + gq + 8 * h;
      if (c < K) Elem<float>::store2(out + (size_t)c * N + n, acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// ---- launchers -----------------------------------------------------------------

// x (M, K), w (TAPS, K, N), y (M, N): all T; mul, add (K,) fp32 or null (no
// prologue). part (tile_groups(M, N), 2, N) fp32 scratch; s (2, N) fp32 out.
template <typename T, int TAPS, bool APPLY>
int launch_fwd_t(const void* x, const void* w, const float* mul, const float* add, void* y,
                 float* part, float* s, Geom g, int K, int N, cudaStream_t st) {
  const int groups = tile_groups(g.M, N);
  fwd_kernel<T, TAPS, APPLY><<<dim3(ceil_div(N, kTile), groups), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), mul, add, static_cast<T*>(y), part, g, K,
      N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows<<<ceil_div(2 * N, 32), dim3(32, 8), 0, st>>>(part, groups, 2 * N, s);
  return (int)cudaGetLastError();
}

// x (M, K), w (TAPS, K, N), y, dy (M, N): T. mul, add (K,) fp32 or null (APPLY
// without). ds (2, N) fp32 = [ds1; ds2]. Scratch: gc (M, N) T, part_x
// (tile_groups(M, K), 2, K) and part_w (dw_groups(M, K, N, TAPS), TAPS, K, N)
// fp32. Out: dx (M, K) T, dw (TAPS, K, N) fp32, dmd (2, K) fp32 = [dmul;
// dadd] (with APPLY only).
template <typename T, int TAPS, bool APPLY>
int launch_bwd_t(const void* x, const void* w, const float* mul, const float* add, const void* y,
                 const void* dy, const float* ds, void* gc, void* dx, float* dw, float* dmd,
                 float* part_x, float* part_w, Geom g, int K, int N, cudaStream_t st) {
  const size_t pairs = (size_t)g.M * N / 2;
  const int blocks = (int)((pairs + 255) / 256 < 8192 ? (pairs + 255) / 256 : 8192);
  gc_kernel<T><<<blocks > 0 ? blocks : 1, 256, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y), ds, static_cast<T*>(gc), pairs, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int gx = tile_groups(g.M, K);
  dx_kernel<T, TAPS, APPLY><<<dim3(ceil_div(K, kTile), gx), kThreads, 0, st>>>(
      static_cast<const T*>(gc), static_cast<const T*>(w), static_cast<const T*>(x), mul, add,
      static_cast<T*>(dx), part_x, g, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int gw = dw_groups(g.M, K, N, TAPS);
  dw_kernel<T, TAPS, APPLY><<<dim3(ceil_div(N, kTile), TAPS * ceil_div(K, kTile), gw), kThreads, 0,
                              st>>>(static_cast<const T*>(x), mul, add, static_cast<const T*>(gc),
                                    part_w, g, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (APPLY) {
    reduce_rows<<<ceil_div(2 * K, 32), dim3(32, 8), 0, st>>>(part_x, gx, 2 * K, dmd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int cols = TAPS * K * N;
  reduce_rows<<<ceil_div(cols, 32), dim3(32, 8), 0, st>>>(part_w, gw, cols, dw);
  return (int)cudaGetLastError();
}

}  // namespace cbn
