// fp32 matrix products on the tensor cores: the 3xTF32 split, and its
// mma.sync m16n8k8 form.
//
// TF32 keeps 10 explicit mantissa bits, so one TF32 pass over fp32
// operands errs by ~2^-11 of each product. Split each operand x into
// hi = tf32(x) (round to nearest, ties away) and lo = tf32(x - hi): x - hi
// is exact in fp32 and at most 2^-11 |x|, so |x - (hi + lo)| <= 2^-22 |x|.
// Then a*b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b (the dropped lo_a lo_b is
// <= 2^-22 |a b|), three TF32 products accumulated in fp32, the small ones
// first. Per product the error is ~2^-21 relative, where one TF32 pass
// gives 2^-11: fp32 "highest" on the tensor cores' TF32 rate (494.7 dense
// TFLOP/s on an H100 SXM, a third of it per 3xTF32 product, against 66.9
// for fp32 FFMA).
//
// The fused head's fp32 kernels (K1-fp32, fused_head_integral_fwd_f32.cu;
// K2-fp32, _bwd_f32.cu) take the split from here and run the three passes
// on wgmma (fused_head_f32.cuh): wgmma TF32 alone reached 0.96 of dense
// TF32 on the card, mma.sync 0.56 (PERF.md §6), which is what held their
// earlier mma.sync design. mma_tf32 / mma3 below stay for
// tf32x3_selftest.cu, which holds the split and one tile's product against
// float64 and measures both instructions' rates.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX
// ISA), lane = 4 g + t (wgmma m64nNk8's TF32 A fragment and accumulator
// take the same layout in each warp's 16 rows):
//   A (16 x 8): a[0] = A(g, t), a[1] = A(g + 8, t), a[2] = A(g, t + 4), a[3] = A(g + 8, t + 4)
//   B (8 x 8):  b0 = B(t, g), b1 = B(t + 4, g)
//   D (16 x 8): d[0] = D(g, 2t), d[1] = D(g, 2t + 1), d[2] = D(g + 8, 2t), d[3] = D(g + 8, 2t + 1)
// A D tile becomes the A fragment of a product over its 8 columns, in the
// same thread, by relabelling k: k-slot t is column 2t, k-slot t + 4 is
// column 2t + 1 (a = d[0], d[2], d[1], d[3]: as_a below), and B's k-slots
// follow (b0 = B(2t, g), b1 = B(2t + 1, g)). A sum over k does not care
// about the order of its terms.

#pragma once

#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for every finite x (a carry out of the mantissa moves
// the exponent up, as rounding does), in two integer operations at the ALU's
// full rate; cvt is a conversion, issued at a fraction of it, and with it
// the kernels spent more time splitting than multiplying (PERF.md §6).
// tf32x3_selftest.cu holds the two bitwise equal. A NaN may come out as an
// infinity; the kernels' inputs are finite.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo), both TF32 bit patterns (the low 13 bits zero).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

// One m16n8k8 TF32 product. Not volatile: it has outputs and no side
// effect, so the compiler may interleave independent ones.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[m][n] += A_m B_n in 3xTF32 for M A tiles and the first n_lim of N B
// tiles, all given split (b[n] = {b0, b1}). Each of the three passes runs
// over every (m, n) before the next, small products first, so the three
// MMAs into one accumulator are M x N products apart instead of back to
// back: an MMA that must wait for the one before it stalls the warp.
template <int M, int N>
__device__ __forceinline__ void mma3(float (&d)[M][N][4], const uint32_t (&ah)[M][4], const uint32_t (&al)[M][4],
                                     const uint32_t (&bh)[N][2], const uint32_t (&bl)[N][2], int n_lim) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_lim)
#pragma unroll
      for (int m = 0; m < M; ++m) mma_tf32(d[m][n], al[m], bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_lim)
#pragma unroll
      for (int m = 0; m < M; ++m) mma_tf32(d[m][n], ah[m], bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_lim)
#pragma unroll
      for (int m = 0; m < M; ++m) mma_tf32(d[m][n], ah[m], bh[n][0], bh[n][1]);
}

// B tile n's two fp32 values, split.
__device__ __forceinline__ void split_b(float b0, float b1, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  split(b0, bh[0], bl[0]);
  split(b1, bh[1], bl[1]);
}

// The A fragment over a D tile's 8 columns (k relabelled as above).
__device__ __forceinline__ void as_a(const float (&d)[4], float (&a)[4]) {
  a[0] = d[0];
  a[1] = d[2];
  a[2] = d[1];
  a[3] = d[3];
}

}  // namespace tf32x3
