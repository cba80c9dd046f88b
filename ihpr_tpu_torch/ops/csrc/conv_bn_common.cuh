// The fixed-order reduction every conv + BatchNorm-statistics kernel ends
// with: K5/K6 (matmul_bn_hopper.cuh, bf16; matmul_bn_f32.cuh, fp32) and
// K7/K8 (conv3_hopper.cuh, bf16; conv3_f32.cuh, fp32) write one partial row
// per CTA (column sums, or a block of dw), and reduce_rows adds the rows in
// a fixed order. Nothing is atomic, so every result is bitwise the same from
// run to run.

#pragma once

#include <cuda_runtime.h>

namespace cbn {

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

}  // namespace cbn
