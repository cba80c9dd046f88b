// Integral soft-argmax over an existing logits volume, forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ihpr_tpu/ops/integral_pallas.py:_fwd_kernel
// (launched by _fwd_call, body in _online_stats_tail).
//
// What it computes. vol is one (HW, J*D) logits plane per sample b (the
// head's NHWC heatmap, free-reshaped); lane l of row r is joint l div D at
// depth bin z = l mod D and pixel x = r mod width, y = r div width. For
// each (b, j): p = softmax of the joint's HW*D logits, and
//     coords[b, j] = (sum p x, sum p y, sum p z),
// with the joint's max m and normalizer s = sum exp(v - m), which the
// backward (K4) reads. bf16 input is widened to fp32 in registers; all
// arithmetic is fp32.
//
// Design. Two kernels, no atomics, so two runs give bitwise-equal results.
// 1. stats_kernel, grid (row chunk, sample). Threads walk the chunk as
//    integral_volume_common.cuh lays out: coalesced 16-byte loads along the
//    row, 8 rows in flight per thread. Each thread keeps per-lane online
//    softmax state (max, sum e, sum e x, sum e y) and rescales it once per
//    8 rows (1.125 exp per logit). Threads that share lanes (ty > 1, when
//    J*D is short) merge in shared memory in a fixed tree order. The CTA
//    writes one (m, s, sx, sy) partial per lane and chunk: 16 bytes per lane
//    per >= 256 rows, under 4% of the bf16 volume's bytes.
// 2. merge_kernel, one warp per (sample, joint): folds the joint's
//    chunks x D partials (sum e z = s z per lane) in a fixed order, then a
//    shuffle tree, and writes coords, m and s.
//
// What differs from the TPU kernel. The TPU walks a sample's row chunks in
// grid order and carries the running state between grid steps; CTAs run in
// no order, so chunks are independent and a second pass merges them. The
// TPU kernel used one max shared by all joints of a sample, which can
// underflow a joint whose logits sit ~80 below another's; here the max is
// per lane, then per joint, which is exact. The TPU needed J*D 128-aligned
// (joints padded with -1e30); this kernel takes any J, D and HW, with
// narrower vectors (down to one lane) where a row is not 16-byte aligned.
// Offsets are 64-bit: an fp32 flagship volume (128 x 4096 x 1152) is 2.4 GB.
//
// What bounds it on an H100. One read of the volume: 1.21 GB in bf16 at
// (128, 4096, 1152), ~0.4 ms at 3 TB/s; 1.125 ex2 per logit is ~0.7 G
// SFU ops, ~0.2 ms, so it is bandwidth bound if enough loads are in
// flight (8 x 16 bytes per thread).

#include "integral_volume_common.cuh"

namespace {

using namespace ivol;

// (m, s, sx, sy) <- merge with b; states are (max, sum e, sum e x, sum e y).
__device__ __forceinline__ void merge4(float4& a, const float4& b) {
  const float m = fmaxf(a.x, b.x);
  if (m == neg_inf()) return;  // both empty
  const float ca = ex2((a.x - m) * kLog2e), cb = ex2((b.x - m) * kLog2e);
  a = make_float4(m, a.y * ca + b.y * cb, a.z * ca + b.z * cb, a.w * ca + b.w * cb);
}

template <bool kBf16, int VEC>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const typename Elem<kBf16>::S* __restrict__ vol, float4* __restrict__ part,
                 int hw, int width, int jd, Layout L) {
  using S = typename Elem<kBf16>::S;
  extern __shared__ float4 red[];  // [ty][tx * VEC], only when L.ty > 1
  const int tx = threadIdx.x % L.tx, ty = threadIdx.x / L.tx;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int r_begin = chunk * L.chunk, r_end = min(hw, r_begin + L.chunk);
  const S* vol_b = vol + (size_t)b * hw * jd;
  float4* part_c = part + ((size_t)b * L.nchunks + chunk) * jd;

  for (int k = 0; k < L.vpt; ++k) {
    const int v = tx + k * L.tx;
    const bool active = v < L.nv;
    float m[VEC], s[VEC], sx[VEC], sy[VEC];
#pragma unroll
    for (int l = 0; l < VEC; ++l) m[l] = neg_inf(), s[l] = sx[l] = sy[l] = 0.f;

    if (active) {
      const S* col = vol_b + (size_t)v * VEC;
      for (int r0 = r_begin + ty; r0 < r_end; r0 += kRowBatch * L.ty) {
        Pack<S, VEC> vals[kRowBatch];
        float xs[kRowBatch], ys[kRowBatch];
#pragma unroll
        for (int i = 0; i < kRowBatch; ++i) {
          const int r = r0 + i * L.ty;
          if (r < r_end) vals[i] = *reinterpret_cast<const Pack<S, VEC>*>(col + (size_t)r * jd);
          const int y = r / width;
          ys[i] = (float)y;
          xs[i] = (float)(r - y * width);
        }
#pragma unroll
        for (int l = 0; l < VEC; ++l) {
          float u[kRowBatch];
          float mx = neg_inf();
#pragma unroll
          for (int i = 0; i < kRowBatch; ++i) {
            u[i] = r0 + i * L.ty < r_end ? Elem<kBf16>::to_float(vals[i].v[l]) : neg_inf();
            mx = fmaxf(mx, u[i]);
          }
          const float mn = fmaxf(m[l], mx);
          if (mn == neg_inf()) continue;
          const float c = ex2((m[l] - mn) * kLog2e);  // 0 while the state is empty
          float s_ = s[l] * c, sx_ = sx[l] * c, sy_ = sy[l] * c;
#pragma unroll
          for (int i = 0; i < kRowBatch; ++i) {
            const float e = ex2((u[i] - mn) * kLog2e);  // 0 for masked rows
            s_ += e;
            sx_ = fmaf(e, xs[i], sx_);
            sy_ = fmaf(e, ys[i], sy_);
          }
          m[l] = mn, s[l] = s_, sx[l] = sx_, sy[l] = sy_;
        }
      }
    }

    if (L.ty == 1) {
      if (active) {
#pragma unroll
        for (int l = 0; l < VEC; ++l) part_c[v * VEC + l] = make_float4(m[l], s[l], sx[l], sy[l]);
      }
      continue;
    }
    // Threads with the same tx hold the same lanes: merge over ty in a
    // fixed tree order (deterministic), then row ty == 0 writes.
    const int row = L.tx * VEC;
#pragma unroll
    for (int l = 0; l < VEC; ++l) red[ty * row + tx * VEC + l] = make_float4(m[l], s[l], sx[l], sy[l]);
    __syncthreads();
    int half = 1;
    while (half < L.ty) half <<= 1;
    for (half >>= 1; half > 0; half >>= 1) {
      if (ty < half && ty + half < L.ty) {
#pragma unroll
        for (int l = 0; l < VEC; ++l) merge4(red[ty * row + tx * VEC + l], red[(ty + half) * row + tx * VEC + l]);
      }
      __syncthreads();
    }
    if (ty == 0 && active) {
#pragma unroll
      for (int l = 0; l < VEC; ++l) part_c[v * VEC + l] = red[tx * VEC + l];
    }
    __syncthreads();  // red is refilled for the next vector
  }
}

struct Stats {
  float m, s, sx, sy, sz;
};

__device__ __forceinline__ void merge(Stats& a, const Stats& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == neg_inf()) return;
  const float ca = ex2((a.m - m) * kLog2e), cb = ex2((b.m - m) * kLog2e);
  a.s = a.s * ca + b.s * cb;
  a.sx = a.sx * ca + b.sx * cb;
  a.sy = a.sy * ca + b.sy * cb;
  a.sz = a.sz * ca + b.sz * cb;
  a.m = m;
}

constexpr int kMergeWarps = 4;

__global__ void __launch_bounds__(kMergeWarps * 32)
    merge_kernel(const float4* __restrict__ part, float* __restrict__ coords,
                 float* __restrict__ m_out, float* __restrict__ s_out, int batch, int J, int D,
                 int nchunks) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);  // (b, j), whole warp
  if (o >= batch * J) return;
  const int b = o / J, j = o - b * J, jd = J * D;
  const float4* p_b = part + (size_t)b * nchunks * jd + (size_t)j * D;
  Stats st = {neg_inf(), 0.f, 0.f, 0.f, 0.f};
  for (int i = lane; i < nchunks * D; i += 32) {
    const int c = i / D, z = i - c * D;
    const float4 p = p_b[(size_t)c * jd + z];
    merge(st, Stats{p.x, p.y, p.z, p.w, p.y * (float)z});
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats q;
    q.m = __shfl_xor_sync(0xffffffffu, st.m, off);
    q.s = __shfl_xor_sync(0xffffffffu, st.s, off);
    q.sx = __shfl_xor_sync(0xffffffffu, st.sx, off);
    q.sy = __shfl_xor_sync(0xffffffffu, st.sy, off);
    q.sz = __shfl_xor_sync(0xffffffffu, st.sz, off);
    merge(st, q);
  }
  if (lane == 0) {
    const float inv = 1.f / st.s;
    coords[o * 3 + 0] = st.sx * inv;
    coords[o * 3 + 1] = st.sy * inv;
    coords[o * 3 + 2] = st.sz * inv;
    m_out[o] = st.m;
    s_out[o] = st.s;
  }
}

template <bool kBf16, int VEC>
int launch(const void* vol, float4* part, float* coords, float* m, float* s, int batch, int hw,
           int width, int J, int D, cudaStream_t stream) {
  const int jd = J * D;
  const Layout L = make_layout(hw, jd, VEC);
  const size_t smem = L.ty > 1 ? (size_t)L.ty * L.tx * VEC * sizeof(float4) : 0;
  stats_kernel<kBf16, VEC><<<dim3(L.nchunks, batch), L.tx * L.ty, smem, stream>>>(
      static_cast<const typename Elem<kBf16>::S*>(vol), part, hw, width, jd, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<ceil_div(batch * J, kMergeWarps), kMergeWarps * 32, 0, stream>>>(
      part, coords, m, s, batch, J, D, L.nchunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row chunks per sample, so the caller can size the partials
// (batch, chunks, J*D) float4.
int ihpr_integral_volume_chunks(int hw, int jd, int vec) { return make_layout(hw, jd, vec).nchunks; }

// vol (batch, hw, J*D) contiguous, bf16 (is_bf16) or fp32, its base and row
// pitch aligned to vec elements (vec in {1, 2, 4, 8} bf16, {1, 2, 4} fp32,
// dividing J*D). Scratch part (batch, chunks, J*D) float4. Writes coords
// (batch, J, 3), m and s (batch, J), fp32. Returns the first cudaError_t
// of the two launches (0 on success; cudaErrorInvalidValue for a vec it
// does not take).
int ihpr_integral_volume_fwd(const void* vol, void* part, float* coords, float* m, float* s,
                             int batch, int hw, int width, int J, int D, int is_bf16, int vec,
                             void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float4*>(part);
  if (is_bf16) {
    switch (vec) {
      case 8: return launch<true, 8>(vol, p, coords, m, s, batch, hw, width, J, D, st);
      case 4: return launch<true, 4>(vol, p, coords, m, s, batch, hw, width, J, D, st);
      case 2: return launch<true, 2>(vol, p, coords, m, s, batch, hw, width, J, D, st);
      case 1: return launch<true, 1>(vol, p, coords, m, s, batch, hw, width, J, D, st);
    }
  } else {
    switch (vec) {
      case 4: return launch<false, 4>(vol, p, coords, m, s, batch, hw, width, J, D, st);
      case 2: return launch<false, 2>(vol, p, coords, m, s, batch, hw, width, J, D, st);
      case 1: return launch<false, 1>(vol, p, coords, m, s, batch, hw, width, J, D, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
