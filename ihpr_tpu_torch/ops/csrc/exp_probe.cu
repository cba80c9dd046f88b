// The exp-pass probe (P1) for Hopper (sm_90a): one streaming read of an fp32
// volume, cut into blocks, with one of six reductions per block.
//
// Replaces the TPU kernel tools/exp_probe.py:_kernel (launched by build).
//
// What it computes. x is (B, NCHUNK * CHUNK, LANES) fp32, contiguous; block
// (b, c) is x[b, c*CHUNK : (c+1)*CHUNK, :], CHUNK * LANES contiguous values.
// For each block the kernel writes one fp32 partial r:
//   read     v[0, 0] (every value is still consumed: see below)
//   sum      sum v
//   maxsum   max v + sum v
//   expsum   sum ex2.approx.ftz.f32((v - 3) * log2e), the exp form K1 and K3 use
//   exp2sum  sum ex2.approx.ftz.f32(v - 3): expsum without the *log2e multiply
//   bexpsum  v rounded to bf16 (cvt.rn, two lanes at a time), t = v - 3 in
//            bf16, u = t * log2e in bf16, then ex2.approx.ftz.bf16x2 on the
//            pair and an fp32 sum. log2e is split into two bf16 constants
//            (hi + lo, u = fma(t, hi, t * lo)): hi alone is 0.18% off and
//            would bias every exp by ~1% at t ~ -6.
// and the (8, 128) token the TPU kernel's output holds after its sequential
// grid, written by the CTA of the last block (b = B-1, c = NCHUNK-1): for
// read that block's v[:8, :128], for the other modes its r, broadcast.
//
// The read mode must use every loaded value, or nvcc drops the loads and the
// "read floor" measures nothing: each value's bits are compared against a
// NaN pattern that no arithmetic produces, the hits are OR-ed over the CTA,
// and a hit would store NaN in place of v[0, 0]. That is one integer compare
// per value, the cheapest use there is.
//
// Design. One CTA of 256 threads per block; each thread walks the block in
// 16-byte loads (float4 i = tid, tid + 256, ...), four loads in flight before
// any is used, and keeps its own partial. The CTA merges the partials with a
// warp shuffle tree, then the 8 warp results in warp order in shared memory,
// so a run is bitwise repeatable. Offsets are 64-bit: the flagship volume
// (128, 4096, 1152) is 2.42 GB.
//
// What bounds it on an H100. One read of the volume: 2.416 GB at 3.35 TB/s
// is 0.721 ms. The exps (604M per pass) take ~0.16 ms at 16 MUFU results
// per clock per SM, so every mode should sit near the read floor; the probe
// measures whether it does, and whether the bf16x2 ex2 halves the MUFU work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // float4 loads in flight per thread
constexpr uint32_t kSentinel = 0x7fc0dbadu;  // a quiet NaN no randn value or arithmetic makes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLog2eHi = 1.4453125f;           // log2e rounded to bf16
constexpr float kLog2eLo = kLog2e - kLog2eHi;    // the rest, itself rounded to bf16 below

enum Mode { kRead = 0, kSum, kMaxSum, kExpSum, kExp2Sum, kBexpSum };

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ __nv_bfloat162 ex2_bf16x2(__nv_bfloat162 x) {
  uint32_t in = *reinterpret_cast<uint32_t*>(&x), out;
  asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(out) : "r"(in));
  return *reinterpret_cast<__nv_bfloat162*>(&out);
}

// Per-thread state: s the running sum (or the sentinel hits for read), m the
// running max (maxsum only).
template <int MODE>
struct Acc {
  float s, m;
  uint32_t hit;

  __device__ __forceinline__ Acc() : s(0.f), m(-__builtin_huge_valf()), hit(0u) {}

  __device__ __forceinline__ void add(float4 v) {
    if (MODE == kRead) {
      hit |= (__float_as_uint(v.x) == kSentinel) | (__float_as_uint(v.y) == kSentinel) |
             (__float_as_uint(v.z) == kSentinel) | (__float_as_uint(v.w) == kSentinel);
    } else if (MODE == kSum) {
      s += ((v.x + v.y) + (v.z + v.w));
    } else if (MODE == kMaxSum) {
      m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
      s += ((v.x + v.y) + (v.z + v.w));
    } else if (MODE == kExpSum) {
      s += ((ex2((v.x - 3.f) * kLog2e) + ex2((v.y - 3.f) * kLog2e)) +
            (ex2((v.z - 3.f) * kLog2e) + ex2((v.w - 3.f) * kLog2e)));
    } else if (MODE == kExp2Sum) {
      s += ((ex2(v.x - 3.f) + ex2(v.y - 3.f)) + (ex2(v.z - 3.f) + ex2(v.w - 3.f)));
    } else {  // kBexpSum
      const __nv_bfloat162 three = __float2bfloat162_rn(3.f);
      const __nv_bfloat162 hi = __float2bfloat162_rn(kLog2eHi);
      const __nv_bfloat162 lo = __float2bfloat162_rn(kLog2eLo);
      __nv_bfloat162 t0 = __hsub2(__floats2bfloat162_rn(v.x, v.y), three);
      __nv_bfloat162 t1 = __hsub2(__floats2bfloat162_rn(v.z, v.w), three);
      const float2 e0 = __bfloat1622float2(ex2_bf16x2(__hfma2(t0, hi, __hmul2(t0, lo))));
      const float2 e1 = __bfloat1622float2(ex2_bf16x2(__hfma2(t1, hi, __hmul2(t1, lo))));
      s += ((e0.x + e0.y) + (e1.x + e1.y));
    }
  }
};

// The CTA's merge of one float per thread, in a fixed order; the result is
// valid in thread 0. red holds kWarps floats.
template <bool MAX>
__device__ __forceinline__ float cta_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused
  return r;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const float* __restrict__ x, float* __restrict__ partials, float* __restrict__ token,
                 int chunk, int lanes, int last_block) {
  __shared__ float red[kWarps];
  __shared__ float r_out;
  const size_t n = (size_t)chunk * lanes;  // values in a block, a multiple of 4
  const int n4 = (int)(n / 4);
  const float* blk = x + (size_t)blockIdx.x * n;
  const float4* v4 = reinterpret_cast<const float4*>(blk);

  Acc<MODE> acc;
  int i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < n4; i += kUnroll * kThreads) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(v4 + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc.add(v[u]);
  }
  for (; i < n4; i += kThreads) acc.add(__ldcs(v4 + i));

  float r;
  if (MODE == kRead) {
    const int hit = __syncthreads_or(acc.hit);
    r = hit ? __uint_as_float(kSentinel) : blk[0];
  } else {
    r = cta_reduce<false>(acc.s, red);
    if (MODE == kMaxSum) r = cta_reduce<true>(acc.m, red) + r;
  }
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = r;
    r_out = r;
  }
  if ((int)blockIdx.x != last_block) return;
  __syncthreads();
  for (int e = threadIdx.x; e < 8 * 128; e += kThreads)
    token[e] = MODE == kRead ? blk[(size_t)(e / 128) * lanes + e % 128] : r_out;
}

template <int MODE>
int launch(const float* x, float* partials, float* token, int blocks, int chunk, int lanes,
           cudaStream_t stream) {
  probe_kernel<MODE><<<blocks, kThreads, 0, stream>>>(x, partials, token, chunk, lanes, blocks - 1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (blocks * chunk * lanes) fp32, 16-byte aligned, chunk * lanes a multiple
// of 4, chunk >= 8, lanes >= 128; block i is values [i * chunk * lanes, +chunk
// * lanes). Writes partials (blocks,) and token (8, 128), fp32. mode: 0 read,
// 1 sum, 2 maxsum, 3 expsum, 4 exp2sum, 5 bexpsum. Returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for an unknown mode).
int ihpr_exp_probe(const float* x, float* partials, float* token, int blocks, int chunk, int lanes,
                   int mode, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRead: return launch<kRead>(x, partials, token, blocks, chunk, lanes, st);
    case kSum: return launch<kSum>(x, partials, token, blocks, chunk, lanes, st);
    case kMaxSum: return launch<kMaxSum>(x, partials, token, blocks, chunk, lanes, st);
    case kExpSum: return launch<kExpSum>(x, partials, token, blocks, chunk, lanes, st);
    case kExp2Sum: return launch<kExp2Sum>(x, partials, token, blocks, chunk, lanes, st);
    case kBexpSum: return launch<kBexpSum>(x, partials, token, blocks, chunk, lanes, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
