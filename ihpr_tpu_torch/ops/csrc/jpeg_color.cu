// libjpeg's chroma upsampling and YCbCr -> RGB conversion over a batch of
// decoded JPEG planes, with a plain C interface for ctypes
// (ihpr_tpu_torch/ops/jpeg_color.py).
//
// nvJPEG decodes each frame to planar YCbCr at its stored subsampling
// (ops/csrc/nvjpeg_codec.cu, NVJPEG_OUTPUT_YUV); this kernel does the rest
// with libjpeg's integer arithmetic, so that the card's pixels are the ones
// libjpeg (cv2, PIL, the JAX package's native/warp.cc) gives:
//
// - "fancy" upsampling (jdsample.c): h2v2 (4:2:0) forms the column sums
//   3 * nearer row + farther row, then 3 * nearer sum + farther sum, + 8
//   for the even output column and + 7 for the odd, >> 4; h2v1 (4:2:2)
//   does 3 * nearer + farther, + 1 / + 2, >> 2. At the image's edges the
//   missing neighbour is the edge sample itself (libjpeg's context rows
//   replicate the first and last rows, and its first and last columns
//   reduce to that). 4:4:4 and grayscale take no upsampling.
// - colour conversion (jdcolor.c, ycc_rgb_convert): 16-bit fixed point,
//   R = Y + ((FIX(1.402) x + 1/2) >> 16), B = Y + ((FIX(1.772) x' + 1/2) >> 16),
//   G = Y + ((-FIX(0.34414) x' - FIX(0.71414) x + 1/2) >> 16), with
//   x = Cr - 128, x' = Cb - 128 and an arithmetic shift, then a clamp to
//   [0, 255]. Grayscale gives R = G = B = Y.
//
// Not the port of a Pallas kernel: the JAX package decodes on the host
// with libjpeg, and this kernel computes what libjpeg computes after its
// IDCT. It is bound by bytes (each plane read once, the RGB written once:
// 4.5 bytes a 4:2:0 pixel, ~30 integer operations), and kept simple: one
// thread writes one output row's pixel pair (the two columns that share a
// chroma column), so neighbouring threads touch neighbouring bytes; grid
// (pairs / 128, rows, images) over the batch's largest frame, one launch a
// batch. Returns 0 or 1000 + a cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMetaFields = 8;  // per image, in jpeg_color.py's order

// Image i's layout: byte offsets of its Y, Cb and Cr planes in `planes`
// and of its RGB frame in `out`, its height and width, and its chroma
// subsampling (hs, vs): (1, 1), (2, 1) or (2, 2), or (0, 0) for grayscale.
struct Meta {
  int64_t y, cb, cr, rgb;
  int h, w, hs, vs;
};

__device__ __forceinline__ Meta load_meta(const int64_t* meta, int i) {
  const int64_t* m = meta + static_cast<int64_t>(i) * kMetaFields;
  return {m[0], m[1], m[2], m[3], static_cast<int>(m[4]), static_cast<int>(m[5]),
          static_cast<int>(m[6]), static_cast<int>(m[7])};
}

__device__ __forceinline__ uint8_t clamp255(int v) { return static_cast<uint8_t>(min(max(v, 0), 255)); }

__device__ __forceinline__ void ycc_to_rgb(int y, int cb, int cr, uint8_t* rgb) {
  const int x = cr - 128, xb = cb - 128;
  rgb[0] = clamp255(y + ((91881 * x + 32768) >> 16));
  rgb[1] = clamp255(y + ((-22554 * xb - 46802 * x + 32768) >> 16));
  rgb[2] = clamp255(y + ((116130 * xb + 32768) >> 16));
}

// The chroma samples of output columns 2c and 2c + 1 of output row r, from
// a chroma plane of ch x cw samples (libjpeg's fancy upsampling).
__device__ __forceinline__ void upsample_pair(const uint8_t* c, int r, int col, int ch, int cw, int hs, int vs,
                                              int* even, int* odd) {
  if (hs == 1) {  // 4:4:4: the pair is two chroma columns
    *even = c[static_cast<int64_t>(r) * cw + 2 * col];
    *odd = (2 * col + 1 < cw) ? c[static_cast<int64_t>(r) * cw + 2 * col + 1] : 0;
    return;
  }
  const int left = max(col - 1, 0), right = min(col + 1, cw - 1);
  if (vs == 1) {  // h2v1
    const uint8_t* row = c + static_cast<int64_t>(r) * cw;
    const int near = 3 * row[col];
    *even = (near + row[left] + 1) >> 2;
    *odd = (near + row[right] + 2) >> 2;
    return;
  }
  // h2v2: the nearer chroma row, and the row above (even output rows) or
  // below (odd), replicated at the plane's first and last rows.
  const int i = r >> 1;
  const int far = (r & 1) ? min(i + 1, ch - 1) : max(i - 1, 0);
  const uint8_t* n = c + static_cast<int64_t>(i) * cw;
  const uint8_t* f = c + static_cast<int64_t>(far) * cw;
  const int here = 3 * n[col] + f[col];
  *even = (3 * here + 3 * n[left] + f[left] + 8) >> 4;
  *odd = (3 * here + 3 * n[right] + f[right] + 7) >> 4;
}

__global__ void __launch_bounds__(kThreads) color_kernel(const uint8_t* __restrict__ planes,
                                                         const int64_t* __restrict__ meta,
                                                         uint8_t* __restrict__ out) {
  const Meta m = load_meta(meta, blockIdx.z);
  const int r = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;  // the pair's chroma column
  const int x0 = 2 * col;
  if (r >= m.h || x0 >= m.w) return;
  const uint8_t* yrow = planes + m.y + static_cast<int64_t>(r) * m.w;
  uint8_t* dst = out + m.rgb + (static_cast<int64_t>(r) * m.w + x0) * 3;
  const bool two = x0 + 1 < m.w;
  if (m.hs == 0) {  // grayscale
    for (int k = 0; k < (two ? 2 : 1); ++k) dst[3 * k] = dst[3 * k + 1] = dst[3 * k + 2] = yrow[x0 + k];
    return;
  }
  const int ch = (m.h + m.vs - 1) / m.vs, cw = (m.w + m.hs - 1) / m.hs;
  int cb[2], cr[2];
  upsample_pair(planes + m.cb, r, col, ch, cw, m.hs, m.vs, &cb[0], &cb[1]);
  upsample_pair(planes + m.cr, r, col, ch, cw, m.hs, m.vs, &cr[0], &cr[1]);
  ycc_to_rgb(yrow[x0], cb[0], cr[0], dst);
  if (two) ycc_to_rgb(yrow[x0 + 1], cb[1], cr[1], dst + 3);
}

}  // namespace

extern "C" {

// Converts n frames at once: `meta` is a device array of n * 8 int64 (the
// fields of Meta, in order), max_h and max_w the batch's largest height
// and width, on stream.
int ihpr_jpeg_color(const uint8_t* planes, const int64_t* meta, int n, int max_h, int max_w, uint8_t* out,
                    void* stream) {
  if (n <= 0) return 0;
  const int pairs = (max_w + 1) / 2;
  dim3 grid((pairs + kThreads - 1) / kThreads, max_h, n);
  color_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(planes, meta, out);
  cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : 1000 + static_cast<int>(err);
}

}  // extern "C"
