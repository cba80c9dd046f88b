// JPEG decode and encode on the card through nvJPEG, with a plain C
// interface for ctypes (ihpr_tpu_torch/data/jpeg.py).
//
// Not the port of a Pallas kernel: the JAX package decodes on the host
// (ihpr_tpu/data/pipeline.py:_load_image, cv2.imread; and the fused libjpeg
// decode + warp of native/warp.cc); this shim needs only the CUDA toolkit,
// not cv2 or libjpeg. nvJPEG's hybrid backend does the Huffman decode
// on the host and the IDCT, chroma upsampling and colour conversion on the
// card; the output is interleaved RGB (NVJPEG_OUTPUT_RGBI), the JAX
// package's channel order. The encoder writes baseline 4:2:0 JPEGs at the
// quality asked for, as cv2.imwrite does by default.
//
// The caller allocates every device buffer (torch.empty), passes PyTorch's
// current stream, and serialises the calls on one context (the decode and
// encode states are not thread-safe). Each function returns 0, an
// nvjpegStatus_t (1-99) or 1000 + a cudaError_t.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <new>

namespace {

struct Codec {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t batch_state = nullptr;  // nvjpegDecodeBatched
  nvjpegJpegState_t one_state = nullptr;    // nvjpegDecode
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  int batch_size = 0;  // the batch nvjpegDecodeBatchedInitialize last set
};

int cuda_status() {
  cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : 1000 + static_cast<int>(err);
}

int sync_status(cudaStream_t stream) {
  cudaError_t err = cudaStreamSynchronize(stream);
  return err == cudaSuccess ? cuda_status() : 1000 + static_cast<int>(err);
}

#define IHPR_NVJPEG(call)                                   \
  do {                                                      \
    nvjpegStatus_t s_ = (call);                             \
    if (s_ != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s_); \
  } while (0)

void destroy(Codec* c) {
  if (c->enc_params) nvjpegEncoderParamsDestroy(c->enc_params);
  if (c->enc_state) nvjpegEncoderStateDestroy(c->enc_state);
  if (c->one_state) nvjpegJpegStateDestroy(c->one_state);
  if (c->batch_state) nvjpegJpegStateDestroy(c->batch_state);
  if (c->handle) nvjpegDestroy(c->handle);
  delete c;
}

int create(Codec* c) {
  IHPR_NVJPEG(nvjpegCreateSimple(&c->handle));
  IHPR_NVJPEG(nvjpegJpegStateCreate(c->handle, &c->batch_state));
  IHPR_NVJPEG(nvjpegJpegStateCreate(c->handle, &c->one_state));
  IHPR_NVJPEG(nvjpegEncoderStateCreate(c->handle, &c->enc_state, nullptr));
  IHPR_NVJPEG(nvjpegEncoderParamsCreate(c->handle, &c->enc_params, nullptr));
  return 0;
}

nvjpegImage_t rgbi(unsigned char* base, int width) {
  nvjpegImage_t img = {};
  img.channel[0] = base;
  img.pitch[0] = static_cast<size_t>(width) * 3;
  return img;
}

}  // namespace

extern "C" {

// A new codec in *out, or an error (and *out null).
int ihpr_jpeg_create(void** out) {
  *out = nullptr;
  Codec* c = new (std::nothrow) Codec();
  if (c == nullptr) return static_cast<int>(NVJPEG_STATUS_ALLOCATOR_FAILURE);
  int err = create(c);
  if (err != 0) {
    destroy(c);
    return err;
  }
  *out = c;
  return 0;
}

void ihpr_jpeg_destroy(void* codec) {
  if (codec != nullptr) destroy(static_cast<Codec*>(codec));
}

// The frame's height and width from the JPEG header (the first component's,
// which is the full-resolution luma plane).
int ihpr_jpeg_info(void* codec, const unsigned char* data, size_t len, int* height, int* width) {
  Codec* c = static_cast<Codec*>(codec);
  int n_comp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT] = {};
  int heights[NVJPEG_MAX_COMPONENT] = {};
  IHPR_NVJPEG(nvjpegGetImageInfo(c->handle, data, len, &n_comp, &css, widths, heights));
  *height = heights[0];
  *width = widths[0];
  return 0;
}

// Decodes n JPEGs at once into RGBI images dst[i] of widths[i] * 3 bytes a
// row, on stream.
int ihpr_jpeg_decode_batch(void* codec, int n, const unsigned char* const* data, const size_t* lens,
                           unsigned char* const* dst, const int* widths, void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  if (n != c->batch_size) {
    IHPR_NVJPEG(nvjpegDecodeBatchedInitialize(c->handle, c->batch_state, n, 1, NVJPEG_OUTPUT_RGBI));
    c->batch_size = n;
  }
  nvjpegImage_t* out = new (std::nothrow) nvjpegImage_t[n];
  if (out == nullptr) return static_cast<int>(NVJPEG_STATUS_ALLOCATOR_FAILURE);
  for (int i = 0; i < n; ++i) out[i] = rgbi(dst[i], widths[i]);
  nvjpegStatus_t s = nvjpegDecodeBatched(c->handle, c->batch_state, data, lens, out,
                                         static_cast<cudaStream_t>(stream));
  delete[] out;
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  return cuda_status();
}

// Decodes one JPEG into an RGBI image of width * 3 bytes a row, on stream.
int ihpr_jpeg_decode_one(void* codec, const unsigned char* data, size_t len, unsigned char* dst,
                         int width, void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  nvjpegImage_t out = rgbi(dst, width);
  IHPR_NVJPEG(nvjpegDecode(c->handle, c->one_state, data, len, NVJPEG_OUTPUT_RGBI, &out,
                           static_cast<cudaStream_t>(stream)));
  return cuda_status();
}

// Encodes one RGBI device image (height x width, width * 3 bytes a row) as a
// baseline 4:2:0 JPEG of the given quality, waits for it, and puts the
// bitstream's length in *len; ihpr_jpeg_encode_retrieve then copies it out.
int ihpr_jpeg_encode(void* codec, const unsigned char* src, int height, int width, int quality,
                     size_t* len, void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  IHPR_NVJPEG(nvjpegEncoderParamsSetQuality(c->enc_params, quality, st));
  IHPR_NVJPEG(nvjpegEncoderParamsSetSamplingFactors(c->enc_params, NVJPEG_CSS_420, st));
  IHPR_NVJPEG(nvjpegEncoderParamsSetOptimizedHuffman(c->enc_params, 0, st));
  nvjpegImage_t in = rgbi(const_cast<unsigned char*>(src), width);
  IHPR_NVJPEG(nvjpegEncodeImage(c->handle, c->enc_state, c->enc_params, &in, NVJPEG_INPUT_RGBI,
                                width, height, st));
  IHPR_NVJPEG(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, nullptr, len, st));
  return sync_status(st);
}

// Copies the last encoded bitstream (*len bytes, from ihpr_jpeg_encode) to
// host memory at out.
int ihpr_jpeg_encode_retrieve(void* codec, unsigned char* out, size_t* len, void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  IHPR_NVJPEG(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, out, len,
                                            static_cast<cudaStream_t>(stream)));
  return sync_status(static_cast<cudaStream_t>(stream));
}

}  // extern "C"
