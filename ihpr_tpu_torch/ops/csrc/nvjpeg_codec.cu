// JPEG decode and encode on the card through nvJPEG, with a plain C
// interface for ctypes (ihpr_tpu_torch/data/jpeg.py).
//
// Not the port of a Pallas kernel: the JAX package decodes on the host
// (ihpr_tpu/data/pipeline.py:_load_image, cv2.imread; and the fused libjpeg
// decode + warp of native/warp.cc); this shim needs only the CUDA toolkit,
// not cv2 or libjpeg. nvJPEG's hybrid backend does the Huffman decode
// on the host and the IDCT on the card. The decode's output is planar
// YCbCr at the frame's stored subsampling (NVJPEG_OUTPUT_YUV): the chroma
// upsampling and colour conversion are libjpeg's, in the colour kernel of
// ops/csrc/jpeg_color.cu. Interleaved RGB from nvJPEG's own upsampling and
// conversion (NVJPEG_OUTPUT_RGBI) stays available as the baseline the
// colour kernel is measured against (chip_smoke.py); the loader never
// asks for it. The encoder writes baseline 4:2:0 JPEGs at the quality asked
// for, as cv2.imwrite does by default.
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
  int batch_size = 0;  // the batch and output format nvjpegDecodeBatchedInitialize last set
  nvjpegOutputFormat_t batch_format = NVJPEG_OUTPUT_YUV;
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

nvjpegOutputFormat_t format(int rgbi) { return rgbi ? NVJPEG_OUTPUT_RGBI : NVJPEG_OUTPUT_YUV; }

// An output image of three planes (Y, Cb, Cr; or RGBI in the first alone)
// with their row pitches in bytes.
nvjpegImage_t image(unsigned char* const* planes, const int* pitches) {
  nvjpegImage_t img = {};
  for (int c = 0; c < 3; ++c) {
    img.channel[c] = planes[c];
    img.pitch[c] = static_cast<size_t>(pitches[c]);
  }
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

// The JPEG header's facts in info[0..5]: the number of components,
// nvJPEG's chroma subsampling (nvjpegChromaSubsampling_t), the frame's
// height and width (the first component's, the full-resolution luma
// plane) and the second component's (a chroma plane's; 0 if none).
int ihpr_jpeg_info(void* codec, const unsigned char* data, size_t len, int* info) {
  Codec* c = static_cast<Codec*>(codec);
  int n_comp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT] = {};
  int heights[NVJPEG_MAX_COMPONENT] = {};
  IHPR_NVJPEG(nvjpegGetImageInfo(c->handle, data, len, &n_comp, &css, widths, heights));
  info[0] = n_comp;
  info[1] = static_cast<int>(css);
  info[2] = heights[0];
  info[3] = widths[0];
  info[4] = n_comp > 1 ? heights[1] : 0;
  info[5] = n_comp > 1 ? widths[1] : 0;
  return 0;
}

// Decodes n JPEGs at once, on stream: image i into the three planes
// planes[3i..3i+2] with row pitches pitches[3i..3i+2]. rgbi = 0: planar
// YCbCr at the stored subsampling; 1: interleaved RGB in the first plane.
int ihpr_jpeg_decode_batch(void* codec, int n, const unsigned char* const* data, const size_t* lens,
                           unsigned char* const* planes, const int* pitches, int rgbi, void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  if (n != c->batch_size || format(rgbi) != c->batch_format) {
    IHPR_NVJPEG(nvjpegDecodeBatchedInitialize(c->handle, c->batch_state, n, 1, format(rgbi)));
    c->batch_size = n;
    c->batch_format = format(rgbi);
  }
  nvjpegImage_t* out = new (std::nothrow) nvjpegImage_t[n];
  if (out == nullptr) return static_cast<int>(NVJPEG_STATUS_ALLOCATOR_FAILURE);
  for (int i = 0; i < n; ++i) out[i] = image(planes + 3 * i, pitches + 3 * i);
  nvjpegStatus_t s = nvjpegDecodeBatched(c->handle, c->batch_state, data, lens, out,
                                         static_cast<cudaStream_t>(stream));
  delete[] out;
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  return cuda_status();
}

// Decodes one JPEG into three planes as ihpr_jpeg_decode_batch does, on
// stream.
int ihpr_jpeg_decode_one(void* codec, const unsigned char* data, size_t len, unsigned char* const* planes,
                         const int* pitches, int rgbi, void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  nvjpegImage_t out = image(planes, pitches);
  IHPR_NVJPEG(nvjpegDecode(c->handle, c->one_state, data, len, format(rgbi), &out,
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
  nvjpegImage_t in = {};
  in.channel[0] = const_cast<unsigned char*>(src);
  in.pitch[0] = static_cast<size_t>(width) * 3;
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
