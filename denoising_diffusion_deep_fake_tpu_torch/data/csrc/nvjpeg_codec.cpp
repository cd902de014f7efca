// JPEG decode and encode on the GPU through the CUDA toolkit's nvJPEG, for
// a machine without libjpeg (data/nvjpeg.py binds it with ctypes).
//
//   d3f_nvjpeg_create(&ctx) / d3f_nvjpeg_destroy(ctx)
//   d3f_nvjpeg_info(ctx, data, len, &w, &h, &components, &subsampling)
//   d3f_nvjpeg_decode_batch(ctx, data[], lens[], n, outs[], stream):
//     nvjpegDecodeBatched into interleaved RGB (NVJPEG_OUTPUT_RGBI); outs[i]
//     is a device buffer of h_i x w_i x 3 bytes (pitch w_i * 3) that the
//     caller allocated, written on `stream`
//   d3f_nvjpeg_encode(ctx, rgb, w, h, quality, stream, &bytes, &len):
//     nvjpegEncodeImage of a device RGB HWC frame, 4:2:0, Huffman tables
//     not optimised; *bytes is malloc'd on the host (d3f_nvjpeg_free)
//
// Every call returns 0, an nvjpegStatus_t, or 1000 + a cudaError_t. One
// context serves one thread at a time (the wrapper holds a lock). The
// handle uses nvJPEG's default backend.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

struct Codec {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t decoder = nullptr;
  nvjpegEncoderState_t encoder = nullptr;
  nvjpegEncoderParams_t params = nullptr;
};

#define D3F_NVJPEG(call)                                   \
  do {                                                     \
    nvjpegStatus_t s_ = (call);                            \
    if (s_ != NVJPEG_STATUS_SUCCESS) return int(s_);       \
  } while (0)

#define D3F_CUDA(call)                                     \
  do {                                                     \
    cudaError_t e_ = (call);                               \
    if (e_ != cudaSuccess) return 1000 + int(e_);          \
  } while (0)

}  // namespace

extern "C" {

int d3f_nvjpeg_create(void** ctx) {
  auto* c = new Codec();
  nvjpegStatus_t s = nvjpegCreateSimple(&c->handle);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegJpegStateCreate(c->handle, &c->decoder);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderStateCreate(c->handle, &c->encoder, nullptr);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsCreate(c->handle, &c->params, nullptr);
  if (s != NVJPEG_STATUS_SUCCESS) {
    if (c->params) nvjpegEncoderParamsDestroy(c->params);
    if (c->encoder) nvjpegEncoderStateDestroy(c->encoder);
    if (c->decoder) nvjpegJpegStateDestroy(c->decoder);
    if (c->handle) nvjpegDestroy(c->handle);
    delete c;
    return int(s);
  }
  *ctx = c;
  return 0;
}

void d3f_nvjpeg_destroy(void* ctx) {
  auto* c = static_cast<Codec*>(ctx);
  if (!c) return;
  nvjpegEncoderParamsDestroy(c->params);
  nvjpegEncoderStateDestroy(c->encoder);
  nvjpegJpegStateDestroy(c->decoder);
  nvjpegDestroy(c->handle);
  delete c;
}

int d3f_nvjpeg_info(void* ctx, const uint8_t* data, size_t len, int* width,
                    int* height, int* components, int* subsampling) {
  auto* c = static_cast<Codec*>(ctx);
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css;
  D3F_NVJPEG(nvjpegGetImageInfo(c->handle, data, len, components, &css,
                                widths, heights));
  *width = widths[0];
  *height = heights[0];
  *subsampling = int(css);
  return 0;
}

int d3f_nvjpeg_decode_batch(void* ctx, const uint8_t* const* data,
                            const size_t* lens, int n, uint8_t* const* outs,
                            const int* widths, void* stream) {
  auto* c = static_cast<Codec*>(ctx);
  auto s = static_cast<cudaStream_t>(stream);
  std::vector<nvjpegImage_t> dst(n);
  for (int i = 0; i < n; ++i) {
    dst[i] = nvjpegImage_t{};
    dst[i].channel[0] = outs[i];
    dst[i].pitch[0] = size_t(widths[i]) * 3;
  }
  D3F_NVJPEG(nvjpegDecodeBatchedInitialize(c->handle, c->decoder, n, 1,
                                           NVJPEG_OUTPUT_RGBI));
  D3F_NVJPEG(nvjpegDecodeBatched(c->handle, c->decoder, data, lens,
                                 dst.data(), s));
  return 0;
}

int d3f_nvjpeg_encode(void* ctx, const uint8_t* rgb, int width, int height,
                      int quality, void* stream, uint8_t** bytes,
                      size_t* len) {
  auto* c = static_cast<Codec*>(ctx);
  auto s = static_cast<cudaStream_t>(stream);
  D3F_NVJPEG(nvjpegEncoderParamsSetQuality(c->params, quality, s));
  D3F_NVJPEG(nvjpegEncoderParamsSetSamplingFactors(c->params, NVJPEG_CSS_420,
                                                   s));
  D3F_NVJPEG(nvjpegEncoderParamsSetOptimizedHuffman(c->params, 0, s));
  nvjpegImage_t src{};
  src.channel[0] = const_cast<uint8_t*>(rgb);
  src.pitch[0] = size_t(width) * 3;
  D3F_NVJPEG(nvjpegEncodeImage(c->handle, c->encoder, c->params, &src,
                               NVJPEG_INPUT_RGBI, width, height, s));
  size_t size = 0;
  D3F_NVJPEG(nvjpegEncodeRetrieveBitstream(c->handle, c->encoder, nullptr,
                                           &size, s));
  D3F_CUDA(cudaStreamSynchronize(s));
  auto* buf = static_cast<uint8_t*>(malloc(size));
  if (!buf) return 1000 + int(cudaErrorMemoryAllocation);
  nvjpegStatus_t st =
      nvjpegEncodeRetrieveBitstream(c->handle, c->encoder, buf, &size, s);
  cudaError_t e = cudaStreamSynchronize(s);
  if (st != NVJPEG_STATUS_SUCCESS || e != cudaSuccess) {
    free(buf);
    return st != NVJPEG_STATUS_SUCCESS ? int(st) : 1000 + int(e);
  }
  *bytes = buf;
  *len = size;
  return 0;
}

void d3f_nvjpeg_free(void* p) { free(p); }

}  // extern "C"
