// The port's native decode and batch loader: JPEG/PNG decode, centre crop
// and resize, batch assembly on a thread pool, behind a C ABI.
//
// Own copy of native/dataloader.cpp (the JAX package's), with the same
// entry points and results:
//   d3f_decode_image(path, target_size, out_buf) -> 0 on success
//   d3f_load_batch(paths, n, target_size, n_threads, out_buf, err_idx)
//   d3f_image_dims(path, &w, &h) -> 0 on success
// and two for the server's encoded route, in memory:
//   d3f_decode_buffer(data, len, &w, &h, &pixels) -> 0; RGB HWC, no crop
//     or resize (cv2.imdecode's frame, in RGB); free with d3f_free
//   d3f_encode_jpeg(rgb, w, h, quality, &bytes, &len) -> 0; baseline
//     JPEG, 4:2:0, libjpeg's defaults (cv2.imencode's); free with d3f_free
//
// Decode: libjpeg (baseline and progressive) and libpng (8/16 bit, gray,
// gray+alpha, palette, tRNS, RGBA; alpha dropped). Layout RGB HWC uint8.
// The crop and bilinear resize live in crop_resize.cpp.

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

#include "crop_resize.h"

namespace {

struct Image {
  std::vector<uint8_t> data;  // RGB HWC
  int width = 0;
  int height = 0;
};

// ---------------------------------------------------------------- JPEG

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG from a file or (f == nullptr) from memory. When the image is
// exactly target x target, scanlines go straight into `direct_out`;
// otherwise into out->data. Sets *used_direct accordingly.
bool read_jpeg(FILE* f, const uint8_t* mem, size_t mem_len, Image* out,
               int target, uint8_t* direct_out, bool* used_direct) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  if (f != nullptr)
    jpeg_stdio_src(&cinfo, f);
  else
    jpeg_mem_src(&cinfo, mem, static_cast<unsigned long>(mem_len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->width = cinfo.output_width;
  out->height = cinfo.output_height;
  const int stride = out->width * 3;

  uint8_t* dst;
  bool direct = direct_out != nullptr && out->width == target &&
                out->height == target;
  if (direct) {
    dst = direct_out;
  } else {
    out->data.resize(size_t(out->width) * out->height * 3);
    dst = out->data.data();
  }
  if (used_direct) *used_direct = direct;

  // A window of row pointers, so libjpeg can return several scanlines a
  // call (rec_outbuf_height is 1-4).
  JSAMPROW rows[4];
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned int base = cinfo.output_scanline;
    unsigned int avail = cinfo.output_height - base;
    unsigned int want = avail < 4 ? avail : 4;
    for (unsigned int i = 0; i < want; ++i)
      rows[i] = dst + size_t(base + i) * stride;
    jpeg_read_scanlines(&cinfo, rows, want);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG

struct MemReader {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  auto* r = static_cast<MemReader*>(png_get_io_ptr(png));
  if (r->len - r->pos < n) png_error(png, "PNG data ends early");
  memcpy(out, r->data + r->pos, n);
  r->pos += n;
}

// Decode a PNG from a file or (f == nullptr) from memory.
bool read_png(FILE* f, const uint8_t* mem, size_t mem_len, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  MemReader reader{mem, mem_len, 0};
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  if (f != nullptr)
    png_init_io(png, f);
  else
    png_set_read_fn(png, &reader, png_mem_read);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int color_type = png_get_color_type(png, info);
  int bit_depth = png_get_bit_depth(png, info);

  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  // Drop alpha to plain RGB.
  if (color_type & PNG_COLOR_MASK_ALPHA ||
      png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->width = int(width);
  out->height = int(height);
  out->data.resize(size_t(width) * height * 3);
  std::vector<png_bytep> rows(height);
  for (png_uint_32 y = 0; y < height; ++y)
    rows[y] = out->data.data() + size_t(y) * width * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool is_jpeg(const uint8_t* magic, size_t got) {
  return got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF;
}

bool is_png(const uint8_t* magic, size_t got) {
  return got >= 8 && png_sig_cmp(const_cast<uint8_t*>(magic), 0, 8) == 0;
}

bool decode_file(const char* path, Image* out, int target = 0,
                 uint8_t* direct_out = nullptr, bool* used_direct = nullptr) {
  if (used_direct) *used_direct = false;
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (is_jpeg(magic, got))
    ok = read_jpeg(f, nullptr, 0, out, target, direct_out, used_direct);
  else if (is_png(magic, got))
    ok = read_png(f, nullptr, 0, out);
  fclose(f);
  return ok;
}

}  // namespace

extern "C" {

// Decode one image, centre-crop square, resize to target. out: target^2*3.
int d3f_decode_image(const char* path, int target, uint8_t* out) {
  Image img;
  bool direct = false;
  if (!decode_file(path, &img, target, out, &direct)) return -1;
  if (direct) return 0;  // decoded straight into `out`
  if (img.width <= 0 || img.height <= 0) return -1;
  d3f_crop_resize(img.data.data(), img.width, img.height, target, out);
  return 0;
}

int d3f_image_dims(const char* path, int* width, int* height) {
  Image img;  // a full decode: the probe is not on a hot path
  if (!decode_file(path, &img)) return -1;
  *width = img.width;
  *height = img.height;
  return 0;
}

// Decode a batch on a thread pool. Returns 0, or -1 with *err_idx = the
// first failing image's index.
int d3f_load_batch(const char** paths, int n, int target, int n_threads,
                   uint8_t* out, int* err_idx) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> failed(-1);
  const size_t frame = size_t(target) * target * 3;

  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      if (failed.load(std::memory_order_relaxed) >= 0) return;
      if (d3f_decode_image(paths[i], target, out + frame * i) != 0) {
        int expected = -1;
        failed.compare_exchange_strong(expected, i);
        return;
      }
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  int f = failed.load();
  if (f >= 0) {
    if (err_idx) *err_idx = f;
    return -1;
  }
  return 0;
}

// Decode a JPEG or PNG held in memory to RGB HWC at its own size. *pixels
// is malloc'd: release it with d3f_free.
int d3f_decode_buffer(const uint8_t* data, size_t len, int* width,
                      int* height, uint8_t** pixels) {
  Image img;
  bool ok = false;
  if (is_jpeg(data, len))
    ok = read_jpeg(nullptr, data, len, &img, 0, nullptr, nullptr);
  else if (is_png(data, len))
    ok = read_png(nullptr, data, len, &img);
  if (!ok || img.width <= 0 || img.height <= 0) return -1;
  *pixels = static_cast<uint8_t*>(malloc(img.data.size()));
  if (*pixels == nullptr) return -1;
  memcpy(*pixels, img.data.data(), img.data.size());
  *width = img.width;
  *height = img.height;
  return 0;
}

// Encode RGB HWC uint8 as a baseline JPEG: libjpeg's defaults (4:2:0,
// Huffman tables not optimised) at `quality`. *bytes is malloc'd: release
// it with d3f_free.
int d3f_encode_jpeg(const uint8_t* rgb, int width, int height, int quality,
                    uint8_t** bytes, size_t* len) {
  jpeg_compress_struct cinfo;
  JpegErrorMgr jerr;
  unsigned char* buf = nullptr;
  unsigned long size = 0;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    free(buf);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &size);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) +
                   size_t(cinfo.next_scanline) * width * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *bytes = buf;
  *len = size;
  return 0;
}

void d3f_free(void* p) { free(p); }

}  // extern "C"
