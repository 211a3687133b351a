// Host image decode of the port's file and bytes ingestion: the port's copy
// of native/lpr_native.cc's decode path (read_file, decode_jpeg, decode_png,
// decode_any and the C entry points below), linked with -ljpeg -lpng16
// -lpthread as native/Makefile links it.  A separate library from
// host_letterbox.cc, so the packed input's letterbox never needs the image
// libraries; both take letterbox_into from host_letterbox.h.  Plain
// `extern "C"` interface, loaded with ctypes (lpr_tpu_torch/native.py),
// built with g++ by lpr_tpu_torch/kernels/_build.py.
//
//   lpr_decode_image(bytes, len, &w, &h) -> malloc'd RGB8 buffer, freed by
//     lpr_free; null for bytes that are neither a JPEG nor a PNG or that do
//     not decode.
//   lpr_load_letterbox_batch(paths[], n, out, oh, ow, fill, n_threads)
//     -> decode + letterbox_into (aspect-preserving bilinear resize, centre
//     pad) of each file into out (n, oh, ow, 3) uint8, one file a thread at
//     a time; a file that cannot be read or decoded leaves its slot `fill`.
//     Returns the number of files loaded.

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

#include "host_letterbox.h"

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

uint8_t* decode_jpeg(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  // volatile: written between setjmp and longjmp, read after the jump
  uint8_t* volatile out = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    free(out);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  size_t stride = static_cast<size_t>(*w) * 3;
  out = static_cast<uint8_t*>(malloc(stride * *h));
  if (out == nullptr) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return out;
}

uint8_t* decode_png(const uint8_t* data, size_t len, int* w, int* h) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, len)) return nullptr;
  image.format = PNG_FORMAT_RGB;
  size_t stride = PNG_IMAGE_ROW_STRIDE(image);
  auto* out = static_cast<uint8_t*>(malloc(PNG_IMAGE_SIZE(image)));
  if (out == nullptr) {
    png_image_free(&image);
    return nullptr;
  }
  if (!png_image_finish_read(&image, nullptr, out, stride, nullptr)) {
    free(out);
    png_image_free(&image);
    return nullptr;
  }
  *w = image.width;
  *h = image.height;
  return out;
}

uint8_t* decode_any(const uint8_t* data, size_t len, int* w, int* h) {
  if (len > 3 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data, len, w, h);
  if (len > 8 && data[0] == 0x89 && data[1] == 'P')
    return decode_png(data, len, w, h);
  return nullptr;
}

uint8_t* read_file(const char* path, size_t* len) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  if (sz < 0) {
    fclose(f);
    return nullptr;
  }
  fseek(f, 0, SEEK_SET);
  auto* buf = static_cast<uint8_t*>(malloc(sz > 0 ? sz : 1));
  if (buf == nullptr) {
    fclose(f);
    return nullptr;
  }
  size_t got = fread(buf, 1, sz, f);
  fclose(f);
  if (static_cast<long>(got) != sz) {
    free(buf);
    return nullptr;
  }
  *len = sz;
  return buf;
}

}  // namespace

extern "C" {

void lpr_free(void* p) { free(p); }

uint8_t* lpr_decode_image(const uint8_t* data, size_t len, int* w, int* h) {
  return decode_any(data, len, w, h);
}

int lpr_load_letterbox_batch(const char** paths, int n, uint8_t* out, int oh,
                             int ow, uint8_t fill, int n_threads) {
  std::atomic<int> next{0};
  std::atomic<int> ok{0};
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* slot = out + static_cast<size_t>(i) * oh * ow * 3;
      size_t len = 0;
      uint8_t* file = read_file(paths[i], &len);
      if (!file) {
        memset(slot, fill, static_cast<size_t>(oh) * ow * 3);
        continue;
      }
      int w = 0, h = 0;
      uint8_t* img = decode_any(file, len, &w, &h);
      free(file);
      if (!img) {
        memset(slot, fill, static_cast<size_t>(oh) * ow * 3);
        continue;
      }
      host_letterbox::letterbox_into(img, w, h, slot, oh, ow, fill);
      free(img);
      ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

}  // extern "C"
