// extern "C" ABI loaded with ctypes (runtime/native.py).
#include <cstring>
#include <string>
#include <vector>

#include "imgproc.h"

extern "C" {

// Decode an image; returns 1 on success and fills w/h. Caller then calls
// mt_copy_pixels with a buffer of w*h*3 bytes and frees the handle.
void* mt_decode(const char* path, int* w, int* h) {
  auto* img = new mt::Image(mt::DecodeImageFile(path));
  if (!img->ok()) {
    delete img;
    return nullptr;
  }
  *w = img->width;
  *h = img->height;
  return img;
}

void mt_copy_pixels(void* handle, unsigned char* dst) {
  auto* img = static_cast<mt::Image*>(handle);
  std::memcpy(dst, img->data.data(), img->data.size());
}

void mt_free(void* handle) { delete static_cast<mt::Image*>(handle); }

// The formats mt_decode reads: bits 1 JPEG, 2 PNG, 4 BMP, 8 PPM.
int mt_formats() { return mt::DecodedFormats(); }

// Parallel decode+letterbox of n files into dst (n*out_h*out_w*3, NHWC u8).
// geom: n*3 floats (ratio, dw, dh). ok: n bytes. Returns #decoded.
int mt_load_letterbox_batch(const char** paths, int n, int out_w, int out_h,
                            unsigned char pad_value, int num_threads,
                            unsigned char* dst, float* geom,
                            unsigned char* ok) {
  std::vector<std::string> vec(paths, paths + n);
  std::vector<mt::LetterboxInfo> infos(n);
  int decoded = mt::LoadLetterboxBatch(vec, out_w, out_h, pad_value,
                                       num_threads, dst, infos.data(), ok);
  for (int i = 0; i < n; ++i) {
    geom[i * 3 + 0] = infos[i].ratio;
    geom[i * 3 + 1] = infos[i].dw;
    geom[i * 3 + 2] = infos[i].dh;
  }
  return decoded;
}

// Nearest crop-resize from a raw HWC u8 buffer.
void mt_crop_resize_nearest(const unsigned char* src, int src_w, int src_h,
                            int x1, int y1, int x2, int y2, int out_w,
                            int out_h, unsigned char* dst) {
  // borrowed view: no full-frame copy per crop (up to topk crops/frame)
  mt::CropResizeNearestU8(src, src_w, src_h, x1, y1, x2, y2, out_w, out_h,
                          dst);
}

}  // extern "C"
