#include "imgproc.h"

// JPEG and PNG decode need libjpeg / libpng; _build.py defines
// MT_WITH_JPEG / MT_WITH_PNG where their headers and libraries are found
// (the BMP and PPM readers, the letterbox and the crop need neither).
#ifdef MT_WITH_JPEG
#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>
#endif
#ifdef MT_WITH_PNG
#include <png.h>
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <memory>
#include <thread>

namespace mt {

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

#ifdef MT_WITH_JPEG
static Image DecodeJpeg(FILE* f) {
  Image img;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jerr.error_exit = [](j_common_ptr c) { longjmp(*(jmp_buf*)c->client_data, 1); };
  jmp_buf env;
  cinfo.client_data = &env;
  if (setjmp(env)) {
    jpeg_destroy_decompress(&cinfo);
    return Image{};
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img.width = cinfo.output_width;
  img.height = cinfo.output_height;
  img.channels = 3;
  img.data.resize(size_t(img.width) * img.height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img.data.data() + size_t(cinfo.output_scanline) * img.width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return img;
}

#endif  // MT_WITH_JPEG

#ifdef MT_WITH_PNG
static Image DecodePng(FILE* f) {
  Image img;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return img;
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return Image{};
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  img.width = png_get_image_width(png, info);
  img.height = png_get_image_height(png, info);
  img.channels = 3;
  img.data.resize(size_t(img.width) * img.height * 3);
  std::vector<png_bytep> rows(img.height);
  for (int y = 0; y < img.height; ++y)
    rows[y] = img.data.data() + size_t(y) * img.width * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return img;
}

#endif  // MT_WITH_PNG

static Image DecodePpm(FILE* f) {
  Image img;
  int w, h, maxv;
  if (fscanf(f, "P6 %d %d %d", &w, &h, &maxv) != 3 || maxv > 255) return img;
  // header fields are attacker-controlled (serving accepts uploads); the
  // same bounds as DecodeBmp — without them a 29-byte "P6 2e9 2e9 255"
  // header makes resize() throw std::length_error, which std::terminates
  // the persistent serving process (inside a loader-pool thread, even an
  // in-Python caller can't catch it)
  if (w <= 0 || h <= 0 || w > (1 << 15) || h > (1 << 15) ||
      int64_t(w) * h > (64 << 20))
    return img;
  fgetc(f);  // single whitespace after header
  img.width = w;
  img.height = h;
  img.channels = 3;
  img.data.resize(size_t(w) * h * 3);
  if (fread(img.data.data(), 1, img.data.size(), f) != img.data.size())
    return Image{};
  return img;
}

// BMP rows (BGR or BGRA, `stride` bytes apart, bottom-up when asked) into
// packed RGB rows, top-down
template <int kBytes>
static void SwapRows(const uint8_t* __restrict src, size_t stride, int w,
                     int h, bool bottom_up, uint8_t* __restrict dst) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* __restrict in =
        src + size_t(bottom_up ? h - 1 - y : y) * stride;
    uint8_t* __restrict out = dst + size_t(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      out[x * 3 + 0] = in[x * kBytes + 2];
      out[x * 3 + 1] = in[x * kBytes + 1];
      out[x * 3 + 2] = in[x * kBytes + 0];
    }
  }
}

static Image DecodeBmp(FILE* f) {
  // uncompressed BI_RGB 24/32-bit BMP (the serving layer accepts .bmp
  // uploads); BGR(A) rows, 4-byte padded, bottom-up unless height < 0
  Image img;
  uint8_t hdr[54];
  if (fread(hdr, 1, 54, f) != 54) return img;
  auto u32 = [&](int o) {
    return uint32_t(hdr[o]) | uint32_t(hdr[o + 1]) << 8 |
           uint32_t(hdr[o + 2]) << 16 | uint32_t(hdr[o + 3]) << 24;
  };
  auto u16 = [&](int o) {
    return uint32_t(hdr[o]) | uint32_t(hdr[o + 1]) << 8;
  };
  const uint32_t data_off = u32(10);
  const int32_t w = int32_t(u32(18));
  const int64_t h_raw = int64_t(int32_t(u32(22)));  // int64: -INT32_MIN is UB
  const int bpp = int(u16(28));
  const uint32_t compression = u32(30);
  if (w <= 0 || h_raw == 0 || (bpp != 24 && bpp != 32) || compression != 0)
    return img;
  const bool bottom_up = h_raw > 0;
  const int64_t h64 = bottom_up ? h_raw : -h_raw;
  // bound the allocation: header fields are attacker-controlled (serving
  // accepts uploads), and resize() would otherwise commit w*h*3 bytes
  // before any pixel data is read
  if (w > (1 << 15) || h64 > (1 << 15) || int64_t(w) * h64 > (64 << 20))
    return img;
  const int h = int(h64);
  const int bytespp = bpp / 8;
  const size_t stride = (size_t(w) * bytespp + 3) & ~size_t(3);
  // the whole pixel block in one read (refused unless the file holds it),
  // then one pass that flips the rows and swaps BGR(A) to RGB
  if (fseek(f, 0, SEEK_END) != 0) return img;
  const long size = ftell(f);
  if (size < 0 || uint64_t(size) < data_off + stride * uint64_t(h) ||
      fseek(f, long(data_off), SEEK_SET) != 0)
    return img;
  const size_t n_raw = stride * size_t(h);
  std::unique_ptr<uint8_t[]> raw(new uint8_t[n_raw]);  // no zero fill
  if (fread(raw.get(), 1, n_raw, f) != n_raw) return img;
  img.width = w;
  img.height = h;
  img.channels = 3;
  img.data.resize(size_t(w) * h * 3);
  if (bytespp == 3)
    SwapRows<3>(raw.get(), stride, w, h, bottom_up, img.data.data());
  else
    SwapRows<4>(raw.get(), stride, w, h, bottom_up, img.data.data());
  return img;
}

int DecodedFormats() {
  int bits = kFormatBmp | kFormatPpm;
#ifdef MT_WITH_JPEG
  bits |= kFormatJpeg;
#endif
#ifdef MT_WITH_PNG
  bits |= kFormatPng;
#endif
  return bits;
}

Image DecodeImageFile(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return Image{};
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  static const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n',
                                     0x1A, '\n'};
  Image img;
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
#ifdef MT_WITH_JPEG
    img = DecodeJpeg(f);
#endif
  } else if (got >= 8 && !memcmp(magic, kPngSig, 8)) {
#ifdef MT_WITH_PNG
    img = DecodePng(f);
#endif
  } else if (got >= 2 && magic[0] == 'P' && magic[1] == '6') {
    img = DecodePpm(f);
  } else if (got >= 2 && magic[0] == 'B' && magic[1] == 'M') {
    img = DecodeBmp(f);
  }
  fclose(f);
  return img;
}

// ---------------------------------------------------------------------------
// letterbox (cv2 INTER_LINEAR float semantics: half-pixel centers, clamped)
// ---------------------------------------------------------------------------

static void ResizeBilinear(const Image& src, int out_w, int out_h,
                           uint8_t* dst) {
  const int w = src.width, h = src.height;
  std::vector<int> x0(out_w), x1v(out_w);
  std::vector<float> fx(out_w);
  for (int x = 0; x < out_w; ++x) {
    float c = (x + 0.5f) * (float(w) / out_w) - 0.5f;
    float c0 = std::floor(c);
    fx[x] = c - c0;
    x0[x] = std::clamp(int(c0), 0, w - 1);
    x1v[x] = std::clamp(int(c0) + 1, 0, w - 1);
  }
  for (int y = 0; y < out_h; ++y) {
    float cy = (y + 0.5f) * (float(h) / out_h) - 0.5f;
    float cy0 = std::floor(cy);
    float fy = cy - cy0;
    int y0 = std::clamp(int(cy0), 0, h - 1);
    int y1 = std::clamp(int(cy0) + 1, 0, h - 1);
    const uint8_t* r0 = src.data.data() + size_t(y0) * w * 3;
    const uint8_t* r1 = src.data.data() + size_t(y1) * w * 3;
    uint8_t* out = dst + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const float wx = fx[x];
      const int a = x0[x] * 3, b = x1v[x] * 3;
      for (int c = 0; c < 3; ++c) {
        float top = r0[a + c] * (1 - wx) + r0[b + c] * wx;
        float bot = r1[a + c] * (1 - wx) + r1[b + c] * wx;
        float v = top * (1 - fy) + bot * fy;
        out[x * 3 + c] = (uint8_t)std::lround(std::clamp(v, 0.f, 255.f));
      }
    }
  }
}

LetterboxInfo LetterboxU8(const Image& src, int out_w, int out_h,
                          uint8_t pad_value, uint8_t* dst) {
  LetterboxInfo info;
  // Ratio in double: ops/letterbox.py letterbox_params computes it in
  // float64, and a float32 ratio can land within float32 error of a
  // half-integer product, shifting new_w/new_h by 1px vs the Python
  // geometry.
  const double r =
      std::min(double(out_w) / src.width, double(out_h) / src.height);
  // Python round() is half-to-even; lround (half away from zero) diverges
  // by 1px on exact-.5 products, desyncing the geometry from
  // ops/letterbox.py letterbox_params.  nearbyint honors the default
  // FE_TONEAREST (ties-to-even) mode.
  const int new_w = int(std::nearbyint(double(src.width) * r));
  const int new_h = int(std::nearbyint(double(src.height) * r));
  info.ratio = float(r);
  info.dw = (out_w - new_w) / 2.f;
  info.dh = (out_h - new_h) / 2.f;
  const int top = int(std::lround(info.dh - 0.1f));
  const int left = int(std::lround(info.dw - 0.1f));

  std::memset(dst, pad_value, size_t(out_w) * out_h * 3);
  std::vector<uint8_t> resized(size_t(new_w) * new_h * 3);
  if (new_w == src.width && new_h == src.height) {
    std::memcpy(resized.data(), src.data.data(), resized.size());
  } else {
    ResizeBilinear(src, new_w, new_h, resized.data());
  }
  for (int y = 0; y < new_h; ++y) {
    std::memcpy(dst + (size_t(y + top) * out_w + left) * 3,
                resized.data() + size_t(y) * new_w * 3, size_t(new_w) * 3);
  }
  return info;
}

void CropResizeNearestU8(const uint8_t* src, int width, int height,
                         int x1, int y1, int x2, int y2,
                         int out_w, int out_h, uint8_t* dst) {
  x1 = std::clamp(x1, 0, width - 1);
  y1 = std::clamp(y1, 0, height - 1);
  x2 = std::clamp(std::max(x2, x1 + 1), 1, width);
  y2 = std::clamp(std::max(y2, y1 + 1), 1, height);
  const int64_t bw = x2 - x1, bh = y2 - y1;
  for (int y = 0; y < out_h; ++y) {
    const int sy = y1 + int(std::min<int64_t>(int64_t(y) * bh / out_h, bh - 1));
    const uint8_t* row = src + size_t(sy) * width * 3;
    uint8_t* out = dst + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const int sx = x1 + int(std::min<int64_t>(int64_t(x) * bw / out_w, bw - 1));
      std::memcpy(out + x * 3, row + sx * 3, 3);
    }
  }
}

void CropResizeNearestU8(const Image& src, int x1, int y1, int x2, int y2,
                         int out_w, int out_h, uint8_t* dst) {
  CropResizeNearestU8(src.data.data(), src.width, src.height, x1, y1, x2, y2,
                      out_w, out_h, dst);
}

int LoadLetterboxBatch(const std::vector<std::string>& paths, int out_w,
                       int out_h, uint8_t pad_value, int num_threads,
                       uint8_t* dst, LetterboxInfo* infos, uint8_t* ok) {
  const int n = int(paths.size());
  std::atomic<int> next{0}, decoded{0};
  num_threads = std::max(1, std::min(num_threads, n));
  auto worker = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      Image img = DecodeImageFile(paths[i]);
      uint8_t* out = dst + size_t(i) * out_w * out_h * 3;
      if (img.ok()) {
        infos[i] = LetterboxU8(img, out_w, out_h, pad_value, out);
        ok[i] = 1;
        decoded.fetch_add(1);
      } else {
        std::memset(out, 0, size_t(out_w) * out_h * 3);
        infos[i] = LetterboxInfo{};
        ok[i] = 0;
      }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < num_threads; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  return decoded.load();
}

}  // namespace mt
