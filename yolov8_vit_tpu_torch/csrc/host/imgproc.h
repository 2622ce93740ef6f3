// Host image pipeline of the PyTorch port (yolov8_vit_tpu_torch).
//
// JPEG/PNG/PPM/BMP decode, the letterbox with cv2's semantics, and a
// multithreaded batch loader that decodes and letterboxes frames into one
// NHWC uint8 buffer.  Exposed through an extern "C" ABI loaded with ctypes
// (runtime/native.py); built by _build.py with the host C++ compiler.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace mt {

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;          // always 3 (RGB) after decode
  std::vector<uint8_t> data; // HWC row-major
  bool ok() const { return width > 0 && height > 0 && !data.empty(); }
};

// Decode JPEG/PNG/PPM/BMP by magic bytes. Returns empty image on failure
// (and for JPEG or PNG when built without libjpeg or libpng).
Image DecodeImageFile(const std::string& path);

// The formats this build decodes: a mask of the kFormat* bits.
enum { kFormatJpeg = 1, kFormatPng = 2, kFormatBmp = 4, kFormatPpm = 8 };
int DecodedFormats();

// Letterbox geometry (as ops/letterbox.py letterbox_params).
struct LetterboxInfo {
  float ratio = 1.f;
  float dw = 0.f;
  float dh = 0.f;
};

// Aspect-preserving bilinear resize (half-pixel centers, edge clamp — cv2
// INTER_LINEAR float semantics) + pad with `pad_value` to (out_w, out_h).
// Output NHWC uint8 written to `dst` (out_h*out_w*3 bytes).
LetterboxInfo LetterboxU8(const Image& src, int out_w, int out_h,
                          uint8_t pad_value, uint8_t* dst);

// Nearest crop-resize: exact-rational source mapping (ops/crop.py contract).
// Box is integer xyxy clamped to the image. dst is out_h*out_w*3.
// The raw-pointer form reads a borrowed HWC u8 view (no frame copy).
void CropResizeNearestU8(const uint8_t* src, int width, int height,
                         int x1, int y1, int x2, int y2,
                         int out_w, int out_h, uint8_t* dst);
void CropResizeNearestU8(const Image& src, int x1, int y1, int x2, int y2,
                         int out_w, int out_h, uint8_t* dst);

// Parallel batch load: decode+letterbox `n` files into a preallocated
// NHWC buffer (n*out_h*out_w*3). infos receives per-image geometry;
// ok[i]=1 when image i decoded. Returns number decoded.
int LoadLetterboxBatch(const std::vector<std::string>& paths, int out_w,
                       int out_h, uint8_t pad_value, int num_threads,
                       uint8_t* dst, LetterboxInfo* infos, uint8_t* ok);

}  // namespace mt
