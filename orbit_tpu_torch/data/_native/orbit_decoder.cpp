// Native frame-decode pipeline for the ORBIT data path.
//
// Replaces the per-frame PIL decode/resize/normalize the reference runs
// inside its DataLoader workers (reference: data/datasets.py:422-431, the
// pipeline's hot loop) with a C++ thread pool over libjpeg:
//   file read -> jpeg decode (DCT-domain prescale to >= target size,
//   skipping most IDCT work on downscale) -> bilinear resize to NxN ->
//   float32 normalize ((x/255 - mean) / std), NHWC.
//
// Exposed as a small C API consumed via ctypes
// (orbit_tpu/data/native_decoder.py). Build: scripts/build_native.sh.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>  // requires <cstddef>/<cstdio> first (size_t, FILE)

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file to RGB8. Returns true on success; the image is
// decoded at the smallest libjpeg scale (M/8) that still covers
// target_size, bounding the IDCT + resize cost.
bool decode_jpeg(const char* path, int target_size,
                 std::vector<uint8_t>& pixels, int& w, int& h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // pick scale M/8 (M in 1..8) so the decoded size stays >= target
  const unsigned full = cinfo.image_width < cinfo.image_height
                            ? cinfo.image_width : cinfo.image_height;
  unsigned m = 8;
  while (m > 1 && (full * (m - 1)) / 8 >= static_cast<unsigned>(target_size)) {
    --m;
  }
  cinfo.scale_num = m;
  cinfo.scale_denom = 8;

  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  const int row_stride = w * cinfo.output_components;
  pixels.resize(static_cast<size_t>(row_stride) * h);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels.data() + static_cast<size_t>(cinfo.output_scanline) * row_stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);

  if (cinfo.output_components != 3) {
    // expand grayscale to RGB in-place (rare in ORBIT)
    if (cinfo.output_components == 1) {
      std::vector<uint8_t> rgb(static_cast<size_t>(w) * h * 3);
      for (size_t i = 0; i < static_cast<size_t>(w) * h; ++i) {
        rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = pixels[i];
      }
      pixels.swap(rgb);
    } else {
      return false;
    }
  }
  return true;
}

// Bilinear resize RGB8 (w, h) -> (size, size) and normalize into out
// (size, size, 3) float32 NHWC.
void resize_normalize(const std::vector<uint8_t>& src, int w, int h, int size,
                      const float* mean, const float* inv_std, float* out) {
  const float sx = static_cast<float>(w) / size;
  const float sy = static_cast<float>(h) / size;
  for (int y = 0; y < size; ++y) {
    const float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    const float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) y0 = 0;
    if (y1 > h - 1) y1 = h - 1;
    if (y0 > h - 1) y0 = h - 1;
    for (int x = 0; x < size; ++x) {
      const float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      const float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) x0 = 0;
      if (x1 > w - 1) x1 = w - 1;
      if (x0 > w - 1) x0 = w - 1;
      const uint8_t* p00 = &src[(static_cast<size_t>(y0) * w + x0) * 3];
      const uint8_t* p01 = &src[(static_cast<size_t>(y0) * w + x1) * 3];
      const uint8_t* p10 = &src[(static_cast<size_t>(y1) * w + x0) * 3];
      const uint8_t* p11 = &src[(static_cast<size_t>(y1) * w + x1) * 3];
      float* dst = out + (static_cast<size_t>(y) * size + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        const float v = (top + (bot - top) * wy) * (1.0f / 255.0f);
        dst[c] = (v - mean[c]) * inv_std[c];
      }
    }
  }
}

// Bilinear resize RGB8 (w, h) -> (size, size) uint8 NHWC — the raw-pixel
// variant for the uint8 wire format (normalization happens on the TPU:
// models/recognisers.py _maybe_normalize). Same sampling as
// resize_normalize so both paths see identical pixels.
void resize_u8(const std::vector<uint8_t>& src, int w, int h, int size,
               uint8_t* out) {
  const float sx = static_cast<float>(w) / size;
  const float sy = static_cast<float>(h) / size;
  for (int y = 0; y < size; ++y) {
    const float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    const float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) y0 = 0;
    if (y1 > h - 1) y1 = h - 1;
    if (y0 > h - 1) y0 = h - 1;
    for (int x = 0; x < size; ++x) {
      const float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      const float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) x0 = 0;
      if (x1 > w - 1) x1 = w - 1;
      if (x0 > w - 1) x0 = w - 1;
      const uint8_t* p00 = &src[(static_cast<size_t>(y0) * w + x0) * 3];
      const uint8_t* p01 = &src[(static_cast<size_t>(y0) * w + x1) * 3];
      const uint8_t* p10 = &src[(static_cast<size_t>(y1) * w + x0) * 3];
      const uint8_t* p11 = &src[(static_cast<size_t>(y1) * w + x1) * 3];
      uint8_t* dst = out + (static_cast<size_t>(y) * size + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        const float v = top + (bot - top) * wy;
        dst[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode `n` JPEGs into out (n, size, size, 3) uint8, raw pixels (no
// normalization — the uint8 wire format). Returns the number of failures
// (failed slots are zero-filled).
int orbit_decode_batch_u8(const char** paths, int n, int size,
                          uint8_t* out, int n_threads) {
  std::atomic<int> next(0), failures(0);
  const size_t frame_elems = static_cast<size_t>(size) * size * 3;

  auto worker = [&]() {
    std::vector<uint8_t> pixels;
    int w = 0, h = 0;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      uint8_t* dst = out + frame_elems * i;
      if (decode_jpeg(paths[i], size, pixels, w, h)) {
        if (w == size && h == size) {  // pre-resized benchmark layout
          std::memcpy(dst, pixels.data(), frame_elems);
        } else {
          resize_u8(pixels, w, h, size, dst);
        }
      } else {
        std::memset(dst, 0, frame_elems);
        failures.fetch_add(1);
      }
    }
  };

  if (n_threads <= 1 || n <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    const int k = n_threads < n ? n_threads : n;
    pool.reserve(k);
    for (int t = 0; t < k; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

// Decode `n` JPEGs into out (n, size, size, 3) float32, normalized.
// paths: array of n C strings. Returns the number of failures (failed
// slots are zero-filled).
int orbit_decode_batch(const char** paths, int n, int size,
                       const float* mean, const float* std_dev,
                       float* out, int n_threads) {
  const float inv_std[3] = {1.0f / std_dev[0], 1.0f / std_dev[1], 1.0f / std_dev[2]};
  std::atomic<int> next(0), failures(0);
  const size_t frame_elems = static_cast<size_t>(size) * size * 3;

  auto worker = [&]() {
    std::vector<uint8_t> pixels;
    int w = 0, h = 0;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      float* dst = out + frame_elems * i;
      if (decode_jpeg(paths[i], size, pixels, w, h)) {
        resize_normalize(pixels, w, h, size, mean, inv_std, dst);
      } else {
        std::memset(dst, 0, frame_elems * sizeof(float));
        failures.fetch_add(1);
      }
    }
  };

  if (n_threads <= 1 || n <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    const int k = n_threads < n ? n_threads : n;
    pool.reserve(k);
    for (int t = 0; t < k; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

}  // extern "C"
