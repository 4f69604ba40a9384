// zest_io: the host-side image pipeline of the data loaders (plain C++,
// built with g++ by data/native_io.py; not a device kernel).
//
// PNG/JPEG decode (libpng/libjpeg), a PIL-compatible Lanczos-3 resize
// (separable, antialiased on downscale, half-pixel centers, per-destination
// weight normalization: the arithmetic of Pillow's
// ImagingResampleHorizontal/Vertical), and a std::thread worker pool so a
// sample's views decode in parallel while the interpreter keeps running
// (ctypes releases the GIL for the call). The same source as the JAX
// package's native/zest_io.cpp, so both give the same bytes.
//
// C ABI (ctypes):
//   zest_load_images(paths, n, out_w, out_h, out)   out: n*out_h*out_w*3 f32 in [0,1]
//   zest_decode_image(path, out_w, out_h, out)      single image
//   zest_version()
#include <png.h>
#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h*w*3
};

bool decode_png(FILE* f, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_expand(png);          // palette/gray/1-2-4-bit → 8-bit RGB(A)
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->rgb.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[2] = {0, 0};
  if (std::fread(magic, 1, 2, f) != 2) {
    std::fclose(f);
    return false;
  }
  std::rewind(f);
  bool ok;
  if (magic[0] == 0x89 && magic[1] == 'P')
    ok = decode_png(f, out);
  else
    ok = decode_jpeg(f, out);
  std::fclose(f);
  return ok;
}

double lanczos3(double x) {
  if (x <= -3.0 || x >= 3.0) return 0.0;
  if (x == 0.0) return 1.0;
  double px = M_PI * x;
  return 3.0 * std::sin(px) * std::sin(px / 3.0) / (px * px);
}

// Pillow-compatible resample weights along one axis: half-pixel centers,
// support scaled by the downscale factor, weights normalized per destination.
struct Taps {
  int kmax = 0;               // taps per destination
  std::vector<int> start;     // first source index per destination
  std::vector<double> w;      // [dst, kmax]
};

Taps make_taps(int src, int dst) {
  Taps t;
  double scale = double(src) / dst;
  double filterscale = std::max(scale, 1.0);
  double support = 3.0 * filterscale;
  t.kmax = int(std::ceil(support)) * 2 + 1;
  t.start.resize(dst);
  t.w.assign(size_t(dst) * t.kmax, 0.0);
  for (int i = 0; i < dst; ++i) {
    double center = (i + 0.5) * scale;
    int lo = std::max(int(center - support + 0.5), 0);
    int hi = std::min(int(center + support + 0.5), src);
    t.start[i] = lo;
    double sum = 0.0;
    for (int k = lo; k < hi; ++k) {
      double v = lanczos3((k - center + 0.5) / filterscale);
      t.w[size_t(i) * t.kmax + (k - lo)] = v;
      sum += v;
    }
    if (sum != 0.0)
      for (int k = 0; k < hi - lo; ++k) t.w[size_t(i) * t.kmax + k] /= sum;
  }
  return t;
}

// separable Lanczos resize of an RGB byte image to f32 [0,1]
void resize_lanczos(const Image& img, int out_w, int out_h, float* out) {
  Taps tx = make_taps(img.w, out_w);
  Taps ty = make_taps(img.h, out_h);
  // horizontal pass → [h, out_w, 3]
  std::vector<float> tmp(size_t(img.h) * out_w * 3);
  for (int y = 0; y < img.h; ++y) {
    const uint8_t* row = img.rgb.data() + size_t(y) * img.w * 3;
    for (int x = 0; x < out_w; ++x) {
      double acc[3] = {0, 0, 0};
      int lo = tx.start[x];
      const double* w = &tx.w[size_t(x) * tx.kmax];
      for (int k = 0; k + lo < img.w && k < tx.kmax; ++k) {
        double wk = w[k];
        if (wk == 0.0) continue;
        const uint8_t* px = row + size_t(lo + k) * 3;
        acc[0] += wk * px[0];
        acc[1] += wk * px[1];
        acc[2] += wk * px[2];
      }
      float* o = tmp.data() + (size_t(y) * out_w + x) * 3;
      // Pillow quantizes the horizontal-pass intermediate back to uint8
      // (clip8 in ImagingResampleHorizontal_8bpc); the clamp of negative
      // Lanczos lobes between passes changes results by up to ~10/255 —
      // reproduce it exactly
      for (int c = 0; c < 3; ++c)
        o[c] = float(int(std::min(std::max(acc[c], 0.0), 255.0) + 0.5));
    }
  }
  // vertical pass → [out_h, out_w, 3], scaled to [0,1] with Pillow's clamp
  for (int y = 0; y < out_h; ++y) {
    int lo = ty.start[y];
    const double* w = &ty.w[size_t(y) * ty.kmax];
    for (int x = 0; x < out_w; ++x) {
      double acc[3] = {0, 0, 0};
      for (int k = 0; k + lo < img.h && k < ty.kmax; ++k) {
        double wk = w[k];
        if (wk == 0.0) continue;
        const float* px = tmp.data() + (size_t(lo + k) * out_w + x) * 3;
        acc[0] += wk * px[0];
        acc[1] += wk * px[1];
        acc[2] += wk * px[2];
      }
      float* o = out + (size_t(y) * out_w + x) * 3;
      for (int c = 0; c < 3; ++c) {
        // Pillow rounds to uint8 after resampling; reproduce that quantization
        double v = std::min(std::max(acc[c], 0.0), 255.0);
        o[c] = float(int(v + 0.5)) / 255.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

int zest_decode_image(const char* path, int out_w, int out_h, float* out) {
  Image img;
  if (!decode_file(path, &img)) return -1;
  resize_lanczos(img, out_w, out_h, out);
  return 0;
}

// Decode+resize n images in parallel; out is [n, out_h, out_w, 3] f32.
// Returns the number of failures (0 = success).
int zest_load_images(const char** paths, int n, int out_w, int out_h,
                     float* out) {
  int n_threads = std::min(n, int(std::thread::hardware_concurrency()));
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failures(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      if (zest_decode_image(paths[i], out_w, out_h,
                            out + size_t(i) * out_h * out_w * 3) != 0)
        failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
  for (auto& t : pool) t.join();
  return failures.load();
}

const char* zest_version() { return "zest_io 1.0"; }

}  // extern "C"
