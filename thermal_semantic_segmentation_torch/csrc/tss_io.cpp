// Native batch image decoder + preprocessor for the data pipeline.
//
// The reference decodes per sample with PIL inside DataLoader workers
// (data/freiburg_dataset.py:72-92); this C++ worker pool decodes PNG
// (libpng, 8/16-bit gray/RGB) and JPEG (libjpeg) images, bilinearly resizes,
// column-crops, and applies the Freiburg IR radiometric window — one ctypes
// call per batch, fanned out over std::thread workers with the GIL released.
//
// Exposed C ABI (see data/native_loader.py):
//   tss_decode_ir_batch : 16-bit IR PNG -> float32 (out_h, crop_w) in [0,1]
//   tss_decode_rgb_batch: 8-bit RGB/gray image -> uint8 (out_h, crop_w, 3)
//   tss_decode_raw      : single image -> native-size buffer (parity testing)
//   tss_encode_batch    : uint8 batch -> PIL-style BICUBIC resize + JPEG/PNG
//                         files (the translator's output path, translator.py)
//
// Build: g++ -O3 -shared -fPIC tss_io.cpp -lpng -ljpeg -lz -o libtss_io.so

#include <png.h>
#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;   // 1 or 3
  int bit_depth = 0;  // 8 or 16
  std::vector<uint16_t> pixels;  // always widened to uint16 storage
  bool ok = false;
};

bool has_suffix(const std::string& s, const char* suf) {
  std::string lower(s);
  std::transform(lower.begin(), lower.end(), lower.begin(), ::tolower);
  size_t n = strlen(suf);
  return lower.size() >= n && lower.compare(lower.size() - n, n, suf) == 0;
}

Image decode_png(const char* path) {
  Image img;
  FILE* fp = fopen(path, "rb");
  if (!fp) return img;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {  // allocation failure: don't touch png_jmpbuf(NULL)
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return img;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return img;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr, nullptr);

  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (bit_depth == 16) png_set_swap(png);  // PNG is big-endian; host is LE
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  bit_depth = png_get_bit_depth(png, info);
  img.width = (int)w;
  img.height = (int)h;
  img.channels = channels >= 3 ? 3 : 1;
  img.bit_depth = bit_depth;
  img.pixels.resize((size_t)w * h * img.channels);

  std::vector<uint8_t> row((size_t)w * channels * (bit_depth / 8));
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    uint16_t* dst = img.pixels.data() + (size_t)y * w * img.channels;
    if (bit_depth == 16) {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(row.data());
      for (png_uint_32 x = 0; x < w; ++x)
        for (int c = 0; c < img.channels; ++c) dst[x * img.channels + c] = src[x * channels + c];
    } else {
      for (png_uint_32 x = 0; x < w; ++x)
        for (int c = 0; c < img.channels; ++c) dst[x * img.channels + c] = row[x * channels + c];
    }
  }
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  img.ok = true;
  return img;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

Image decode_jpeg(const char* path) {
  Image img;
  FILE* fp = fopen(path, "rb");
  if (!fp) return img;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return img;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  jpeg_start_decompress(&cinfo);
  img.width = cinfo.output_width;
  img.height = cinfo.output_height;
  img.channels = cinfo.output_components >= 3 ? 3 : 1;
  img.bit_depth = 8;
  img.pixels.resize((size_t)img.width * img.height * img.channels);
  std::vector<uint8_t> row((size_t)img.width * cinfo.output_components);
  uint8_t* rowp = row.data();
  for (int y = 0; y < img.height; ++y) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    uint16_t* dst = img.pixels.data() + (size_t)y * img.width * img.channels;
    for (int x = 0; x < img.width; ++x)
      for (int c = 0; c < img.channels; ++c)
        dst[x * img.channels + c] = row[x * cinfo.output_components + c];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  img.ok = true;
  return img;
}

Image decode_any(const char* path) {
  std::string p(path);
  if (has_suffix(p, ".jpg") || has_suffix(p, ".jpeg")) return decode_jpeg(path);
  return decode_png(path);
}

// Naive separable bilinear resize with half-pixel centers (fast path; the
// PIL-parity BICUBIC path stays in Python — see data/native_loader.py).
void resize_bilinear_u16(const Image& src, int out_w, int out_h,
                         std::vector<float>& out) {
  const int C = src.channels;
  out.assign((size_t)out_w * out_h * C, 0.f);
  if (out_w == src.width && out_h == src.height) {  // identity fast path
    for (size_t i = 0; i < out.size(); ++i) out[i] = (float)src.pixels[i];
    return;
  }
  const float sx = (float)src.width / out_w;
  const float sy = (float)src.height / out_h;
  for (int y = 0; y < out_h; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::min(std::max(fy, 0.f), (float)src.height - 1.f);
    int y0 = (int)fy;
    int y1 = std::min(y0 + 1, src.height - 1);
    float wy = fy - y0;
    for (int x = 0; x < out_w; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::min(std::max(fx, 0.f), (float)src.width - 1.f);
      int x0 = (int)fx;
      int x1 = std::min(x0 + 1, src.width - 1);
      float wx = fx - x0;
      for (int c = 0; c < C; ++c) {
        auto at = [&](int yy, int xx) {
          return (float)src.pixels[((size_t)yy * src.width + xx) * C + c];
        };
        float top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx;
        float bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx;
        out[((size_t)y * out_w + x) * C + c] = top * (1 - wy) + bot * wy;
      }
    }
  }
}

// ---- Encode path -----------------------------------------------------------

// PIL-convolution resampling (Pillow Resample.c): cubic kernel a=-0.5 with
// filter-scale widening on downscale (antialias). Float weights instead of
// Pillow's int16 fixed point, so outputs match PIL BICUBIC within ~1 LSB —
// the bit-parity save path stays PIL (translator.py keeps it by default).
double bicubic_kernel(double x) {
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct ResampleCoeffs {
  std::vector<int> bounds;       // (xmin, size) per output pixel
  std::vector<double> weights;   // ksize per output pixel
  int ksize = 0;
};

ResampleCoeffs precompute_coeffs(int in_size, int out_size) {
  constexpr double support = 2.0;  // bicubic
  ResampleCoeffs rc;
  double scale = (double)in_size / out_size;
  double filterscale = std::max(scale, 1.0);
  double supp = support * filterscale;
  rc.ksize = (int)std::ceil(supp) * 2 + 1;
  rc.bounds.resize((size_t)out_size * 2);
  rc.weights.assign((size_t)out_size * rc.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = (int)(center - supp + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + supp + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &rc.weights[(size_t)xx * rc.ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double w = bicubic_kernel((x + xmin - center + 0.5) / filterscale);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    rc.bounds[(size_t)xx * 2] = xmin;
    rc.bounds[(size_t)xx * 2 + 1] = xmax;
  }
  return rc;
}

uint8_t clip8(double v) {
  return (uint8_t)std::min(std::max(v + 0.5, 0.0), 255.0);
}

// uint8 HWC -> uint8 out_h x out_w x C, PIL-BICUBIC-equivalent (two passes,
// horizontal first like Pillow; the intermediate is CLAMPED to uint8 exactly
// as Pillow's 8bpc pipeline does — bicubic's negative lobes overshoot, and
// skipping the clamp diverges from PIL by up to ~24 LSB).
void resize_bicubic_u8(const uint8_t* src, int h, int w, int c, int out_w,
                       int out_h, std::vector<uint8_t>& out) {
  ResampleCoeffs rh = precompute_coeffs(w, out_w);
  std::vector<uint8_t> tmp((size_t)h * out_w * c);
  for (int y = 0; y < h; ++y)
    for (int xx = 0; xx < out_w; ++xx) {
      int xmin = rh.bounds[(size_t)xx * 2], xmax = rh.bounds[(size_t)xx * 2 + 1];
      const double* k = &rh.weights[(size_t)xx * rh.ksize];
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int x = 0; x < xmax; ++x)
          acc += src[((size_t)y * w + xmin + x) * c + ch] * k[x];
        tmp[((size_t)y * out_w + xx) * c + ch] = clip8(acc);
      }
    }
  ResampleCoeffs rv = precompute_coeffs(h, out_h);
  out.resize((size_t)out_h * out_w * c);
  for (int yy = 0; yy < out_h; ++yy) {
    int ymin = rv.bounds[(size_t)yy * 2], ymax = rv.bounds[(size_t)yy * 2 + 1];
    const double* k = &rv.weights[(size_t)yy * rv.ksize];
    for (int xx = 0; xx < out_w; ++xx)
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int y = 0; y < ymax; ++y)
          acc += (double)tmp[((size_t)(ymin + y) * out_w + xx) * c + ch] * k[y];
        out[((size_t)yy * out_w + xx) * c + ch] = clip8(acc);
      }
  }
}

bool encode_jpeg(const char* path, const uint8_t* pixels, int w, int h, int c,
                 int quality) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return false;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    fclose(fp);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, fp);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(pixels + (size_t)cinfo.next_scanline * w * c);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(fp);
  return true;
}

bool encode_png(const char* path, const uint8_t* pixels, int w, int h, int c) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return false;
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {  // allocation failure: don't touch png_jmpbuf(NULL)
    if (png) png_destroy_write_struct(&png, &info);
    fclose(fp);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_IHDR(png, info, w, h, 8,
               c == 1 ? PNG_COLOR_TYPE_GRAY : PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  for (int y = 0; y < h; ++y)
    png_write_row(png, const_cast<uint8_t*>(pixels + (size_t)y * w * c));
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return true;
}

// P-mode (indexed-color) PNG with an RGB palette — the colored pseudo-label
// dump format (reference utils/misc.py:330-354 'P' mode + putpalette).
bool encode_png_pal8(const char* path, const uint8_t* pixels, int w, int h,
                     const uint8_t* palette_rgb, int n_colors) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return false;
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {  // allocation failure: don't touch png_jmpbuf(NULL)
    if (png) png_destroy_write_struct(&png, &info);
    fclose(fp);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_PALETTE,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  std::vector<png_color> pal(n_colors);
  for (int i = 0; i < n_colors; ++i) {
    pal[i].red = palette_rgb[i * 3];
    pal[i].green = palette_rgb[i * 3 + 1];
    pal[i].blue = palette_rgb[i * 3 + 2];
  }
  png_set_PLTE(png, info, pal.data(), n_colors);
  png_write_info(png, info);
  for (int y = 0; y < h; ++y)
    png_write_row(png, const_cast<uint8_t*>(pixels + (size_t)y * w));
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return true;
}

void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
  n_threads = std::max(1, std::min(n_threads, n));
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&]() {
      int i;
      while ((i = next.fetch_add(1)) < n) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// 16-bit IR PNGs -> float32 [n, out_h, crop_x1-crop_x0] radiometric window.
// Mirrors data/freiburg_dataset.py:72-82: resize (resize_w, resize_h), crop
// columns [crop_x0, crop_x1), clamp [minval, maxval], scale to [0, 1].
// Returns the number of successfully decoded images.
int tss_decode_ir_batch(const char** paths, int n, int resize_w, int resize_h,
                        int crop_x0, int crop_x1, float minval, float maxval,
                        float* out, int n_threads) {
  const int crop_w = crop_x1 - crop_x0;
  std::atomic<int> ok_count(0);
  parallel_for(n, n_threads, [&](int i) {
    Image img = decode_any(paths[i]);
    float* dst = out + (size_t)i * resize_h * crop_w;
    if (!img.ok || img.channels != 1) {
      memset(dst, 0, sizeof(float) * (size_t)resize_h * crop_w);
      return;
    }
    std::vector<float> resized;
    resize_bilinear_u16(img, resize_w, resize_h, resized);
    const float scale = 1.0f / (maxval - minval);
    for (int y = 0; y < resize_h; ++y)
      for (int x = 0; x < crop_w; ++x) {
        float v = resized[(size_t)y * resize_w + (crop_x0 + x)];
        v = std::min(std::max(v, minval), maxval);
        dst[(size_t)y * crop_w + x] = (v - minval) * scale;
      }
    ok_count.fetch_add(1);
  });
  return ok_count.load();
}

// 8-bit RGB (or gray, replicated) -> uint8 [n, out_h, crop_w, 3].
int tss_decode_rgb_batch(const char** paths, int n, int resize_w, int resize_h,
                         int crop_x0, int crop_x1, uint8_t* out, int n_threads) {
  const int crop_w = crop_x1 - crop_x0;
  std::atomic<int> ok_count(0);
  parallel_for(n, n_threads, [&](int i) {
    Image img = decode_any(paths[i]);
    uint8_t* dst = out + (size_t)i * resize_h * crop_w * 3;
    if (!img.ok) {
      memset(dst, 0, (size_t)resize_h * crop_w * 3);
      return;
    }
    std::vector<float> resized;
    resize_bilinear_u16(img, resize_w, resize_h, resized);
    const int C = img.channels;
    for (int y = 0; y < resize_h; ++y)
      for (int x = 0; x < crop_w; ++x)
        for (int c = 0; c < 3; ++c) {
          float v = resized[((size_t)y * resize_w + (crop_x0 + x)) * C + (C == 3 ? c : 0)];
          dst[((size_t)y * crop_w + x) * 3 + c] =
              (uint8_t)std::min(std::max(v + 0.5f, 0.f), 255.f);
        }
    ok_count.fetch_add(1);
  });
  return ok_count.load();
}

// Decode one image at native size into a caller-provided uint16 buffer of
// capacity cap (elements). Returns channels, or -1 on failure/overflow; fills
// width/height. Exact-pixel parity testing hook.
int tss_decode_raw(const char* path, uint16_t* out, long cap, int* width, int* height) {
  Image img = decode_any(path);
  if (!img.ok) return -1;
  long need = (long)img.width * img.height * img.channels;
  if (need > cap) return -1;
  memcpy(out, img.pixels.data(), sizeof(uint16_t) * need);
  *width = img.width;
  *height = img.height;
  return img.channels;
}

// uint8 batch [n, h, w, c] -> per-image optional PIL-BICUBIC-equivalent
// resize to (out_w, out_h), then JPEG (.jpg/.jpeg; libjpeg, `quality`) or PNG
// encode by path suffix. The translator's output stage (translator.py:66-76:
// PIL resize + save per image) as ONE ctypes call over a thread pool.
// out_w/out_h == 0 skips the resize. Returns the number written.
int tss_encode_batch(const char** paths, const uint8_t* imgs, int n, int h,
                     int w, int c, int out_w, int out_h, int quality,
                     int n_threads) {
  std::atomic<int> ok_count(0);
  parallel_for(n, n_threads, [&](int i) {
    const uint8_t* src = imgs + (size_t)i * h * w * c;
    std::vector<uint8_t> resized;
    int ww = w, hh = h;
    if (out_w > 0 && out_h > 0 && (out_w != w || out_h != h)) {
      resize_bicubic_u8(src, h, w, c, out_w, out_h, resized);
      src = resized.data();
      ww = out_w;
      hh = out_h;
    }
    std::string p(paths[i]);
    bool ok = (has_suffix(p, ".jpg") || has_suffix(p, ".jpeg"))
                  ? encode_jpeg(paths[i], src, ww, hh, c, quality)
                  : encode_png(paths[i], src, ww, hh, c);
    if (ok) ok_count.fetch_add(1);
  });
  return ok_count.load();
}

// uint8 index batch [n, h, w] -> P-mode PNGs with the given RGB palette
// (n_colors x 3). The colored pseudo-label dump (generate_pseudo_label.py:90
// via freiburg_prediction_visualize) without a PIL round-trip per image.
int tss_encode_pal8_batch(const char** paths, const uint8_t* imgs, int n,
                          int h, int w, const uint8_t* palette_rgb,
                          int n_colors, int n_threads) {
  std::atomic<int> ok_count(0);
  parallel_for(n, n_threads, [&](int i) {
    if (encode_png_pal8(paths[i], imgs + (size_t)i * h * w, w, h, palette_rgb,
                        n_colors))
      ok_count.fetch_add(1);
  });
  return ok_count.load();
}

}  // extern "C"
