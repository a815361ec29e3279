// Native image-loading pipeline: JPEG decode + Pillow-compatible
// antialiased bilinear resize + normalization, with a thread pool.
//
// Why: PIL decode + resize + normalize is slow per image next to the
// device forward, so host decode can bound serving (the reference hid it
// behind torch DataLoader worker processes, params.yaml:19). This library
// does the same per-sample work in C++ and scales across a thread pool,
// feeding data.BatchLoader through ctypes.
//
// Parity: the resize replicates Pillow's ImagingResample for the
// BILINEAR (triangle) filter bit-for-bit -- same per-pixel coefficient
// windows, the same fixed-point accumulation (PRECISION_BITS = 22,
// round-half-away coefficients, u8 intermediate between the horizontal
// and vertical passes) -- so native and PIL pipelines produce identical
// tensors for JPEG sources decoded by the same libjpeg-turbo family.
//
// Build: g++ -O3 -shared -fPIC image_loader.cc -o _image_loader.so -ljpeg
// (done lazily by native/__init__.py, into the package's _build/).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <new>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's PRECISION_BITS

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to RGB8. Returns true on success; sets (w, h) and
// fills `out` (resized to w*h*3).
bool DecodeJpeg(const char* path, std::vector<unsigned char>* out, int* w,
                int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  // Bound the allocation: a corrupt SOF can claim absurd dims, and a
  // bad_alloc would escape the thread and kill the process instead of
  // taking the status->PIL-fallback path.
  if (*w <= 0 || *h <= 0 ||
      static_cast<long long>(*w) * *h > 64LL * 1024 * 1024) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  try {
    out->resize(static_cast<size_t>(*w) * *h * 3);
  } catch (const std::bad_alloc&) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

inline int RoundHalfAway(double v) {
  return v < 0 ? static_cast<int>(v - 0.5) : static_cast<int>(v + 0.5);
}

inline unsigned char Clip8(int v) {
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<unsigned char>(v);
}

// Pillow-style coefficient precompute for the triangle filter
// (ImagingPrecomputeCoeffs with bilinear_filter, support 1.0).
void PrecomputeCoeffs(int in_size, int out_size, std::vector<int>* bounds,
                      std::vector<int>* kk, int* ksize_out) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds->resize(static_cast<size_t>(out_size) * 2);
  kk->assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      double w = (x + xmin - center + 0.5) * ss;
      w = w < 0 ? 1.0 + w : 1.0 - w;  // triangle filter on |w| < 1
      if (w < 0) w = 0;
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
      (*kk)[static_cast<size_t>(xx) * ksize + x] =
          RoundHalfAway(k[x] * (1 << kPrecisionBits));
    }
    (*bounds)[xx * 2] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  *ksize_out = ksize;
}

// Two-pass u8 resample, horizontal then vertical (Pillow's order for
// plain resize), RGB interleaved.
void ResizeBilinear(const unsigned char* src, int in_w, int in_h,
                    unsigned char* dst, int out_w, int out_h) {
  std::vector<int> bounds, kk;
  int ksize;
  // Horizontal pass: (in_h, in_w) -> (in_h, out_w).
  std::vector<unsigned char> tmp(static_cast<size_t>(in_h) * out_w * 3);
  PrecomputeCoeffs(in_w, out_w, &bounds, &kk, &ksize);
  for (int yy = 0; yy < in_h; ++yy) {
    const unsigned char* srow = src + static_cast<size_t>(yy) * in_w * 3;
    unsigned char* drow = tmp.data() + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      int xmin = bounds[xx * 2], xmax = bounds[xx * 2 + 1];
      const int* kp = kk.data() + static_cast<size_t>(xx) * ksize;
      int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
      for (int x = 0; x < xmax; ++x) {
        const unsigned char* p = srow + static_cast<size_t>(xmin + x) * 3;
        s0 += p[0] * kp[x];
        s1 += p[1] * kp[x];
        s2 += p[2] * kp[x];
      }
      drow[xx * 3] = Clip8(s0);
      drow[xx * 3 + 1] = Clip8(s1);
      drow[xx * 3 + 2] = Clip8(s2);
    }
  }
  // Vertical pass: (in_h, out_w) -> (out_h, out_w).
  PrecomputeCoeffs(in_h, out_h, &bounds, &kk, &ksize);
  for (int yy = 0; yy < out_h; ++yy) {
    int ymin = bounds[yy * 2], ymax = bounds[yy * 2 + 1];
    const int* kp = kk.data() + static_cast<size_t>(yy) * ksize;
    unsigned char* drow = dst + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w * 3; ++xx) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y) {
        ss += tmp[static_cast<size_t>(ymin + y) * out_w * 3 + xx] * kp[y];
      }
      drow[xx] = Clip8(ss);
    }
  }
}

// ---------------------------------------------------------------------
// Pillow-parity color jitter (training augmentation).
//
// Replicates torchvision-0.6-era ColorJitter, which is PIL ImageEnhance
// {Brightness, Contrast, Color} + an HSV-roundtrip hue shift, BIT-EXACT.
// Semantics were reverse-engineered against Pillow empirically
// (exhaustive over all 2^24 RGB / HSV values for the conversions, all
// (im1, im2, alpha) blend grids -- see tests/test_native_loader.py):
//  - Image.blend computes in C float: t = in1 + alpha*(in2-in1), clips,
//    TRUNCATES to u8; alpha itself is rounded to float.
//  - L conversion is the fixed-point (r*19595 + g*38470 + b*7471 +
//    0x8000) >> 16.
//  - Contrast blends toward solid gray int(mean(L) + 0.5); Color blends
//    toward the per-pixel L; Brightness toward black.
//  - RGB<->HSV store intermediates as C float but evaluate expressions
//    in double (C promotion), truncating at the final *255.0 cast
//    (rgb2hsv) and truncating x+0.5 (hsv2rgb).

inline unsigned char LumaU8(int r, int g, int b) {
  return static_cast<unsigned char>(
      (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
}

inline unsigned char BlendU8(float alpha, int deg, int px) {
  float t = deg + alpha * (px - deg);
  if (t <= 0.0f) return 0;
  if (t >= 255.0f) return 255;
  return static_cast<unsigned char>(t);
}

// The blend ops are pure functions of (alpha, deg, px) with u8 deg/px,
// so each pass tabulates BlendU8 once (256 or 256x256 entries) and
// applies by lookup -- bit-identical, ~10x less float work per image.
void EnhanceBrightness(unsigned char* px, size_t count3, float alpha) {
  unsigned char lut[256];
  for (int v = 0; v < 256; ++v) lut[v] = BlendU8(alpha, 0, v);
  for (size_t i = 0; i < count3; ++i) px[i] = lut[px[i]];
}

void EnhanceContrast(unsigned char* px, size_t npix, float alpha) {
  double sum = 0.0;
  for (size_t i = 0; i < npix; ++i) {
    sum += LumaU8(px[i * 3], px[i * 3 + 1], px[i * 3 + 2]);
  }
  int gray = static_cast<int>(sum / npix + 0.5);
  unsigned char lut[256];
  for (int v = 0; v < 256; ++v) lut[v] = BlendU8(alpha, gray, v);
  for (size_t i = 0; i < npix * 3; ++i) px[i] = lut[px[i]];
}

void EnhanceColor(unsigned char* px, size_t npix, float alpha) {
  std::vector<unsigned char> lut(256 * 256);
  for (int L = 0; L < 256; ++L) {
    for (int v = 0; v < 256; ++v) {
      lut[L * 256 + v] = BlendU8(alpha, L, v);
    }
  }
  for (size_t i = 0; i < npix; ++i) {
    const unsigned char* row =
        lut.data() + LumaU8(px[i * 3], px[i * 3 + 1], px[i * 3 + 2]) * 256;
    px[i * 3] = row[px[i * 3]];
    px[i * 3 + 1] = row[px[i * 3 + 1]];
    px[i * 3 + 2] = row[px[i * 3 + 2]];
  }
}

void ShiftHue(unsigned char* px, size_t npix, int shift) {
  // f32((double)a / b) for a in 0..255, b in 1..255 -- the only
  // divisions in the conversion; tabulated once per image (bit-exact:
  // identical computation, precomputed).
  static thread_local std::vector<float> div_lut;
  if (div_lut.empty()) {
    div_lut.resize(256 * 256);
    for (int a = 0; a < 256; ++a) {
      for (int b = 1; b < 256; ++b) {
        div_lut[a * 256 + b] =
            static_cast<float>(static_cast<double>(a) / b);
      }
    }
  }
  for (size_t i = 0; i < npix; ++i) {
    int r = px[i * 3], g = px[i * 3 + 1], b = px[i * 3 + 2];
    int maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
    int minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
    int H = 0, S = 0, V = maxc;
    if (maxc != minc) {
      int cr = maxc - minc;
      float s = div_lut[cr * 256 + maxc];
      float rc = div_lut[(maxc - r) * 256 + cr];
      float gc = div_lut[(maxc - g) * 256 + cr];
      float bc = div_lut[(maxc - b) * 256 + cr];
      float h;
      if (r == maxc) {
        h = static_cast<double>(bc) - gc;
      } else if (g == maxc) {
        h = 2.0 + rc - static_cast<double>(bc);
      } else {
        h = 4.0 + gc - static_cast<double>(rc);
      }
      h = h / 6.0;
      if (h < 0) h = h + 1.0;
      H = static_cast<int>(h * 255.0);
      S = static_cast<int>(s * 255.0);
    }
    H = ((H + shift) % 256 + 256) % 256;
    if (S == 0) {
      px[i * 3] = px[i * 3 + 1] = px[i * 3 + 2] = static_cast<unsigned char>(V);
      continue;
    }
    float hf = static_cast<double>(H) / 255.0 * 6.0;
    int idx = static_cast<int>(hf);
    float fr = static_cast<double>(hf) - idx;
    float sf = static_cast<double>(S) / 255.0;
    float p = V * (1.0 - static_cast<double>(sf));
    float q = V * (1.0 - static_cast<double>(sf) * fr);
    float t = V * (1.0 - static_cast<double>(sf) * (1.0 - fr));
    unsigned char P = static_cast<unsigned char>(p + 0.5);
    unsigned char Q = static_cast<unsigned char>(q + 0.5);
    unsigned char T = static_cast<unsigned char>(t + 0.5);
    unsigned char Vc = static_cast<unsigned char>(V);
    unsigned char ro, go, bo;
    switch (idx % 6) {
      case 0: ro = Vc; go = T; bo = P; break;
      case 1: ro = Q; go = Vc; bo = P; break;
      case 2: ro = P; go = Vc; bo = T; break;
      case 3: ro = P; go = Q; bo = Vc; break;
      case 4: ro = T; go = P; bo = Vc; break;
      default: ro = Vc; go = P; bo = Q; break;
    }
    px[i * 3] = ro;
    px[i * 3 + 1] = go;
    px[i * 3 + 2] = bo;
  }
}

void ApplyJitter(unsigned char* px, int rows, int cols, const int* order,
                 int n_ops, float brightness, float contrast,
                 float saturation, int hue_shift) {
  size_t npix = static_cast<size_t>(rows) * cols;
  for (int k = 0; k < n_ops; ++k) {
    switch (order[k]) {
      case 0: EnhanceBrightness(px, npix * 3, brightness); break;
      case 1: EnhanceContrast(px, npix, contrast); break;
      case 2: EnhanceColor(px, npix, saturation); break;
      case 3: ShiftHue(px, npix, hue_shift); break;
      default: break;
    }
  }
}

// Shared per-image front: decode + resize-to-target. On success *px
// points at (rows, cols, 3) u8 pixels inside rgb or resized.
bool DecodeAndResize(const char* path, int rows, int cols,
                     std::vector<unsigned char>* rgb,
                     std::vector<unsigned char>* resized,
                     unsigned char** px) {
  int w = 0, h = 0;
  if (!DecodeJpeg(path, rgb, &w, &h)) return false;
  *px = rgb->data();
  if (w != cols || h != rows) {
    resized->resize(static_cast<size_t>(rows) * cols * 3);
    ResizeBilinear(rgb->data(), w, h, resized->data(), cols, rows);
    *px = resized->data();
  }
  return true;
}

// Shared thread pool: work(i, rgb_scratch, resized_scratch) per image.
template <typename Fn>
void RunPool(int n, int n_threads, Fn work_item) {
  std::atomic<int> next(0);
  auto work = [&]() {
    std::vector<unsigned char> rgb, resized;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      work_item(i, &rgb, &resized);
    }
  };
  int nt = n_threads < 1 ? 1 : (n_threads > n ? n : n_threads);
  if (nt == 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(work);
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Probe symbol for the ctypes wrapper.
int mvs_native_version() { return 4; }

// JPEG header dims without a full decode. Returns 0 on success.
int mvs_jpeg_dims(const char* path, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

// Decode n JPEGs, resize each to (rows, cols) with the Pillow-parity
// bilinear resample, and write float32 HWC pixels (x/255 - mean) / std
// into out[i * rows * cols * 3]. status[i]: 0 ok, 1 decode failed.
// Thread-pooled over images.
void mvs_load_images(const char** paths, int n, int rows, int cols,
                     float mean, float stddev, float* out, int* status,
                     int n_threads) {
  const float inv = 1.0f / (255.0f * stddev);
  const float off = mean / stddev;
  const bool plain = (mean == 0.0f && stddev == 1.0f);
  RunPool(n, n_threads, [&](int i, std::vector<unsigned char>* rgb,
                            std::vector<unsigned char>* resized) {
    unsigned char* px;
    if (!DecodeAndResize(paths[i], rows, cols, rgb, resized, &px)) {
      status[i] = 1;
      return;
    }
    float* dst = out + static_cast<size_t>(i) * rows * cols * 3;
    size_t count = static_cast<size_t>(rows) * cols * 3;
    if (plain) {
      // Exact x / 255.0f division: bit-identical to the numpy ToArray
      // path (multiply-by-reciprocal is 1 ulp off).
      for (size_t j = 0; j < count; ++j) {
        dst[j] = px[j] / 255.0f;
      }
    } else {
      for (size_t j = 0; j < count; ++j) {
        dst[j] = px[j] * inv - off;
      }
    }
    status[i] = 0;
  });
}

// Decode + Pillow-parity resize, EMITTING RAW uint8 HWC pixels (no
// float conversion). The serving transport path (eval/streaming
// --transfer_u8) ships these 1-byte pixels host->device and replicates
// ToArray+Normalize on-device (dequantize_images_u8, bit-exact) -- 4x
// fewer transfer bytes and zero host-side float work. The resample
// operates in the u8 domain anyway (PIL semantics), so this is the
// pipeline's natural intermediate, not a quantization.
void mvs_load_images_u8(const char** paths, int n, int rows, int cols,
                        unsigned char* out, int* status, int n_threads) {
  RunPool(n, n_threads, [&](int i, std::vector<unsigned char>* rgb,
                            std::vector<unsigned char>* resized) {
    unsigned char* px;
    if (!DecodeAndResize(paths[i], rows, cols, rgb, resized, &px)) {
      status[i] = 1;
      return;
    }
    std::memcpy(out + static_cast<size_t>(i) * rows * cols * 3, px,
                static_cast<size_t>(rows) * cols * 3);
    status[i] = 0;
  });
}

// Like mvs_load_images (mean/std fixed to 0/1 -- the reference's
// augmented training pipeline omits normalization), but applies the
// Pillow-parity color jitter between resize and float conversion:
// `order` is n_ops op codes (0 brightness, 1 contrast, 2 saturation,
// 3 hue) applied sequentially with the given factors / hue shift --
// ONE parameter set for the whole call (all views of a training sample
// share the draw, reference RandomColorJitterStereo).
void mvs_load_images_jitter(const char** paths, int n, int rows, int cols,
                            const int* order, int n_ops, float brightness,
                            float contrast, float saturation, int hue_shift,
                            float* out, int* status, int n_threads) {
  RunPool(n, n_threads, [&](int i, std::vector<unsigned char>* rgb,
                            std::vector<unsigned char>* resized) {
    unsigned char* px;
    if (!DecodeAndResize(paths[i], rows, cols, rgb, resized, &px)) {
      status[i] = 1;
      return;
    }
    ApplyJitter(px, rows, cols, order, n_ops, brightness, contrast,
                saturation, hue_shift);
    float* dst = out + static_cast<size_t>(i) * rows * cols * 3;
    size_t count = static_cast<size_t>(rows) * cols * 3;
    for (size_t j = 0; j < count; ++j) {
      dst[j] = px[j] / 255.0f;
    }
    status[i] = 0;
  });
}

// Jitter variant EMITTING RAW uint8 pixels (the chain is u8 end-to-end
// until the float conversion, so this is its natural intermediate).
// The training u8 transport (train_cli ``transfer_u8``) ships these
// bytes host->device and replicates the augmented pipeline's bare
// x/255 on-device (ops/quantize.dequantize_images_u8_unit, bit-exact)
// -- 4x fewer image transfer bytes per training batch and zero host
// float work, same win mvs_load_images_u8 gives serving.
void mvs_load_images_jitter_u8(const char** paths, int n, int rows,
                               int cols, const int* order, int n_ops,
                               float brightness, float contrast,
                               float saturation, int hue_shift,
                               unsigned char* out, int* status,
                               int n_threads) {
  RunPool(n, n_threads, [&](int i, std::vector<unsigned char>* rgb,
                            std::vector<unsigned char>* resized) {
    unsigned char* px;
    if (!DecodeAndResize(paths[i], rows, cols, rgb, resized, &px)) {
      status[i] = 1;
      return;
    }
    ApplyJitter(px, rows, cols, order, n_ops, brightness, contrast,
                saturation, hue_shift);
    std::memcpy(out + static_cast<size_t>(i) * rows * cols * 3, px,
                static_cast<size_t>(rows) * cols * 3);
    status[i] = 0;
  });
}

}  // extern "C"
