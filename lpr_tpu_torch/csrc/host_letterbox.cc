// Host-side letterbox of the port's packed detector input and the PIL
// bilinear resample of its bytes ingestion.  Plain C++17 with threads, no
// library beyond the standard one, a plain `extern "C"` interface loaded
// with ctypes (lpr_tpu_torch/native.py); built with g++ by
// lpr_tpu_torch/kernels/_build.py.  Host code, not a port of a TPU kernel.
//
//   lpr_letterbox_batch(frames, n, h, w, out, oh, ow, nh, nw, top, left,
//                       fill, n_threads)
//     n uint8 frames (h, w, 3), frames[i] pointing at the i-th, -> out
//     (n, oh, ow, 3): each frame resized to (nh, nw) with letterbox_into's
//     bilinear taps (host_letterbox.h) and placed at (top, left), the rest
//     `fill`.  With (nh, nw, top, left) = (h, w, 0, 0) and (oh, ow) = (h,
//     w) it is a threaded gather of the frames into one batch: how the
//     frozen step fills its pinned staging buffer.  The caller gives the
//     geometry (lpr_tpu_torch/ops/image.py letterbox_geom, which rounds
//     half to even where letterbox_into rounds int(x + 0.5)), so the bytes
//     land where the device step's gain and pad say.  `out` is K1's NHWC
//     uint8 input, usually the pinned staging buffer of the frozen step.
//     The n * oh output rows are split into contiguous runs, one a thread;
//     every output byte is written once.
//
//   lpr_resize_pil_bilinear(src, h, w, dst, oh, ow)
//     Pillow's Image.resize(..., BILINEAR) of an RGB image (Pillow's
//     libImaging/Resample.c): a triangle filter whose support widens by
//     the reduction factor, coefficients normalised in double and rounded
//     to 22-bit fixed point, a horizontal then a vertical pass, each
//     rounded and clipped to 8 bits.  Returns 0, or -1 on a bad size.
//
//   lpr_resize_pil_bicubic(src, h, w, dst, oh, ow)
//     Image.resize(..., BICUBIC), Pillow's default resample: the same two
//     passes with the cubic convolution filter (a = -0.5, support 2).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "host_letterbox.h"

namespace {

using host_letterbox::Taps;

int thread_count(int n_threads, long units) {
  if (n_threads <= 0) n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > units) n_threads = static_cast<int>(units > 0 ? units : 1);
  return n_threads;
}

// ---- Pillow's bilinear resample (libImaging/Resample.c, 8 bits a band) ----

constexpr int kPrecisionBits = 32 - 8 - 2;

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;  // (xmin, count) per output sample
  std::vector<int> kk;      // ksize fixed-point coefficients per sample
};

struct Filter {
  double (*fn)(double);
  double support;
};

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double bicubic_filter(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

constexpr Filter kBilinear{bilinear_filter, 1.0};
constexpr Filter kBicubic{bicubic_filter, 2.0};

// precompute_coeffs + normalize_coeffs_8bpc for the box (0, in_size).
Coeffs precompute(int in_size, int out_size, const Filter& f) {
  Coeffs c;
  double filterscale = static_cast<double>(static_cast<float>(in_size)) / out_size;
  double scale = filterscale;
  if (filterscale < 1.0) filterscale = 1.0;
  double support = f.support * filterscale;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.resize(static_cast<size_t>(out_size) * 2);
  std::vector<double> kk(static_cast<size_t>(out_size) * c.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &kk[static_cast<size_t>(xx) * c.ksize];
    for (int x = 0; x < xmax; ++x) {
      double w = f.fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    c.bounds[xx * 2] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  c.kk.resize(kk.size());
  for (size_t i = 0; i < kk.size(); ++i)
    c.kk[i] = kk[i] < 0 ? static_cast<int>(-0.5 + kk[i] * (1 << kPrecisionBits))
                        : static_cast<int>(0.5 + kk[i] * (1 << kPrecisionBits));
  return c;
}

inline uint8_t clip8(int in) {
  int v = in >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

int resize_pil(const uint8_t* src, int h, int w, uint8_t* dst, int oh, int ow,
               const Filter& f) {
  if (h < 1 || w < 1 || oh < 1 || ow < 1) return -1;
  const bool need_h = ow != w, need_v = oh != h;
  Coeffs ch = precompute(w, ow, f), cv = precompute(h, oh, f);
  // rows of the source that the vertical pass reads
  int y_first = cv.bounds[0];
  int y_last = cv.bounds[(oh - 1) * 2] + cv.bounds[(oh - 1) * 2 + 1];
  std::vector<uint8_t> tmp;
  const uint8_t* in = src;
  int in_w = w;
  if (need_h) {
    for (int i = 0; i < oh; ++i) cv.bounds[i * 2] -= y_first;
    int rows = y_last - y_first;
    uint8_t* hout = need_v ? (tmp.resize(static_cast<size_t>(rows) * ow * 3),
                              tmp.data())
                           : dst;
    for (int yy = 0; yy < rows; ++yy) {
      const uint8_t* srow = src + static_cast<size_t>(yy + y_first) * w * 3;
      uint8_t* orow = hout + static_cast<size_t>(yy) * ow * 3;
      for (int xx = 0; xx < ow; ++xx) {
        int xmin = ch.bounds[xx * 2], xmax = ch.bounds[xx * 2 + 1];
        const int* k = &ch.kk[static_cast<size_t>(xx) * ch.ksize];
        int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < xmax; ++x) {
          const uint8_t* p = srow + static_cast<size_t>(x + xmin) * 3;
          s0 += p[0] * k[x];
          s1 += p[1] * k[x];
          s2 += p[2] * k[x];
        }
        orow[xx * 3] = clip8(s0);
        orow[xx * 3 + 1] = clip8(s1);
        orow[xx * 3 + 2] = clip8(s2);
      }
    }
    in = hout;
    in_w = ow;
  }
  if (need_v) {
    for (int yy = 0; yy < oh; ++yy) {
      int ymin = cv.bounds[yy * 2], ymax = cv.bounds[yy * 2 + 1];
      const int* k = &cv.kk[static_cast<size_t>(yy) * cv.ksize];
      uint8_t* orow = dst + static_cast<size_t>(yy) * in_w * 3;
      for (int xx = 0; xx < in_w; ++xx) {
        int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int y = 0; y < ymax; ++y) {
          const uint8_t* p = in + (static_cast<size_t>(y + ymin) * in_w + xx) * 3;
          s0 += p[0] * k[y];
          s1 += p[1] * k[y];
          s2 += p[2] * k[y];
        }
        orow[xx * 3] = clip8(s0);
        orow[xx * 3 + 1] = clip8(s1);
        orow[xx * 3 + 2] = clip8(s2);
      }
    }
  }
  if (!need_h && !need_v)
    memcpy(dst, src, static_cast<size_t>(h) * w * 3);
  return 0;
}

}  // namespace

extern "C" {

void lpr_letterbox_batch(const uint8_t* const* frames, int n, int h, int w,
                         uint8_t* out, int oh, int ow, int nh, int nw,
                         int top, int left, uint8_t fill, int n_threads) {
  const bool pad_only = nh == h && nw == w;
  Taps tx;
  if (!pad_only) tx = host_letterbox::taps(w, nw);
  const long rows = static_cast<long>(n) * oh;
  const size_t row_bytes = static_cast<size_t>(ow) * 3;
  auto run = [&](long r0, long r1) {
    for (long r = r0; r < r1; ++r) {
      int b = static_cast<int>(r / oh), y = static_cast<int>(r % oh);
      uint8_t* drow = out + static_cast<size_t>(r) * row_bytes;
      if (y < top || y >= top + nh) {
        memset(drow, fill, row_bytes);
        continue;
      }
      memset(drow, fill, static_cast<size_t>(left) * 3);
      memset(drow + static_cast<size_t>(left + nw) * 3, fill,
             static_cast<size_t>(ow - left - nw) * 3);
      const uint8_t* src = frames[b];
      uint8_t* dst = drow + static_cast<size_t>(left) * 3;
      if (pad_only)
        memcpy(dst, src + static_cast<size_t>(y - top) * w * 3,
               static_cast<size_t>(w) * 3);
      else
        host_letterbox::resize_row(src, w, h, nh, y - top, tx, dst);
    }
  };
  int t = thread_count(n_threads, rows);
  if (t == 1) {
    run(0, rows);
    return;
  }
  std::vector<std::thread> threads;
  for (int i = 0; i < t; ++i)
    threads.emplace_back(run, rows * i / t, rows * (i + 1) / t);
  for (auto& th : threads) th.join();
}

int lpr_resize_pil_bilinear(const uint8_t* src, int h, int w, uint8_t* dst,
                            int oh, int ow) {
  return resize_pil(src, h, w, dst, oh, ow, kBilinear);
}

int lpr_resize_pil_bicubic(const uint8_t* src, int h, int w, uint8_t* dst,
                           int oh, int ow) {
  return resize_pil(src, h, w, dst, oh, ow, kBicubic);
}

}  // extern "C"
