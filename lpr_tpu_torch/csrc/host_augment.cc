// Host-side image operations of the detector's data pipeline: the three
// OpenCV calls of lpr_tpu/data/yolo_data.py (cv2.resize INTER_LINEAR,
// cv2.warpAffine INTER_LINEAR with a constant border, and the HSV gain of
// augment_hsv), rewritten from OpenCV's arithmetic so the card's machine,
// which has no OpenCV, gives the same bytes.  Plain C++17, no library
// beyond the standard one, a plain `extern "C"` interface loaded with
// ctypes (lpr_tpu_torch/native.py), built with g++ -ffp-contract=off by
// lpr_tpu_torch/kernels/_build.py.  Host code, not a port of a TPU kernel.
// Each call works on one image, single-threaded; ctypes releases the
// interpreter lock for its length, so loader threads run in parallel.
// lpr_tpu_torch/data/cv_plain.py holds a plain numpy version of each.
//
//   lpr_cv_resize_linear(src, h, w, cn, dst, oh, ow)
//     cv2.resize(src, (ow, oh), interpolation=INTER_LINEAR) of a uint8
//     (h, w, cn) image: source positions (d + 0.5) * scale - 0.5 in
//     float, 11-bit fixed-point weights (rounded half to even), clamped at
//     the edges; a horizontal pass in int32, then the vertical pass as
//     OpenCV's vector code rounds it, ((S0 >> 4) * b0 >> 16) + ((S1 >> 4)
//     * b1 >> 16) + 2 >> 2, for every column.  An exact 2x reduction is
//     OpenCV's 2x2 area mean, (a + b + c + d + 2) >> 2; equal sizes copy.
//
//   lpr_cv_warp_affine(src, h, w, m, dst, oh, ow, border)
//     cv2.warpAffine(src, m, (ow, oh), borderValue=(border,)*3) of a uint8
//     (h, w, 3) image, m the forward 2x3 matrix (float64, row-major),
//     inverted in float64 as OpenCV inverts it and cast to float32.  Each
//     output pixel (x, y) samples the source at x * m0 + (y * m1 + m2) in
//     float32 (and likewise for y), bilinear in float32 (p00 + fx * (p01 -
//     p00), the two rows, then the same in y), taps outside the image
//     `border`, rounded half to even.
//
//   lpr_cv_hsv_lut(img, n, lut_h, lut_s, lut_v)
//     augment_hsv's cvtColor(RGB2HSV) -> LUT per channel ->
//     cvtColor(HSV2RGB) over n RGB pixels in place: RGB2HSV_b's integer
//     arithmetic (12-bit reciprocal tables, H in [0, 180)), then HSV2RGB in
//     float32 (hscale 6 / 180, S and V over 255) with the result truncated
//     to 8 bits.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kCoefBits = 11;
constexpr int kCoefScale = 1 << kCoefBits;

inline int round_even(double v) { return static_cast<int>(std::nearbyint(v)); }
inline int round_even_f(float v) { return static_cast<int>(std::nearbyint(v)); }

struct Axis {
  std::vector<int> i0, i1;      // the two source indices
  std::vector<int> a0, a1;      // their 11-bit weights
};

// The source taps of one axis as OpenCV's resizeGeneric computes them.
Axis axis_taps(int n_src, int n_dst, bool clamp_weights) {
  Axis t;
  t.i0.resize(n_dst);
  t.i1.resize(n_dst);
  t.a0.resize(n_dst);
  t.a1.resize(n_dst);
  const double inv = static_cast<double>(n_dst) / n_src;
  const double scale = 1.0 / inv;
  for (int d = 0; d < n_dst; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= static_cast<float>(s);
    int s0 = s, s1 = s + 1;
    if (clamp_weights) {          // horizontal: the weight moves to the edge
      if (s < 0) { f = 0.f; s0 = 0; }
      if (s >= n_src - 1) { f = 0.f; s0 = n_src - 1; }
      s1 = s0 + 1 < n_src ? s0 + 1 : n_src - 1;
    } else {                      // vertical: the rows are clamped
      s0 = s0 < 0 ? 0 : (s0 > n_src - 1 ? n_src - 1 : s0);
      s1 = s1 < 0 ? 0 : (s1 > n_src - 1 ? n_src - 1 : s1);
    }
    t.i0[d] = s0;
    t.i1[d] = s1;
    t.a0[d] = round_even_f((1.f - f) * static_cast<float>(kCoefScale));
    t.a1[d] = round_even_f(f * static_cast<float>(kCoefScale));
  }
  return t;
}

// RGB2HSV_b's 12-bit reciprocal tables (hue range 180).
struct HsvTables {
  int sdiv[256], hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = round_even((255 << 12) / (1.0 * i));
      hdiv[i] = round_even((180 << 12) / (6.0 * i));
    }
  }
};

}  // namespace

extern "C" {

int lpr_cv_resize_linear(const uint8_t* src, int h, int w, int cn,
                         uint8_t* dst, int oh, int ow) {
  if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || cn <= 0) return -1;
  if (oh == h && ow == w) {
    std::memcpy(dst, src, static_cast<size_t>(h) * w * cn);
    return 0;
  }
  const double sx = 1.0 / (static_cast<double>(ow) / w);
  const double sy = 1.0 / (static_cast<double>(oh) / h);
  if (std::fabs(sx - 2.0) < 2.220446049250313e-16 &&
      std::fabs(sy - 2.0) < 2.220446049250313e-16) {
    // OpenCV turns an exact 2x INTER_LINEAR reduction into the area mean
    for (int y = 0; y < oh; ++y) {
      const uint8_t* r0 = src + static_cast<size_t>(2 * y) * w * cn;
      const uint8_t* r1 = r0 + static_cast<size_t>(w) * cn;
      uint8_t* d = dst + static_cast<size_t>(y) * ow * cn;
      for (int x = 0; x < ow; ++x)
        for (int c = 0; c < cn; ++c) {
          const int a = (2 * x) * cn + c, b = a + cn;
          d[x * cn + c] = static_cast<uint8_t>(
              (r0[a] + r0[b] + r1[a] + r1[b] + 2) >> 2);
        }
    }
    return 0;
  }
  const Axis xt = axis_taps(w, ow, true);
  const Axis yt = axis_taps(h, oh, false);
  const int width = ow * cn;
  std::vector<int32_t> rows(static_cast<size_t>(h) * width);
  std::vector<char> done(h, 0);
  auto hrow = [&](int r) -> const int32_t* {
    int32_t* out = rows.data() + static_cast<size_t>(r) * width;
    if (!done[r]) {
      const uint8_t* s = src + static_cast<size_t>(r) * w * cn;
      for (int x = 0; x < ow; ++x) {
        const uint8_t* p0 = s + xt.i0[x] * cn;
        const uint8_t* p1 = s + xt.i1[x] * cn;
        for (int c = 0; c < cn; ++c)
          out[x * cn + c] = p0[c] * xt.a0[x] + p1[c] * xt.a1[x];
      }
      done[r] = 1;
    }
    return out;
  };
  for (int y = 0; y < oh; ++y) {
    const int32_t* s0 = hrow(yt.i0[y]);
    const int32_t* s1 = hrow(yt.i1[y]);
    const int32_t b0 = yt.a0[y], b1 = yt.a1[y];
    uint8_t* d = dst + static_cast<size_t>(y) * width;
    for (int x = 0; x < width; ++x) {
      int v = (((s0[x] >> 4) * b0) >> 16) + (((s1[x] >> 4) * b1) >> 16);
      v = (v + 2) >> 2;
      d[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
  return 0;
}

int lpr_cv_warp_affine(const uint8_t* src, int h, int w, const double* m,
                       uint8_t* dst, int oh, int ow, int border) {
  if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0) return -1;
  double M[6] = {m[0], m[1], m[2], m[3], m[4], m[5]};
  double D = M[0] * M[4] - M[1] * M[3];
  D = D != 0 ? 1.0 / D : 0;
  const double a11 = M[4] * D, a22 = M[0] * D;
  M[0] = a11;
  M[1] *= -D;
  M[3] *= -D;
  M[4] = a22;
  const double b1 = -M[0] * M[2] - M[1] * M[5];
  const double b2 = -M[3] * M[2] - M[4] * M[5];
  M[2] = b1;
  M[5] = b2;
  float F[6];
  for (int i = 0; i < 6; ++i) F[i] = static_cast<float>(M[i]);
  const float bv = static_cast<float>(border);
  auto tap = [&](int yy, int xx, int c) -> float {
    if (yy < 0 || yy >= h || xx < 0 || xx >= w) return bv;
    return static_cast<float>(src[(static_cast<size_t>(yy) * w + xx) * 3 + c]);
  };
  for (int y = 0; y < oh; ++y) {
    const float fy_ = static_cast<float>(y);
    const float rx = fy_ * F[1] + F[2];
    const float ry = fy_ * F[4] + F[5];
    uint8_t* d = dst + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      const float fx_ = static_cast<float>(x);
      float sx = fx_ * F[0] + rx;
      float sy = fx_ * F[3] + ry;
      const float flx = std::floor(sx), fly = std::floor(sy);
      // far outside the image every tap is the border: clamp before the
      // conversion to int
      const int ix = static_cast<int>(flx < -1e6f ? -1e6f : (flx > 1e6f ? 1e6f : flx));
      const int iy = static_cast<int>(fly < -1e6f ? -1e6f : (fly > 1e6f ? 1e6f : fly));
      sx -= flx;
      sy -= fly;
      for (int c = 0; c < 3; ++c) {
        const float p00 = tap(iy, ix, c), p01 = tap(iy, ix + 1, c);
        const float p10 = tap(iy + 1, ix, c), p11 = tap(iy + 1, ix + 1, c);
        const float v0 = p00 + sx * (p01 - p00);
        const float v1 = p10 + sx * (p11 - p10);
        const float v = v0 + sy * (v1 - v0);
        const int r = round_even_f(v);
        d[x * 3 + c] = static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
      }
    }
  }
  return 0;
}

void lpr_cv_hsv_lut(uint8_t* img, long n, const uint8_t* lut_h,
                    const uint8_t* lut_s, const uint8_t* lut_v) {
  static const HsvTables t;   // built once, thread-safe
  const int* sdiv = t.sdiv;
  const int* hdiv = t.hdiv;
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = 6.0f / 180.0f;
  for (long i = 0; i < n; ++i) {
    uint8_t* p = img + i * 3;
    const int r = p[0], g = p[1], b = p[2];
    int v = b > g ? b : g;
    v = v > r ? v : r;
    int vmin = b < g ? b : g;
    vmin = vmin < r ? vmin : r;
    const int diff = v - vmin;
    int h;
    if (v == r) h = g - b;
    else if (v == g) h = b - r + 2 * diff;
    else h = r - g + 4 * diff;
    const int s = (diff * sdiv[v] + (1 << 11)) >> 12;
    h = (h * hdiv[diff] + (1 << 11)) >> 12;
    if (h < 0) h += 180;
    const int hh = lut_h[h > 255 ? 255 : h], ss = lut_s[s], vv = lut_v[v];
    // HSV2RGB in float32, truncated to 8 bits
    const float fv = static_cast<float>(vv) * (1.0f / 255.0f);
    const float fs = static_cast<float>(ss) * (1.0f / 255.0f);
    float out[3];
    if (ss == 0) {
      out[0] = out[1] = out[2] = fv;
    } else {
      float fh = static_cast<float>(hh) * hscale;
      fh = std::fmod(fh, 6.0f);
      int sector = static_cast<int>(std::floor(fh));
      fh -= static_cast<float>(sector);
      if (static_cast<unsigned>(sector) >= 6u) {
        sector = 0;
        fh = 0.f;
      }
      float tab[4];
      tab[0] = fv;
      tab[1] = fv * (1.f - fs);
      tab[2] = fv * (1.f - fs * fh);
      tab[3] = fv * (1.f - fs * (1.f - fh));
      out[2] = tab[sector_data[sector][0]];   // b
      out[1] = tab[sector_data[sector][1]];   // g
      out[0] = tab[sector_data[sector][2]];   // r
    }
    for (int c = 0; c < 3; ++c) {
      const float x = out[c] * 255.0f;
      int q = static_cast<int>(x);
      p[c] = static_cast<uint8_t>(q < 0 ? 0 : (q > 255 ? 255 : q));
    }
  }
}

}  // extern "C"
